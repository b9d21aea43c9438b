"""Slab index: targets sorted by x, searched one contiguous window per
query block.

Counterpart of ``tpu3d/ops/slab.py`` (``build_slab``, ``_block_slices``,
``slab_top1``) with ``tpu3d/ops/slab2.py`` ``sorted_positions``, whose
exact ``searchsorted`` semantics ``torch.searchsorted`` provides
(``right=False`` for side='left', ``right=True`` for side='right').
``slab_top1`` is XLA in the JAX package (a ``lax.map`` over blocks), so it
is plain PyTorch here, with no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_BIG_X = 3e4  # sort key of invalid rows: after every real x
_BIG = 1e30  # d² of "no match"
_PAD_Q = 2.9e4  # padding queries: past every target, match nothing
# Distance values per chunk of blocks in slab_top1 (128 MB of fp32).
_TOP1_CHUNK_ELEMS = 1 << 25


class SlabIndex(NamedTuple):
    sorted_points_t: torch.Tensor  # f32[3, M] sorted by x (invalid last)
    sorted_orig: torch.Tensor  # i64[M] original row of each sorted row
    sorted_x: torch.Tensor  # f32[M] ascending (invalid = 3e4)
    valid_sorted: torch.Tensor  # bool[M]


def build_slab(points: torch.Tensor, mask: torch.Tensor) -> SlabIndex:
    """Stable sort of the rows by x (invalid rows keyed at 3e4), with the
    coordinates, validity and original row gathered in sorted order."""
    pts = points.to(torch.float32)
    x = torch.where(mask, pts[:, 0], _BIG_X)
    _, order = torch.sort(x, stable=True)
    sorted_points = pts[order]
    valid = mask[order]
    return SlabIndex(
        sorted_points_t=sorted_points.T.contiguous(),
        sorted_orig=order,
        sorted_x=torch.where(valid, sorted_points[:, 0], _BIG_X),
        valid_sorted=valid,
    )


def block_slices(slab: SlabIndex, qx_blocks: torch.Tensor, radius: float):
    """(n_blocks,) window starts and lengths covering x in
    [block min − r, block max + r]; the right edge is inclusive, matching
    the inclusive d² ≤ r² gates downstream."""
    r = float(np.float32(radius))  # fp32 arithmetic on the device
    lo = torch.searchsorted(slab.sorted_x, qx_blocks.amin(1) - r)
    hi = torch.searchsorted(slab.sorted_x, qx_blocks.amax(1) + r, right=True)
    return lo.to(torch.int32), (hi - lo).to(torch.int32)


def slab_top1(slab: SlabIndex, queries: torch.Tensor, radius,
              slice_cap: int = 4096, block: int = 256):
    """Nearest target within ``radius`` per query: (idx i64[Q] original
    target rows, d2 f32[Q], ≥ 1e30 where no target lies within radius,
    overflow bool[]: some block's window exceeded ``slice_cap`` and its
    result may be approximate).

    Each block of ``block`` queries scans ``slice_cap`` sorted rows from
    its window start, clamped so that the slice stays inside the array;
    a row counts when it is valid and lies before the window's end (rows
    before the start of a clamped window are a harmless superset). The
    first least d² wins. Blocks run in chunks whose (block, slice_cap)
    distance tiles hold about 128 MB."""
    q = queries.shape[0]
    dev = queries.device
    pad = (-q) % block
    qp = torch.cat([queries.to(torch.float32),
                    torch.full((pad, 3), _PAD_Q, dtype=torch.float32,
                               device=dev)])
    nb = qp.shape[0] // block
    qb = qp.reshape(nb, block, 3)
    lo, length = block_slices(slab, qb[..., 0], radius)
    overflow = (length > slice_cap).any()
    m = slab.sorted_points_t.shape[1]
    cap = min(slice_cap, m)
    r = np.float32(radius)
    r2 = float(r * r)
    start = lo.long().clamp(0, max(m - cap, 0))
    end = lo.long() + length.long()
    cols = torch.arange(cap, device=dev)
    idx = torch.empty((nb, block), dtype=torch.int64, device=dev)
    d2 = torch.empty((nb, block), dtype=torch.float32, device=dev)
    group = max(1, _TOP1_CHUNK_ELEMS // (block * cap))
    for g0 in range(0, nb, group):
        g1 = min(nb, g0 + group)
        rows = start[g0:g1, None] + cols[None, :]  # (G, cap)
        valid = slab.valid_sorted[rows] & (rows < end[g0:g1, None])
        cand = slab.sorted_points_t[:, rows]  # (3, G, cap)
        qc = qb[g0:g1]
        dx = qc[:, :, 0, None] - cand[0, :, None, :]
        dy = qc[:, :, 1, None] - cand[1, :, None, :]
        dz = qc[:, :, 2, None] - cand[2, :, None, :]
        dist = dx * dx + dy * dy + dz * dz  # (G, block, cap)
        dist = torch.where(valid[:, None, :], dist, _BIG)
        bd, best = dist.min(2)  # the first least d²
        d2[g0:g1] = torch.where(bd <= r2, bd, _BIG)
        idx[g0:g1] = slab.sorted_orig[rows.gather(1, best)]
    return idx.reshape(-1)[:q], d2.reshape(-1)[:q], overflow
