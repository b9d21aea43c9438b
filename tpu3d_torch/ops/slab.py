"""Slab index: targets sorted by x, searched one contiguous window per
query block.

Counterpart of ``tpu3d/ops/slab.py`` (``build_slab``, ``_block_slices``,
``slab_top1``, ``slab_knn``) with ``tpu3d/ops/slab2.py``
``sorted_positions``, whose exact ``searchsorted`` semantics
``torch.searchsorted`` provides (``right=False`` for side='left',
``right=True`` for side='right'). ``slab_top1`` and ``slab_knn`` are XLA in
the JAX package (a ``lax.map`` over blocks), so they are plain PyTorch
here, with no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu3d_torch.ops.neighbors import check_method, smallest_k

_BIG_X = 3e4  # sort key of invalid rows: after every real x
_BIG = 1e30  # d² of "no match"
_PAD_Q = 2.9e4  # padding queries: past every target, match nothing
# Distance values per chunk of blocks in slab_top1 and slab_knn (128 MB of
# fp32; one block of 256 queries x 8,192 rows is 8 MB).
_CHUNK_ELEMS = 1 << 25


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
    """(n_blocks,) i32 window starts and lengths covering x in
    [block min − r, block max + r]; the right edge is inclusive, matching
    the inclusive d² ≤ r² gates downstream."""
    r = float(np.float32(radius))  # fp32 arithmetic on the device
    lo = torch.searchsorted(slab.sorted_x, qx_blocks.amin(1) - r,
                            out_int32=True)
    hi = torch.searchsorted(slab.sorted_x, qx_blocks.amax(1) + r, right=True,
                            out_int32=True)
    return lo, hi - lo


def _blocks(slab: SlabIndex, queries: torch.Tensor, radius, slice_cap: int,
            block: int):
    """Queries padded to whole blocks (pad rows at 2.9e4 match nothing),
    as (nb, block, 3); each block's slice start (its window start, clamped
    so that ``cap`` rows fit in the array) and window end; ``cap``; and
    whether some window is longer than ``slice_cap``."""
    dev = queries.device
    pad = (-queries.shape[0]) % block
    qp = torch.cat([queries.to(torch.float32),
                    torch.full((pad, 3), _PAD_Q, dtype=torch.float32,
                               device=dev)])
    qb = qp.reshape(-1, block, 3)
    lo, length = block_slices(slab, qb[..., 0], radius)
    overflow = (length > slice_cap).any()
    m = slab.sorted_points_t.shape[1]
    cap = min(slice_cap, m)  # never wider than the target array
    start = lo.long().clamp(0, max(m - cap, 0))
    end = lo.long() + length.long()
    return qb, start, end, cap, overflow


def _block_d2(slab: SlabIndex, qc: torch.Tensor, start: torch.Tensor,
              end: torch.Tensor, cap: int):
    """(G, block, cap) d² of a group of query blocks against their slices,
    1e30 where a row is invalid or past the window's end (rows before the
    start of a clamped window are a harmless superset); and the slices'
    sorted rows (G, cap)."""
    rows = start[:, None] + torch.arange(cap, device=qc.device)[None, :]
    valid = slab.valid_sorted[rows] & (rows < end[:, None])
    cand = slab.sorted_points_t[:, rows]  # (3, G, cap)
    dx = qc[:, :, 0, None] - cand[0, :, None, :]
    dy = qc[:, :, 1, None] - cand[1, :, None, :]
    dz = qc[:, :, 2, None] - cand[2, :, None, :]
    dist = dx * dx + dy * dy + dz * dz
    return torch.where(valid[:, None, :], dist, _BIG), rows


def slab_top1(slab: SlabIndex, queries: torch.Tensor, radius,
              slice_cap: int = 4096, block: int = 256):
    """Nearest target within ``radius`` per query: (idx i64[Q] original
    target rows, d2 f32[Q], ≥ 1e30 where no target lies within radius,
    overflow bool[]: some block's window exceeded ``slice_cap`` and its
    result may be approximate).

    Each block of ``block`` queries scans ``slice_cap`` sorted rows from
    its window start, clamped so that the slice stays inside the array;
    a row counts when it is valid and lies before the window's end. The
    first least d² wins. Blocks run in chunks whose (block, slice_cap)
    distance tiles hold about 128 MB."""
    q = queries.shape[0]
    qb, start, end, cap, overflow = _blocks(slab, queries, radius,
                                            slice_cap, block)
    nb = qb.shape[0]
    r = np.float32(radius)
    r2 = float(r * r)
    idx = torch.empty((nb, block), dtype=torch.int64, device=qb.device)
    d2 = torch.empty((nb, block), dtype=torch.float32, device=qb.device)
    group = max(1, _CHUNK_ELEMS // (block * cap))
    for g0 in range(0, nb, group):
        g1 = min(nb, g0 + group)
        dist, rows = _block_d2(slab, qb[g0:g1], start[g0:g1], end[g0:g1],
                               cap)
        bd, best = dist.min(2)  # the first least d²
        d2[g0:g1] = torch.where(bd <= r2, bd, _BIG)
        idx[g0:g1] = slab.sorted_orig[rows.gather(1, best)]
    return idx.reshape(-1)[:q], d2.reshape(-1)[:q], overflow


def slab_knn(slab: SlabIndex, queries: torch.Tensor, radius, k: int,
             slice_cap: int = 8192, block: int = 256, method: str = "auto"):
    """The k nearest targets within ``radius`` per query, ascending:
    (idx i32[Q, k] original target rows, d2 f32[Q, k], overflowed bool[]).
    Slots past the in-radius neighbours hold d² = 1e30 (their index is the
    candidate the selection reached there, as in the JAX package); with
    ``k`` above ``slice_cap`` the extra slots are index 0 at 1e30.

    The slices are those of :func:`slab_top1`. Ties resolve to the lower
    slice position, as ``lax.top_k`` orders them (:func:`smallest_k`).
    ``method``: as in :func:`~tpu3d_torch.ops.neighbors.knn`, every
    accepted value is this exact selection."""
    check_method(method)
    q = queries.shape[0]
    qb, start, end, cap, overflow = _blocks(slab, queries, radius,
                                            slice_cap, block)
    nb = qb.shape[0]
    k_eff = min(k, cap)
    r = np.float32(radius)
    r2 = float(r * r)
    idx = torch.empty((nb, block, k_eff), dtype=torch.int32,
                      device=qb.device)
    d2 = torch.empty((nb, block, k_eff), dtype=torch.float32,
                     device=qb.device)
    group = max(1, _CHUNK_ELEMS // (block * cap))
    for g0 in range(0, nb, group):
        g1 = min(nb, g0 + group)
        dist, rows = _block_d2(slab, qb[g0:g1], start[g0:g1], end[g0:g1],
                               cap)
        dk, pos = smallest_k(dist, k_eff)  # (G, block, k_eff)
        d2[g0:g1] = torch.where(dk <= r2, dk, _BIG)
        g = g1 - g0
        srow = rows.gather(1, pos.reshape(g, -1)).reshape(pos.shape)
        idx[g0:g1] = slab.sorted_orig[srow].to(torch.int32)
    idx = idx.reshape(-1, k_eff)[:q]
    d2 = d2.reshape(-1, k_eff)[:q]
    if k_eff < k:
        idx = torch.nn.functional.pad(idx, (0, k - k_eff))
        d2 = torch.nn.functional.pad(d2, (0, k - k_eff), value=_BIG)
    return idx, d2, overflow
