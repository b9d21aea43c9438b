"""Exact thresholded top-1 NN at scale: slab2 windows + the K8 walk.

Counterpart of ``tpu3d/ops/nn_walk.py`` (``WalkTarget``,
``build_walk_target``, ``_windows_index``, ``slab2_top1_indexed``,
``slab2_top1``). The target is keyed and sorted once into the plain slab2
layout (``ops/slab2.build_slab2``, bucket width = the radius), packed as
four planes: the sorted coordinates and each row's original index as an
f32 payload (exact for M < 2^24). The queries are sorted the same way so
that consecutive blocks stay window-coherent; ``block_windows`` gives each
query block its K candidate windows, and K8 (``top1_walk``, CUDA kernel in
``csrc/nn_walk.cu``) walks them.

Semantics, as in the JAX package: the nearest valid target within
``radius``; ties go to the lowest sorted target row; d² ≥ 1e30 where a
query has no target within radius or is invalid. The returned index is the
payload of the walk's last improvement in any case, inside the radius or
not (0 where the block's windows are empty), so rows without a match carry
an index too, and it is compared exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel, on_device, sm_count
from tpu3d_torch.ops.slab2 import Slab2Index, block_windows, build_slab2

_BIG = 1e30
_PAD_Q = 2.9e4  # padding queries: coordinates past every target
_MAX_ROWS = 1 << 24  # f32 payload exactness bound
_MAX_K = 16
_BLOCKS = (128, 256, 512)
# Distance values per step of the plain version (64 MB of fp32), and its
# candidate columns per step.
_PLAIN_MAX_ELEMS = 1 << 24
_PLAIN_COLS = 1024


class WalkTarget(NamedTuple):
    """Prebuilt target side of the slab2 walk NN. ``packed`` rows 0-2 are
    the sorted coordinate planes (3e4 on invalid rows), row 3 the original
    row as f32. The scalars are (1,)-shaped, as in the JAX package."""

    packed: torch.Tensor  # f32[4, M]
    sorted_key: torch.Tensor  # i32[M]
    x0: torch.Tensor  # f32[1]
    inv_w: torch.Tensor  # f32[1]
    y0: torch.Tensor  # f32[1]
    y_scale: torch.Tensor  # f32[1]


def build_walk_target(targets: torch.Tensor, tmask: torch.Tensor,
                      radius) -> WalkTarget:
    """One composite-key sort of the target cloud."""
    assert targets.shape[0] < _MAX_ROWS, "f32 payload exactness bound"
    tslab = build_slab2(targets, tmask, float(np.float32(radius)))
    packed = torch.cat([tslab.sorted_points_t,
                        tslab.sorted_orig.to(torch.float32)[None]])
    return WalkTarget(
        packed=packed.contiguous(),
        sorted_key=tslab.sorted_key,
        x0=tslab.x0.reshape(1),
        inv_w=tslab.inv_w.reshape(1),
        y0=tslab.y0.reshape(1),
        y_scale=tslab.y_scale.reshape(1),
    )


def _windows_index(wt: WalkTarget) -> Slab2Index:
    """The part of a Slab2Index that ``block_windows`` reads."""
    return Slab2Index(
        sorted_points_t=None,
        sorted_orig=None,
        sorted_key=wt.sorted_key,
        valid_sorted=None,
        x0=wt.x0[0],
        inv_w=wt.inv_w[0],
        y0=wt.y0[0],
        y_scale=wt.y_scale[0],
    )


def _check(q4, packed, lo, ln, block):
    if block not in _BLOCKS:
        raise ValueError(f"top1_walk: block must be one of {_BLOCKS}, got "
                         f"{block}")
    if q4.ndim != 2 or q4.shape[0] != 4 or q4.shape[1] % block:
        raise ValueError("top1_walk: q4 must be (4, Qp) with Qp % block == 0")
    if packed.ndim != 2 or packed.shape[0] != 4:
        raise ValueError("top1_walk: packed must be (4, M)")
    if packed.shape[1] >= _MAX_ROWS:
        raise ValueError(f"top1_walk: M = {packed.shape[1]} is not below "
                         "2^24, the f32 payload's exactness bound")
    nb = q4.shape[1] // block
    if lo.ndim != 2 or lo.shape[0] != nb or ln.shape != lo.shape:
        raise ValueError(f"top1_walk: lo and ln must be ({nb}, K)")
    if not 1 <= lo.shape[1] <= _MAX_K:
        raise ValueError(f"top1_walk: K must be 1 to {_MAX_K}, got "
                         f"{lo.shape[1]}")
    if q4.dtype != torch.float32 or packed.dtype != torch.float32:
        raise TypeError("top1_walk takes float32 planes")
    if lo.dtype != torch.int32 or ln.dtype != torch.int32:
        raise TypeError("top1_walk takes int32 window tables")


def top1_walk_plain(q4, packed, lo, ln, r2, block):
    """Plain PyTorch version of K8: per group of blocks, each block's
    window rows gathered in walk order, then a running first-argmin over
    column chunks (padding columns at +inf), updated on a strict '<'."""
    nbk, k = lo.shape
    dev = q4.device
    q = q4.reshape(4, nbk, block)
    d2 = torch.empty((nbk, block), dtype=torch.float32, device=dev)
    pay = torch.empty((nbk, block), dtype=torch.float32, device=dev)
    ends = torch.cumsum(ln.long(), 1)  # (nbk, K)
    group = max(1, _PLAIN_MAX_ELEMS // (block * _PLAIN_COLS))
    for g0 in range(0, nbk, group):
        g1 = min(nbk, g0 + group)
        ends_g = ends[g0:g1]
        tot = ends_g[:, -1]
        bd = torch.full((g1 - g0, block), _BIG, dtype=torch.float32,
                        device=dev)
        bi = torch.zeros((g1 - g0, block), dtype=torch.float32, device=dev)
        qx, qy, qz = (q[i, g0:g1, :, None] for i in range(3))
        for c0 in range(0, int(tot.max()), _PLAIN_COLS):
            col = torch.arange(c0, c0 + _PLAIN_COLS, device=dev).expand(
                g1 - g0, -1).contiguous()
            win = torch.searchsorted(ends_g, col, right=True).clamp_max(k - 1)
            first = (ends_g - ln[g0:g1].long()).gather(1, win)
            row = lo[g0:g1].long().gather(1, win) + (col - first)
            own = col < tot[:, None]
            cand = packed[:, torch.where(own, row, 0)]  # (4, G, C)
            dx = cand[0, :, None, :] - qx
            dy = cand[1, :, None, :] - qy
            dz = cand[2, :, None, :] - qz
            dist = dx * dx + dy * dy + dz * dz  # (G, B, C)
            dist = torch.where(own[:, None, :], dist, float("inf"))
            loc_min, loc_arg = dist.min(2)  # the first least column
            better = loc_min < bd
            bd = torch.where(better, loc_min, bd)
            bi = torch.where(better, cand[3].gather(1, loc_arg), bi)
        d2[g0:g1] = torch.where((q[3, g0:g1] > 0.5) & (bd <= r2), bd, _BIG)
        pay[g0:g1] = bi
    return d2.reshape(-1), pay.reshape(-1).to(torch.int32)


# K8's launch plan: CTAs of 128 threads, each a slice of 1, 2 or 4 of a
# query block (``slices``), each thread ``per`` = block / (128 · slices)
# queries (one staged row serves all of them). A layout takes the fewest
# slices that still launch WALK_CTAS_PER_SM CTAs an SM: four queries a
# thread win where the card is full, slices spread few blocks over more
# SMs. Device ms per call, the medians of six runs of chip_smoke.py's
# ``plan_sides`` on an H100 at 700 W (the run PERF.md's section 6 reports;
# slices 1 / 2 / 4 of blocks of 512, so 4 / 2 / 1 queries a thread): the
# 1M self-join's 2,048 blocks 0.8443 / 0.9208 / 0.9991, its first 1,024
# 0.5188 / 0.5199 / 0.5098, 660 0.3421 / 0.3572 / 0.3428, 264 0.2208 /
# 0.1656 / 0.1637, 96 0.1850 / 0.0982 / 0.0840; the jittered queries'
# 2,048 1.1591 / 1.2567 / 1.3673. In blocks of 128 (8,192 of them) a
# query a thread at 128 threads took 0.3237, at 64 threads 0.3302 (two a
# thread) and 0.3718 (two slices). The kernel launches the blocks with the
# most window rows first; in row order the same launches took 1.0732
# (2,048 blocks of 512), 0.3900 (8,192 of 128) and 0.0901 (96 of 512).
WALK_CTAS_PER_SM = 4
WALK_THREADS = 128


def nn_walk_plan(block: int, nblocks: int, sms: int) -> tuple[int, int]:
    """(slices, per) of K8's launch: CTAs per query block and queries per
    thread, for ``nblocks`` blocks of ``block`` queries on ``sms`` SMs."""
    slices = 1
    while (slices < block // WALK_THREADS
           and nblocks * slices < WALK_CTAS_PER_SM * sms):
        slices *= 2
    return slices, block // (WALK_THREADS * slices)


def top1_walk(q4, packed, lo, ln, r2, block, sub=512):
    """K8: (d2 f32[Qp], idx i32[Qp]) in key-sorted query order.

    q4 f32[4, Qp] (sorted query x, y, z, validity; Qp % block == 0),
    packed f32[4, M] (the WalkTarget's planes), lo/ln i32[Qp/block, K]
    windows, r2 the fp32 squared radius. ``block`` is 128, 256 or 512
    (the launch, CTAs a block and queries a thread, is ``nn_walk_plan``'s);
    ``sub``, rounded down to 128, 256 or 512 (at least 128), is the walk's
    tile of staged rows and does not change results. CUDA tensors launch
    the kernel; CPU tensors take the plain version."""
    _check(q4, packed, lo, ln, block)
    if not launches_kernel(q4, packed, lo, ln):
        return top1_walk_plain(q4, packed, lo, ln, r2, block)
    if not all(x.is_contiguous() for x in (q4, packed, lo, ln)):
        raise ValueError("top1_walk kernel takes contiguous tensors")
    qp = q4.shape[1]
    tile = 512 if sub >= 512 else 256 if sub >= 256 else 128
    slices, per = nn_walk_plan(block, lo.shape[0], sm_count(q4.device))
    # The CTAs' launch order, which the kernel writes here.
    order = torch.empty((lo.shape[0],), dtype=torch.int32, device=q4.device)
    d2 = torch.empty((qp,), dtype=torch.float32, device=q4.device)
    idx = torch.empty((qp,), dtype=torch.int32, device=q4.device)
    with on_device(q4.device):
        rc = build.library().tpu3d_nn_walk_top1(
            q4.data_ptr(), packed.data_ptr(), lo.data_ptr(), ln.data_ptr(),
            order.data_ptr(), qp, packed.shape[1], lo.shape[0], lo.shape[1],
            block, tile, slices, per, float(r2), d2.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream(q4.device).cuda_stream,
        )
    build.check(rc, "tpu3d_nn_walk_top1")
    build.count_launch(top1_walk)
    return d2, idx


top1_walk.launches = 0


def walk_operands(wt: WalkTarget, queries: torch.Tensor, qmask: torch.Tensor,
                  radius, block: int, k_windows: int):
    """(q4, lo, ln, sorted_orig): the key-sorted, padded queries and their
    blocks' windows over ``wt``; ``sorted_orig`` maps sorted query rows
    back to the caller's rows."""
    r = float(np.float32(radius))
    qslab = build_slab2(queries, qmask, r)  # block coherence for windows
    nq = queries.shape[0]
    pad = (-nq) % block
    dev = queries.device
    coords = torch.cat([
        qslab.sorted_points_t,
        torch.full((3, pad), _PAD_Q, dtype=torch.float32, device=dev),
    ], 1)
    mb = torch.cat([qslab.valid_sorted,
                    torch.zeros(pad, dtype=torch.bool, device=dev)])
    mb = mb.reshape(-1, block)
    lo, ln = block_windows(
        _windows_index(wt),
        (coords[0].reshape(-1, block), coords[1].reshape(-1, block)),
        mb, r, k_max=k_windows)
    q4 = torch.cat([coords, mb.reshape(1, -1).to(torch.float32)])
    return q4.contiguous(), lo, ln, qslab.sorted_orig


def slab2_top1_indexed(
    wt: WalkTarget,
    queries: torch.Tensor,  # f32[Q, 3]
    qmask: torch.Tensor,  # bool[Q]
    radius,
    block: int = 128,
    sub: int = 256,
    k_windows: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Query pass against a prebuilt target: (idx i32[Q], d2 f32[Q]) in the
    caller's query order; d2 ≥ 1e30 where there is no valid target within
    ``radius`` or the query is invalid. The device is the inputs'."""
    r = np.float32(radius)
    q4, lo, ln, sorted_orig = walk_operands(wt, queries, qmask, r, block,
                                            k_windows)
    d2_s, idx_s = top1_walk(q4, wt.packed, lo, ln, float(r * r), block, sub)
    nq = queries.shape[0]
    d2 = torch.empty((nq,), dtype=torch.float32, device=queries.device)
    idx = torch.empty((nq,), dtype=torch.int32, device=queries.device)
    d2[sorted_orig] = d2_s[:nq]
    idx[sorted_orig] = idx_s[:nq]
    return idx, d2


def slab2_top1(
    queries: torch.Tensor,  # f32[Q, 3]
    qmask: torch.Tensor,  # bool[Q]
    targets: torch.Tensor,  # f32[M, 3], M < 2^24
    tmask: torch.Tensor,  # bool[M]
    radius,
    block: int = 128,
    sub: int = 256,
    k_windows: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Build and query in one call (see ``slab2_top1_indexed``)."""
    wt = build_walk_target(targets, tmask, radius)
    return slab2_top1_indexed(wt, queries, qmask, radius, block=block,
                              sub=sub, k_windows=k_windows)
