"""K2, K3, K4: the fused-prepare sweeps — CUDA kernels and plain versions.

Counterpart of ``tpu3d/ops/features_pallas.py`` (``moments_sweep_pallas``,
``spfh_sweep_pallas``, ``fpfh_sweep_pallas``) on the multi-window walk of
``tpu3d/ops/pallas_walk.py`` (``window_walk``, K1). Each sweep runs one
query block of ``block`` consecutive padded rows against that block's
three candidate windows ``[lo, lo + len)`` of the bucket-aligned layout
(``ops/slab2.py``), in window order and ascending row order; a zero-length
window costs nothing, which is how the sparse prepare prunes.

  K2 ``moments_sweep``: over candidates with d² ≤ r² (raw coordinates), the
     9 moments centred on the block's mean of valid queries plus the count;
     then cov = E[cc] − μμᵀ, the Newton smallest eigenvector, flipped so
     n·p ≤ 0, zero on invalid rows → f32[8, Mp]: rows 0-2 normal, 3 count.
  K3 ``spfh_sweep``: over candidates with r² ≥ d² ≥ 1e-16 on the caller's
     centroid-shifted coordinates, the Darboux angles α, φ and θ (θ through
     the diamond-angle surrogate), 30 cumulative threshold counts, then the
     L1-normalised 33-bin SPFH → f32[40, Mp]: rows 0-32 SPFH, 33 count.
  K4 ``fpfh_sweep``: Σ over candidates with r² ≥ d² ≥ 1e-16 (raw
     coordinates) of SPFH_j / d → f32[Mp, 36], columns 0-32 used; with a
     block list (the sparse prepare's query blocks) it runs on those blocks
     only.

The kernels live in ``csrc/features.cu`` (walk in ``csrc/window_walk.cuh``).
Each plain version gathers a group of blocks' windows into padded (R, G, L)
candidate planes and walks the L columns in chunks of ``_COLS``: the
per-pair terms of a chunk are elementwise over (G, B, _COLS), and the
floating-point sums then take its columns in order. So it never builds an
Mp × Mp plane, and its sums take the kernel's order: one rounding per
operation, sequential over candidates. ``sub`` is a TPU tile width that
does not change results; it is accepted and ignored.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel
from tpu3d_torch.ops.normals import smallest_eigvec_3x3_planes_newton

# floor((x+1)·5.5) ≥ b  ⇔  x ≥ b/5.5 − 1, b = 1..10.
_BIN_THRESH = tuple(b / 5.5 - 1.0 for b in range(1, 11))


def _diamond(s: float, c: float) -> float:
    """Monotone surrogate of atan2(s, c) onto (−2, 2]."""
    u = s / (abs(s) + abs(c))
    if c >= 0.0:
        return u
    return (2.0 if s >= 0.0 else -2.0) - u


_DIAMOND_THRESH = tuple(
    _diamond(math.sin(math.pi * t), math.cos(math.pi * t)) for t in _BIN_THRESH
)
# The 20 fp32 thresholds both versions compare against: α and φ use the
# first ten, θ's diamond surrogate the last ten.
THRESH = np.array(_BIN_THRESH + _DIAMOND_THRESH, dtype=np.float32)

# Gathered candidate values (rows × blocks × columns) per group of blocks
# in the plain versions, and candidate columns per elementwise step.
_PLAIN_MAX_ELEMS = 1 << 26
_COLS = 32


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (a power of two) by halving, the order of the
    kernels' shared-memory tree."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _groups(packed, lo, ln, block):
    """Yield (g0, g1, cand (R, G, L), own (G, L)) over groups of blocks:
    each block's windows concatenated in order, padded to the group's
    longest list."""
    nbk = lo.shape[0]
    r = packed.shape[0]
    m = packed.shape[1]
    tot_all = ln.long().sum(1)
    lmax = max(int(tot_all.max()), 1) if nbk else 1
    group = max(1, _PLAIN_MAX_ELEMS // (r * lmax))
    for g0 in range(0, nbk, group):
        g1 = min(nbk, g0 + group)
        lo_g = lo[g0:g1].long()
        ln_g = ln[g0:g1].long()
        tot = tot_all[g0:g1]
        length = max(int(tot.max()), 1)
        col = torch.arange(length, device=lo.device)[None, :]
        ends = torch.cumsum(ln_g, 1)
        k = (col >= ends[:, 0:1]).long() + (col >= ends[:, 1:2]).long()
        first = (ends - ln_g).gather(1, k)
        row = lo_g.gather(1, k) + (col - first)
        own = col < tot[:, None]
        row = torch.where(own, row, 0).clamp(0, m - 1)
        yield g0, g1, packed[:, row], own


def _check(name, q8, packed, lo, ln, block, rows):
    # The kernels run one thread per query row; both paths take the same
    # blocks so that they accept the same inputs.
    if block not in (128, 256):
        raise ValueError(f"{name}: block must be 128 or 256, got {block}")
    mp = q8.shape[1]
    if q8.ndim != 2 or q8.shape[0] != 8 or mp % block:
        raise ValueError(f"{name}: q8 must be (8, Mp) with Mp % block == 0")
    if packed.ndim != 2 or packed.shape != (rows, mp):
        raise ValueError(f"{name}: packed must be ({rows}, {mp}), got "
                         f"{tuple(packed.shape)}")
    if lo.shape != (mp // block, 3) or ln.shape != lo.shape:
        raise ValueError(f"{name}: lo and ln must be ({mp // block}, 3)")


def _launch(fn_name, q8, packed, lo, ln, r2, block, out, *extra):
    fins = [x.contiguous() for x in (q8, packed)]
    if any(x.dtype != torch.float32 for x in fins):
        raise TypeError(f"{fn_name} takes float32 planes")
    ints = [x.to(torch.int32).contiguous() for x in (lo, ln)]
    rc = getattr(build.library(), fn_name)(
        *(x.data_ptr() for x in fins), *(x.data_ptr() for x in ints),
        q8.shape[1], lo.shape[0], block, float(r2), *extra, out.data_ptr(),
        torch.cuda.current_stream(q8.device).cuda_stream,
    )
    build.check(rc, fn_name)


# --------------------------------------------------------------------------
# K2: moments → normals
# --------------------------------------------------------------------------


def moments_sweep_plain(q8, packed3, lo, ln, r2, block):
    """Plain PyTorch version of K2 (see the module docstring)."""
    mp = q8.shape[1]
    nbk = mp // block
    q = q8[:4].reshape(4, nbk, block)
    valid = q[3] > 0.5
    wq = valid.to(torch.float32)
    cnt_q = torch.clamp_min(_tree_sum(wq), 1.0)
    ctr = torch.stack([_tree_sum(q[i] * wq) for i in range(3)]) / cnt_q
    mom = torch.zeros((10, nbk, block), dtype=torch.float32, device=q8.device)
    for g0, g1, cand, own in _groups(packed3, lo, ln, block):
        qx, qy, qz = (q[i, g0:g1, :, None] for i in range(3))
        cx, cy, cz = (ctr[i, g0:g1, None, None] for i in range(3))
        acc = mom[:, g0:g1]
        for j0 in range(0, cand.shape[2], _COLS):
            tx, ty, tz = (cand[i, :, None, j0:j0 + _COLS] for i in range(3))
            dx, dy, dz = tx - qx, ty - qy, tz - qz
            d2 = dx * dx + dy * dy + dz * dz  # (G, B, C)
            w = own[:, None, j0:j0 + _COLS] & (d2 <= r2)
            c0, c1, c2 = tx - cx, ty - cy, tz - cz
            feats = torch.where(w, torch.stack(
                [c0, c1, c2, c0 * c0, c1 * c1, c2 * c2, c0 * c1, c0 * c2,
                 c1 * c2]), 0.0)  # (9, G, B, C)
            for j in range(feats.shape[3]):
                acc[:9] += feats[..., j]
            acc[9] += w.sum(-1).to(torch.float32)  # whole counts
    mom = mom.reshape(10, mp)
    cnt = torch.clamp_min(mom[9], 1.0)
    mx, my, mz = mom[0] / cnt, mom[1] / cnt, mom[2] / cnt
    nx, ny, nz = smallest_eigvec_3x3_planes_newton(
        mom[3] / cnt - mx * mx, mom[6] / cnt - mx * my,
        mom[7] / cnt - mx * mz, mom[4] / cnt - my * my,
        mom[8] / cnt - my * mz, mom[5] / cnt - mz * mz,
    )
    flip = nx * q8[0] + ny * q8[1] + nz * q8[2] > 0
    sgn = torch.where(q8[3] > 0.5, torch.where(flip, -1.0, 1.0), 0.0)
    zero = torch.zeros_like(nx)
    return torch.stack([nx * sgn, ny * sgn, nz * sgn, mom[9],
                        zero, zero, zero, zero])


def moments_sweep(q8, packed3, lo, ln, r2, block, sub=None):
    """K2: f32[8, Mp] — rows 0-2 the viewpoint-flipped unit normal (zero on
    invalid rows), row 3 the radius-neighbour count.

    q8 f32[8, Mp] (rows 0-2 raw xyz, 3 validity), packed3 f32[3, Mp] (raw
    xyz, sentinel 3e4 on padding), lo/ln i32[Mp/block, 3]. CUDA tensors
    launch the kernel; CPU tensors take the plain version."""
    del sub
    _check("moments_sweep", q8, packed3, lo, ln, block, 3)
    if not launches_kernel(q8, packed3, lo, ln):
        return moments_sweep_plain(q8, packed3, lo, ln, r2, block)
    out = torch.empty((8, q8.shape[1]), dtype=torch.float32, device=q8.device)
    _launch("tpu3d_moments_sweep", q8, packed3, lo, ln, r2, block, out)
    build.count_launch(moments_sweep)
    return out


moments_sweep.launches = 0


# --------------------------------------------------------------------------
# K3: SPFH
# --------------------------------------------------------------------------


def spfh_sweep_plain(q8n, packed10, lo, ln, r2, block):
    """Plain PyTorch version of K3 (see the module docstring)."""
    mp = q8n.shape[1]
    nbk = mp // block
    dev = q8n.device
    q = q8n[:7].reshape(7, nbk, block)
    thr = torch.from_numpy(THRESH).to(dev)
    thr3 = torch.stack([thr[:10], thr[:10], thr[10:]])[:, :, None, None]
    cum = torch.zeros((3, 10, nbk, block), dtype=torch.int32, device=dev)
    cnt = torch.zeros((nbk, block), dtype=torch.int32, device=dev)
    for g0, g1, cand, own in _groups(packed10, lo, ln, block):
        px, py, pz = (q[i, g0:g1, :, None] for i in range(3))
        nx, ny, nz = (q[i, g0:g1, :, None] for i in range(4, 7))
        bx, by, bz = py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx
        for j0 in range(0, cand.shape[2], _COLS):
            t = [cand[i, :, None, j0:j0 + _COLS] for i in range(10)]
            dx, dy, dz = t[0] - px, t[1] - py, t[2] - pz
            d2 = dx * dx + dy * dy + dz * dz  # (G, B, C)
            anum = (nx * t[3] + ny * t[4] + nz * t[5]
                    + bx * t[6] + by * t[7] + bz * t[8])
            c = nx * t[6] + ny * t[7] + nz * t[8]
            pin = px * t[6] + py * t[7] + pz * t[8]
            contrib = (own[:, None, j0:j0 + _COLS] & (d2 <= r2)
                       & (d2 >= 1e-16))
            inv_d = 1.0 / torch.sqrt(torch.clamp_min(d2, 1e-24))
            phi = (nx * dx + ny * dy + nz * dz) * inv_d
            e = (t[9] - pin) * inv_d
            alpha = anum * inv_d
            s = phi * c - e
            u = s / torch.clamp_min(s.abs() + c.abs(), 1e-30)
            dth = torch.where(c >= 0, u, torch.where(s >= 0, 2.0, -2.0) - u)
            ang = torch.stack([alpha, phi, dth])[:, None]  # (3, 1, G, B, C)
            hit = contrib & (ang >= thr3[..., None])
            cum[:, :, g0:g1] += hit.sum(-1, dtype=torch.int32)
            cnt[g0:g1] += contrib.sum(-1, dtype=torch.int32)
    cum = cum.reshape(3, 10, mp)
    cnt = cnt.reshape(mp)
    bins = []
    for a in range(3):
        ca = cum[a]
        bins += [cnt - ca[0], *(ca[:-1] - ca[1:]), ca[9]]
    hist = torch.stack(bins).to(torch.float32)  # (33, Mp) whole counts
    s = hist.sum(0)
    norm = torch.where(s > 0, hist / torch.clamp_min(s, 1e-30), hist)
    return torch.cat([
        norm, cnt.to(torch.float32)[None],
        torch.zeros((6, mp), dtype=torch.float32, device=dev),
    ])


def spfh_sweep(q8n, packed10, lo, ln, r2, block, sub=None):
    """K3: f32[40, Mp] — rows 0-32 the L1-normalised SPFH, row 33 the
    neighbour count.

    q8n f32[8, Mp] (rows 0-2 centred xyz, 3 validity, 4-6 normal),
    packed10 f32[10, Mp] (centred xyz, b = p×n, n, a = p·n), lo/ln
    i32[Mp/block, 3]. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    del sub
    _check("spfh_sweep", q8n, packed10, lo, ln, block, 10)
    if not launches_kernel(q8n, packed10, lo, ln):
        return spfh_sweep_plain(q8n, packed10, lo, ln, r2, block)
    out = torch.empty((40, q8n.shape[1]), dtype=torch.float32,
                      device=q8n.device)
    host_thresh = (ctypes.c_float * 20)(*THRESH.tolist())
    _launch("tpu3d_spfh_sweep", q8n, packed10, lo, ln, r2, block, out,
            ctypes.cast(host_thresh, ctypes.c_void_p).value)
    build.count_launch(spfh_sweep)
    return out


spfh_sweep.launches = 0


# --------------------------------------------------------------------------
# K4: FPFH weighted sum
# --------------------------------------------------------------------------


def fpfh_sweep_plain(q8, packed36, lo, ln, r2, block, blocks=None):
    """Plain PyTorch version of K4 (see the module docstring)."""
    mp = q8.shape[1]
    nbk = mp // block
    if blocks is not None:
        listed = torch.zeros(nbk, dtype=torch.bool, device=ln.device)
        listed[blocks.long()] = True
        ln = torch.where(listed[:, None], ln, 0)
    q = q8[:3].reshape(3, nbk, block)
    acc_all = torch.zeros((33, nbk, block), dtype=torch.float32,
                          device=q8.device)
    for g0, g1, cand, own in _groups(packed36, lo, ln, block):
        qx, qy, qz = (q[i, g0:g1, :, None] for i in range(3))
        acc = acc_all[:, g0:g1]
        for j0 in range(0, cand.shape[2], _COLS):
            tx, ty, tz = (cand[i, :, None, j0:j0 + _COLS] for i in range(3))
            dx, dy, dz = tx - qx, ty - qy, tz - qz
            d2 = dx * dx + dy * dy + dz * dz  # (G, B, C)
            contrib = (own[:, None, j0:j0 + _COLS] & (d2 <= r2)
                       & (d2 >= 1e-16))
            w = torch.where(contrib,
                            1.0 / torch.sqrt(torch.clamp_min(d2, 1e-24)), 0.0)
            for j in range(w.shape[2]):
                acc += w[None, :, :, j] * cand[3:36, :, j0 + j, None]
    out = torch.zeros((mp, 36), dtype=torch.float32, device=q8.device)
    out[:, :33] = acc_all.reshape(33, mp).T
    return out


# Dense layouts of up to this many blocks per SM take K4's lane kernel.
# Lane / thread-per-query device time on an H100 (132 SMs) at the dense
# layouts chip_smoke.py runs: 0.44 at 191 blocks, 0.51 at 255, 1.16 at
# 911, 1.48 at 1,151 and 1.76 at 8,700; the ratio, log-linear in the
# block count between 255 and 911, reaches 1 at ~720 blocks, 5.5 an SM.
LANE_BLOCKS_PER_SM = 5


def fpfh_plan(block: int, nblocks: int, listed: bool,
              sms: int) -> tuple[int, int]:
    """(slices, warps) of K4's launch: CTAs per query block and warps per
    CTA. A block list (the sparse prepare's few query blocks), or a layout
    of at most LANE_BLOCKS_PER_SM blocks per SM (``sms`` of them), runs the
    kernel with the bins across the lanes, each block split into slices of
    32 queries on 8 warps, so that its blocks fill the card; a larger
    layout runs one CTA per block, a thread per query (the kernel with the
    sums in registers), which measured faster there."""
    if listed or nblocks <= LANE_BLOCKS_PER_SM * sms:
        return block // 32, 8
    return 1, block // 32


def fpfh_sweep(q8, packed36, lo, ln, r2, block, sub=None, blocks=None):
    """K4: f32[Mp, 36] — columns 0-32 the 1/d-weighted sum of the
    neighbours' SPFH (the own SPFH is added outside).

    q8 f32[8, Mp] (rows 0-2 raw xyz), packed36 f32[36, Mp] (raw xyz, 33
    SPFH planes), lo/ln i32[Mp/block, 3]. ``blocks`` (i32[K]) lists the
    only blocks whose windows may be non-empty, as the sparse prepare's
    query blocks are: the kernel runs on them alone and every other row is
    zero. CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    del sub
    _check("fpfh_sweep", q8, packed36, lo, ln, block, 36)
    if not launches_kernel(q8, packed36, lo, ln):
        return fpfh_sweep_plain(q8, packed36, lo, ln, r2, block, blocks)
    mp = q8.shape[1]
    if blocks is None:
        out = torch.empty((mp, 36), dtype=torch.float32, device=q8.device)
        nblocks = mp // block
    else:
        blocks = blocks.to(q8.device, torch.int32).contiguous()
        out = torch.zeros((mp, 36), dtype=torch.float32, device=q8.device)
        nblocks = blocks.shape[0]
    slices, warps = fpfh_plan(
        block, nblocks, blocks is not None,
        torch.cuda.get_device_properties(q8.device).multi_processor_count)
    fins = [x.contiguous() for x in (q8, packed36)]
    if any(x.dtype != torch.float32 for x in fins):
        raise TypeError("tpu3d_fpfh_sweep takes float32 planes")
    ints = [x.to(torch.int32).contiguous() for x in (lo, ln)]
    rc = build.library().tpu3d_fpfh_sweep(
        *(x.data_ptr() for x in fins), *(x.data_ptr() for x in ints),
        0 if blocks is None else blocks.data_ptr(), mp, nblocks, block,
        slices, warps, float(r2), out.data_ptr(),
        torch.cuda.current_stream(q8.device).cuda_stream,
    )
    build.check(rc, "tpu3d_fpfh_sweep")
    build.count_launch(fpfh_sweep)
    return out


fpfh_sweep.launches = 0
