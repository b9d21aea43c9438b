"""K7: one ICP correspondence pass — CUDA kernel and plain versions.

Counterpart of ``tpu3d/ops/icp_pallas.py`` (``icp_p2plane_stats_pallas``)
with the one-window walk of ``tpu3d/ops/pallas_walk.py`` ``window_walk``,
and of the per-query matches that the point-to-point branch of
``tpu3d/ops/icp.py`` ``fused_slab_stats_fn`` emits. One call is one pass
at pose T over query blocks of ``block`` consecutive source rows (sorted
by x at the start pose):

  1. P = R·s + t per source row, as ((R_i0·s_x + R_i1·s_y) + R_i2·s_z) +
     t_i with one rounding per operation (:func:`transform_rows`);
  2. per block the window [lo, lo + len) of the x-sorted target rows whose
     x lies in [min P_x − r, max P_x + r] over the block's valid rows
     (:func:`query_windows`; empty without one). The JAX package keys
     padding rows at x = 2.9e4 instead, which stretches the window of the
     one block that mixes valid and padding rows to the last target row;
     every kept match lies within r of its query's x, so the kept matches
     and the sums are the same;
  3. each query's nearest row of its block's window, the lowest row on
     ties, kept when the row is valid and d² ≤ thr² (inclusive).

Then :func:`icp_p2plane_stats` reduces the kept matches to one f32[44]
vector, J = [p×n | n] and r = (p − q)·n: JᵀJ (6 × 6, row-major), Jᵀr (6),
n_corr, Σd²; and :func:`icp_matches` returns the matches themselves: P,
d² (1e30 where the window is empty) and the matched slab row (−1 there),
for the point-to-point statistics. ``packed`` holds the slab-sorted
coordinates (invalid rows at 3e4) and, for point-to-plane, the normals.

The kernel lives in ``csrc/icp_stats.cu``; one launch does all of it, the
sum over blocks included.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel

PARTIAL_WIDTH = 32
STATS_WIDTH = 44
# CUDA threads that split each query's window in the kernel.
LANES = 8
_BIG = 1e30
_PAD_Q = 2.9e4
_TRIU = torch.triu_indices(6, 6)
# (query, window row) pairs per group of blocks in the plain version.
_PLAIN_MAX_ELEMS = 1 << 24


def transform_rows(src: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(N, 3) rows of R·s + t, summed left to right with one rounding per
    operation, the order the kernel uses."""
    T = T.to(src.device, torch.float32)
    x, y, z = src.unbind(1)
    return torch.stack(
        [((x * T[i, 0] + y * T[i, 1]) + z * T[i, 2]) + T[i, 3]
         for i in range(3)], dim=1)


def _block_partials(P, wf, keep, bd, bq, bn):
    """(G, B) per-query matches → (G, PARTIAL_WIDTH) block sums."""
    px, py, pz = P.unbind(-1)
    nx, ny, nz = bn.unbind(-1)
    J = torch.stack(
        [py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx, nx, ny, nz],
        dim=-1,
    )  # (G, B, 6)
    r = ((P - bq) * bn).sum(-1)
    Jw = J * wf[..., None]
    ata = torch.einsum("gbi,gbj->gij", Jw, J)[:, _TRIU[0], _TRIU[1]]
    atb = (Jw * (r * wf)[..., None]).sum(1)
    g = P.shape[0]
    return torch.cat(
        [
            ata, atb, wf.sum(1, keepdim=True),
            torch.where(keep, bd, 0.0).sum(1, keepdim=True),
            torch.zeros((g, 3), dtype=P.dtype, device=P.device),
        ],
        dim=1,
    )


def unpack_partials(parts: torch.Tensor):
    """Sum block partials → (ata (6,6), atb (6,), n_corr, sum_d2)."""
    s = parts.sum(0)
    ata = torch.zeros((6, 6), dtype=s.dtype, device=s.device)
    ata[_TRIU[0].to(s.device), _TRIU[1].to(s.device)] = s[:21]
    ata = ata + ata.T - torch.diag(torch.diagonal(ata))
    return ata, s[21:27], s[27], s[28]


def _matches_plain(src, qmask, packed, sorted_x, T, radius, block):
    """(P, d², row, valid) of steps 1-3, the windows gathered to their
    common maximum length in groups of blocks bounded by
    _PLAIN_MAX_ELEMS."""
    P = transform_rows(src, T)
    valid = qmask > 0.5
    nb = src.shape[0] // block
    lo, length = query_windows(sorted_x, P, valid, radius, block)
    m = packed.shape[1]
    lmax = max(int(length.max()), 1) if nb else 1
    group = max(1, _PLAIN_MAX_ELEMS // (block * lmax))
    col = torch.arange(lmax, device=src.device)
    d2_all, row_all = [], []
    for g0 in range(0, nb, group):
        g1 = min(nb, g0 + group)
        Pg = P[g0 * block:g1 * block].reshape(g1 - g0, block, 3)
        rows = lo[g0:g1, None].long() + col[None, :]
        own = col[None, :] < length[g0:g1, None]
        cand = packed[:3, rows.clamp(0, m - 1)]  # (3, G, L)
        dx = cand[0][:, None, :] - Pg[..., 0:1]
        dy = cand[1][:, None, :] - Pg[..., 1:2]
        dz = cand[2][:, None, :] - Pg[..., 2:3]
        d2 = dx * dx + dy * dy + dz * dz  # (G, B, L)
        d2 = torch.where(own[:, None, :], d2, _BIG)
        bd = d2.amin(-1)
        arg = torch.argmin(d2, dim=-1)  # lowest row on ties
        row = torch.where(bd < _BIG, lo[g0:g1, None].long() + arg, -1)
        d2_all.append(bd.reshape(-1))
        row_all.append(row.reshape(-1).to(torch.int32))
    if not d2_all:
        return (P, torch.zeros(0, device=src.device),
                torch.zeros(0, dtype=torch.int32, device=src.device), valid)
    return P, torch.cat(d2_all), torch.cat(row_all), valid


def query_windows(sorted_x, P, valid, radius, block):
    """Step 2: i32 window starts and lengths per block of ``block`` rows,
    over each block's valid rows."""
    nb = P.shape[0] // block
    qx = P[:, 0].reshape(nb, block)
    vb = valid.reshape(nb, block)
    r = float(np.float32(radius))  # fp32 arithmetic on the device
    lo = torch.searchsorted(sorted_x, torch.where(vb, qx, _PAD_Q).amin(1) - r,
                            out_int32=True)
    hi = torch.searchsorted(sorted_x,
                            torch.where(vb, qx, -_PAD_Q).amax(1) + r,
                            right=True, out_int32=True)
    return lo, torch.clamp_min(hi - lo, 0)


def icp_matches_plain(src, qmask, packed, sorted_x, T, radius, block):
    """Plain PyTorch version of :func:`icp_matches`."""
    P, d2, row, _ = _matches_plain(src, qmask, packed, sorted_x, T, radius,
                                   block)
    return P, d2, row


def icp_p2plane_stats_plain(src, qmask, packed, sorted_x, T, radius, thr2,
                            block):
    """Plain PyTorch version of :func:`icp_p2plane_stats`."""
    P, bd, row, valid = _matches_plain(src, qmask, packed, sorted_x, T,
                                       radius, block)
    found = (row >= 0)[:, None]
    win = packed[:, row.long().clamp_min(0)].T  # (Np, 6)
    win = torch.where(found, win, 0.0)
    keep = valid & (bd <= thr2)
    nb = src.shape[0] // block
    shape = (nb, block)
    parts = _block_partials(
        P.reshape(*shape, 3), keep.to(torch.float32).reshape(shape),
        keep.reshape(shape), bd.reshape(shape),
        win[:, :3].reshape(*shape, 3), win[:, 3:].reshape(*shape, 3))
    ata, atb, n_corr, sum_d2 = unpack_partials(parts)
    return torch.cat([ata.reshape(36), atb, n_corr[None], sum_d2[None]])


def _check(src, qmask, packed, sorted_x, block, planes):
    npad = src.shape[0]
    if src.ndim != 2 or src.shape[1] != 3 or npad % block:
        raise ValueError("src must be (nb*block, 3)")
    if qmask.shape != (npad,):
        raise ValueError("qmask must be (nb*block,)")
    if packed.ndim != 2 or packed.shape[0] < planes:
        raise ValueError(f"packed must be ({planes}, M)")
    if sorted_x.shape != (packed.shape[1],):
        raise ValueError("sorted_x must be (M,)")


# One zeroed block counter per (device, stream): the kernel's last block
# finds itself by it and sets it back to 0.
_COUNTERS: dict = {}


def _launch(src, qmask, packed, sorted_x, T, radius, thr2, block, mode,
            outs):
    if block * LANES not in (64, 128, 256, 512):
        raise ValueError(f"block must be 8, 16, 32 or 64 rows, got {block}")
    fins = [x.contiguous() for x in (src, qmask, packed, sorted_x)]
    if any(x.dtype != torch.float32 for x in fins):
        raise TypeError("the K7 kernel takes float32 tensors")
    pose = T.detach().to("cpu", torch.float32)[:3].reshape(-1).tolist()
    host = (ctypes.c_float * 12)(*pose)
    stream = torch.cuda.current_stream(src.device)
    key = (src.device.index, stream.cuda_stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=src.device)
    rc = build.library().tpu3d_icp_p2plane_stats(
        *(x.data_ptr() for x in fins), packed.shape[1],
        src.shape[0] // block, block,
        ctypes.cast(host, ctypes.c_void_p).value, float(radius), float(thr2),
        mode, *(0 if x is None else x.data_ptr() for x in outs),
        _COUNTERS[key].data_ptr(), stream.cuda_stream,
    )
    build.check(rc, "tpu3d_icp_p2plane_stats")


def icp_p2plane_stats(
    src: torch.Tensor,  # f32[Np, 3] source rows, Np = nb*block
    qmask: torch.Tensor,  # f32[Np] 1 for a valid query row
    packed: torch.Tensor,  # f32[6, M] slab-sorted coords (invalid: 3e4) + normals
    sorted_x: torch.Tensor,  # f32[M] ascending x keys (invalid: 3e4)
    T: torch.Tensor,  # (4, 4) pose, read on the host
    radius: float,
    thr2: float,
    block: int,
) -> torch.Tensor:
    """The point-to-plane sums f32[44] (see the module docstring). CUDA
    tensors launch the kernel, CPU tensors take the plain version."""
    _check(src, qmask, packed, sorted_x, block, 6)
    if not launches_kernel(src, qmask, packed, sorted_x):
        return icp_p2plane_stats_plain(src, qmask, packed, sorted_x, T,
                                       radius, thr2, block)
    nb = src.shape[0] // block
    parts = torch.empty((nb, PARTIAL_WIDTH), dtype=torch.float32,
                        device=src.device)
    out = torch.zeros(STATS_WIDTH, dtype=torch.float32, device=src.device) \
        if nb == 0 else torch.empty(STATS_WIDTH, dtype=torch.float32,
                                    device=src.device)
    _launch(src, qmask, packed, sorted_x, T, radius, thr2, block, 0,
            (parts, out, None, None, None))
    build.count_launch(icp_p2plane_stats)
    return out


icp_p2plane_stats.launches = 0


def icp_matches(src, qmask, packed, sorted_x, T, radius, block):
    """Steps 1-3 alone, the kernel's match-only epilogue: (P f32[Np, 3],
    d² f32[Np], row i32[Np]). ``packed`` needs the 3 coordinate planes.
    CUDA tensors launch the kernel, CPU tensors take the plain version."""
    _check(src, qmask, packed, sorted_x, block, 3)
    if not launches_kernel(src, qmask, packed, sorted_x):
        return icp_matches_plain(src, qmask, packed, sorted_x, T, radius,
                                 block)
    n = src.shape[0]
    P = torch.empty((n, 3), dtype=torch.float32, device=src.device)
    d2 = torch.empty(n, dtype=torch.float32, device=src.device)
    row = torch.empty(n, dtype=torch.int32, device=src.device)
    _launch(src, qmask, packed, sorted_x, T, radius, 0.0, block, 1,
            (None, None, P, d2, row))
    build.count_launch(icp_matches)
    return P, d2, row


icp_matches.launches = 0
