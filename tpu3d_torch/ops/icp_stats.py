"""K7: fused ICP point-to-plane statistics — CUDA kernel and plain version.

Counterpart of ``tpu3d/ops/icp_pallas.py`` (``icp_p2plane_stats_pallas``)
with the one-window walk of ``tpu3d/ops/pallas_walk.py`` ``window_walk``.
Per query block b (``block`` consecutive query rows, sorted by x): each
query's nearest slab row in [lo_b, lo_b + len_b) (lowest row on ties),
kept when mask and d² ≤ thr² (inclusive); then the block's partial sums
as one row of ``PARTIAL_WIDTH`` floats:

  [0:21]  upper triangle of JᵀJ, row-major (J = [p×n | n], transformed p)
  [21:27] Jᵀr with r = (p − q)·n
  [27]    n_corr        [28] Σ d² over kept rows        [29:32] zero

The kernel lives in ``csrc/icp_stats.cu``.
"""

from __future__ import annotations

import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel

PARTIAL_WIDTH = 32
_BIG = 1e30
_TRIU = torch.triu_indices(6, 6)
# (query, window row) pairs per group of blocks in the plain version.
_PLAIN_MAX_ELEMS = 1 << 24


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


def icp_p2plane_stats_plain(pts, qmask, packed, lo, length, thr2, block):
    """Plain PyTorch version: the windows are gathered to their common
    maximum length, in groups of blocks bounded by _PLAIN_MAX_ELEMS."""
    nb = lo.shape[0]
    m = packed.shape[1]
    lmax = max(int(length.max()), 1) if nb else 1
    group = max(1, _PLAIN_MAX_ELEMS // (block * lmax))
    out = []
    col = torch.arange(lmax, device=pts.device)
    for g0 in range(0, nb, group):
        g1 = min(nb, g0 + group)
        P = pts[g0 * block:g1 * block].reshape(g1 - g0, block, 3)
        valid = qmask[g0 * block:g1 * block].reshape(g1 - g0, block) > 0.5
        rows = lo[g0:g1, None].long() + col[None, :]
        own = col[None, :] < length[g0:g1, None]
        cand = packed[:, rows.clamp(0, m - 1)]  # (6, G, L)
        dx = cand[0][:, None, :] - P[..., 0:1]
        dy = cand[1][:, None, :] - P[..., 1:2]
        dz = cand[2][:, None, :] - P[..., 2:3]
        d2 = dx * dx + dy * dy + dz * dz  # (G, B, L)
        d2 = torch.where(own[:, None, :], d2, _BIG)
        bd = d2.amin(-1)
        arg = torch.argmin(d2, dim=-1)  # lowest row on ties
        found = (bd < _BIG)[..., None]
        win = torch.gather(
            cand.permute(1, 2, 0), 1,
            arg[..., None].expand(-1, -1, 6),
        )  # (G, B, 6)
        win = torch.where(found, win, 0.0)
        keep = valid & (bd <= thr2)
        wf = keep.to(torch.float32)
        out.append(_block_partials(P, wf, keep, bd, win[..., :3], win[..., 3:]))
    if not out:
        return torch.zeros((0, PARTIAL_WIDTH), dtype=torch.float32,
                           device=pts.device)
    return torch.cat(out)


def icp_p2plane_stats(
    pts: torch.Tensor,  # f32[Np, 3] transformed source rows, Np = nb*block
    qmask: torch.Tensor,  # f32[Np] 1 for a valid query row
    packed: torch.Tensor,  # f32[6, M] slab-sorted coords (invalid: 3e4) + normals
    lo: torch.Tensor,  # i32[nb] window starts
    length: torch.Tensor,  # i32[nb] window lengths
    thr2: float,
    block: int,
) -> torch.Tensor:
    """Per-block partials f32[nb, PARTIAL_WIDTH]; CUDA tensors launch the
    kernel (``block`` a power of two in [32, 256]), CPU tensors take the
    plain version."""
    nb = lo.shape[0]
    if pts.shape != (nb * block, 3) or qmask.shape != (nb * block,):
        raise ValueError("pts must be (nb*block, 3) and qmask (nb*block,)")
    if packed.ndim != 2 or packed.shape[0] != 6 or length.shape != (nb,):
        raise ValueError("packed must be (6, M) and length (nb,)")
    if not launches_kernel(pts, qmask, packed, lo, length):
        return icp_p2plane_stats_plain(pts, qmask, packed, lo, length, thr2,
                                       block)
    if block < 32 or block > 256 or block & (block - 1):
        raise ValueError(f"block must be a power of two in [32, 256], got {block}")
    fins = [x.contiguous() for x in (pts, qmask, packed)]
    if any(x.dtype != torch.float32 for x in fins):
        raise TypeError("icp_p2plane_stats kernel takes float32 coordinates")
    ints = [x.to(torch.int32).contiguous() for x in (lo, length)]
    out = torch.empty((nb, PARTIAL_WIDTH), dtype=torch.float32,
                      device=pts.device)
    rc = build.library().tpu3d_icp_p2plane_stats(
        *(x.data_ptr() for x in fins), *(x.data_ptr() for x in ints),
        packed.shape[1], nb, block, float(thr2), out.data_ptr(),
        torch.cuda.current_stream(pts.device).cuda_stream,
    )
    build.check(rc, "tpu3d_icp_p2plane_stats")
    build.count_launch(icp_p2plane_stats)
    return out


icp_p2plane_stats.launches = 0


def unpack_partials(parts: torch.Tensor):
    """Sum block partials → (ata (6,6), atb (6,), n_corr, sum_d2)."""
    s = parts.sum(0)
    ata = torch.zeros((6, 6), dtype=s.dtype, device=s.device)
    ata[_TRIU[0].to(s.device), _TRIU[1].to(s.device)] = s[:21]
    ata = ata + ata.T - torch.diag(torch.diagonal(ata))
    return ata, s[21:27], s[27], s[28]
