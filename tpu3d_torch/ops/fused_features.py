"""Fused slab-sweep surface features: normals + FPFH with no top-k.

Counterpart of ``tpu3d/ops/fused_features.py`` (``_pallas_prepare``,
``fused_prepare_sparse``, ``fused_prepare_features``), Pallas-engine
semantics only, on the bucket-aligned layout of ``ops/slab2.py``:

  sweep A (K2) radius-PCA normals, moments on raw coordinates;
  sweep B (K3) SPFH histograms on centroid-shifted coordinates;
  sweep C (K4) FPFH = own SPFH + Σ SPFH_j / d over the radius neighbours,
  combined and L1-normalised here.

Dense mode (``nq=None``) returns (cloud with normals, FPFH) in original row
order. Sparse mode computes descriptors only for ``nq`` query blocks in
evenly strided contiguous runs: sweep C runs on those blocks, sweep B on
them and the blocks their windows reach, sweep A on that set and the
blocks its windows reach; every other block's window lengths are zeroed.
Sweeps A and B launch on the blocks with a live window, found on the
device, and sweep C on the query blocks alone. Each retained descriptor
equals the dense value at the same ``block``.

The neighbourhoods are radius-exact (every point within r), where the
reference caps them at 100 (registration.cpp:87); the gather route
(``ops/normals``, ``ops/fpfh``) keeps reference parity below
``FUSED_CAPACITY_THRESHOLD``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3d_torch.ops.features import fpfh_sweep, moments_sweep, spfh_sweep
from tpu3d_torch.ops.slab2 import (
    AlignedSlab2,
    aligned_block_windows,
    build_slab2_aligned,
)
from tpu3d_torch.types import FPFHFeatures, PointCloud


def _f32(x) -> float:
    return float(np.float32(float(x)))


def aligned_layout(cloud: PointCloud, r: float, block: int):
    """The aligned slab2 layout of ``cloud`` and its (lo, len) windows."""
    n = cloud.points.shape[0]
    # Enough buckets that the width stays ~r at density; it only widens
    # when the x-extent needs more.
    max_buckets = 128 if n <= (1 << 18) else 512
    al = build_slab2_aligned(cloud.points, cloud.mask, r, block=block,
                             max_buckets=max_buckets)
    lo, length = aligned_block_windows(al, r, block)
    return al, lo, length


def sparse_runs(nbk: int, nq: int) -> tuple[int, int, int, int]:
    """(q_run, nruns, run_stride, start0): ``nq`` query blocks as whole
    contiguous runs of ``q_run``, at least 4 runs when the budget allows,
    each centred in its stratum of the ``nbk`` blocks (host integers)."""
    nq = min(nq, nbk)
    q_run = min(8, max(1, nq // 4))
    nruns = max(1, nq // q_run)
    run_stride = max(q_run, nbk // nruns)
    start0 = min(
        (run_stride - q_run) // 2,
        max(0, nbk - ((nruns - 1) * run_stride + q_run)),
    )
    return q_run, nruns, run_stride, start0


def query_blocks(nbk: int, nq: int) -> np.ndarray:
    """The sparse prepare's query-block ids (numpy, ascending): the runs of
    :func:`sparse_runs`."""
    q_run, nruns, run_stride, start0 = sparse_runs(nbk, nq)
    return (start0 + np.arange(nruns)[:, None] * run_stride
            + np.arange(q_run)[None]).ravel()


def member_lengths(lo, length, block: int, nq: int):
    """Sparse member sets → the window lengths of sweeps A, B and C, and the
    query runs. Coverage of each live window's block range is a difference
    array (+1 at its first block, −1 after its last)."""
    nbk = lo.shape[0]
    dev = lo.device
    q_run, nruns, run_stride, start0 = sparse_runs(nbk, nq)
    take_ids = query_blocks(nbk, nq)
    qmask_np = np.zeros((nbk,), bool)
    qmask_np[take_ids] = True
    qmask = torch.from_numpy(qmask_np).to(dev)
    live = length > 0
    lo64 = lo.long()
    blk_lo = (lo64 // block).clamp(0, nbk - 1)
    blk_hi = ((lo64 + torch.clamp_min(length.long(), 1) - 1) // block).clamp(
        0, nbk - 1)

    def dilate(member):
        sel = (live & member[:, None]).reshape(-1)
        diff = torch.zeros((nbk + 1,), dtype=torch.int32, device=dev)
        ones = sel.to(torch.int32)
        diff.index_add_(0, blk_lo.reshape(-1), ones)
        diff.index_add_(0, blk_hi.reshape(-1) + 1, -ones)
        return torch.cumsum(diff, 0)[:nbk] > 0

    member_b = dilate(qmask) | qmask
    member_a = dilate(member_b) | member_b
    len_a = torch.where(member_a[:, None], length, 0)
    len_b = torch.where(member_b[:, None], length, 0)
    len_c = torch.where(qmask[:, None], length, 0)
    return len_a, len_b, len_c, (q_run, nruns, run_stride, start0)


def moments_operands(al: AlignedSlab2) -> torch.Tensor:
    """Sweep A's (and C's) query operand q8: raw xyz planes, validity."""
    mp = al.padded_points_t.shape[1]
    mrow = al.valid_padded.to(torch.float32)[None]
    return torch.cat([
        al.padded_points_t, mrow,
        torch.zeros((4, mp), dtype=torch.float32, device=mrow.device),
    ])


def spfh_operands(al: AlignedSlab2, nrm8: torch.Tensor):
    """Sweep B's (q8n, packed10): coordinates shifted by the cloud's masked
    centroid (so the scalar-triple identity α·d = n_i·b_j + b_i·n_j keeps
    its f32 error ~ extent, not ~ |p|, in any world frame), the normals,
    b = p × n and a = p·n."""
    pts_t = al.padded_points_t
    wv = al.valid_padded.to(torch.float32)
    cnt_v = torch.clamp_min(wv.sum(), 1.0)
    ctr = torch.stack([torch.where(al.valid_padded, pts_t[i], 0.0).sum()
                       for i in range(3)]) / cnt_v
    c = pts_t - ctr[:, None]  # padding sentinels stay ~3e4, still inert
    n = nrm8[:3]
    b3 = torch.stack([
        c[1] * n[2] - c[2] * n[1],
        c[2] * n[0] - c[0] * n[2],
        c[0] * n[1] - c[1] * n[0],
    ])
    arow = c[0] * n[0] + c[1] * n[1] + c[2] * n[2]
    packed_b = torch.cat([c, b3, n, arow[None]]).contiguous()
    q8n = torch.cat([c, wv[None], n, torch.zeros_like(wv)[None]]).contiguous()
    return q8n, packed_b


def fpfh_operands(al: AlignedSlab2, spfh40: torch.Tensor) -> torch.Tensor:
    """Sweep C's packed36: raw xyz planes and the 33 SPFH planes."""
    return torch.cat([al.padded_points_t, spfh40[:33]]).contiguous()


def _row_sum(f: torch.Tensor) -> torch.Tensor:
    """Σ over the 33 columns left to right, the same order whatever the
    row count (dense and sparse rows must normalise identically)."""
    s = f[:, 0]
    for k in range(1, f.shape[1]):
        s = s + f[:, k]
    return s[:, None]


def _normalise(f: torch.Tensor) -> torch.Tensor:
    s = _row_sum(f)
    return torch.where(s > 0, f / torch.clamp_min(s, 1e-30), f)


def _pallas_prepare(cloud: PointCloud, r: float, r2: float, block: int,
                    nq: int | None = None):
    """The sweep engine (see the module docstring). Dense returns
    (cloud with normals, FPFHFeatures); sparse returns (subset PointCloud
    view, subset FPFHFeatures, subset original rows)."""
    al, lo, length = aligned_layout(cloud, r, block)
    pts_t = al.padded_points_t
    if nq is None:
        len_a = len_b = len_c = length
        blocks = None
    else:
        len_a, len_b, len_c, runs = member_lengths(lo, length, block, nq)
        # Sweep C runs on the query blocks alone.
        blocks = torch.from_numpy(
            query_blocks(lo.shape[0], nq).astype(np.int32)).to(lo.device)

    q8 = moments_operands(al)
    # Sparse mode: rows outside the A-set get a zero-covariance
    # eigenvector — finite, and never read (sweep B's windows only reach
    # A-set rows). Sweeps A and B then launch on the live blocks alone.
    sparse = nq is not None
    nrm8 = moments_sweep(q8, pts_t, lo, len_a, r2, block, sparse=sparse)
    q8n, packed_b = spfh_operands(al, nrm8)
    spfh40 = spfh_sweep(q8n, packed_b, lo, len_b, r2, block, sparse=sparse)
    spfh_planes = spfh40[:33]
    wsum = fpfh_sweep(q8, fpfh_operands(al, spfh40), lo, len_c, r2,
                      block, blocks=blocks)[:, :33]

    if nq is not None:
        q_run, nruns, run_stride, start0 = runs
        starts = [start0 + i * run_stride for i in range(nruns)]
        rows = torch.cat([
            torch.arange(s * block, (s + q_run) * block, device=pts_t.device)
            for s in starts
        ])  # the Q blocks' rows, the blocks the member sets marked
        sub_mask = al.valid_padded[rows]
        sub_pts = torch.where(sub_mask[:, None], pts_t[:, rows].T, 0.0)
        f = (spfh_planes[:, rows].T + wsum[rows]).contiguous()
        sub_desc = torch.where(sub_mask[:, None], _normalise(f), 0.0)
        return (
            PointCloud(points=sub_pts.contiguous(), mask=sub_mask),
            FPFHFeatures(descriptors=sub_desc, mask=sub_mask),
            al.padded_orig[rows],
        )

    # Dense: combine and normalise every padded row, then back to original
    # rows: padded_orig is a permutation plus unique out-of-bounds values
    # on padding rows, which the scatter drops.
    n = cloud.points.shape[0]
    f = (spfh_planes.T + wsum).contiguous()
    fpfh_padded = _normalise(f)
    keep = al.padded_orig < n
    dst = al.padded_orig[keep]
    normals = torch.zeros((n, 3), dtype=torch.float32, device=pts_t.device)
    normals[dst] = nrm8[:3].T[keep]
    fpfh = torch.zeros((n, 33), dtype=torch.float32, device=pts_t.device)
    fpfh[dst] = fpfh_padded[keep]
    normals = torch.where(cloud.mask[:, None], normals, 0.0)
    fpfh = torch.where(cloud.mask[:, None], fpfh, 0.0)
    return (
        cloud._replace(normals=normals),
        FPFHFeatures(descriptors=fpfh, mask=cloud.mask),
    )


def fused_prepare_sparse(
    cloud: PointCloud,
    radius,
    corr_cap: int = 8192,
    block: int = 256,
    sub: int = 256,
) -> tuple[PointCloud, FPFHFeatures, torch.Tensor]:
    """Normals + FPFH restricted to a ``corr_cap``-row subset of strided
    block runs: returns (subset PointCloud view, subset FPFHFeatures,
    subset original rows). Every returned descriptor equals the dense
    path's value for that row at the same ``block``. Pass the view to
    ``ransac_registration(..., corr_mode='exact')``. ``block=256`` halves
    the live window count against the dense path's 128; ``sub`` is
    accepted for the JAX signature and ignored."""
    del sub
    r = _f32(radius)
    r2 = float(np.float32(r) * np.float32(r))
    return _pallas_prepare(cloud, r, r2, block, nq=max(1, corr_cap // block))


def fused_prepare_features(
    cloud: PointCloud,
    radius,
    block: int | None = None,
    sub: int | None = None,
    engine: str = "auto",
) -> tuple[PointCloud, FPFHFeatures]:
    """Normals + FPFH for a cloud in original row order, by the Pallas
    engine's sweeps (``block`` 128 by default; ``sub`` is accepted for the
    JAX signature and ignored). ``engine='xla'`` (the JAX package's
    lax.map layout) is not ported."""
    del sub
    if engine not in ("auto", "pallas"):
        raise NotImplementedError(
            f"fused_prepare_features engine={engine!r} is not ported yet "
            "(ROADMAP.md queue 1, item 8: the XLA sweep engine)"
        )
    block = 128 if block is None else block
    r = _f32(radius)
    r2 = float(np.float32(r) * np.float32(r))
    return _pallas_prepare(cloud, r, r2, block)
