"""Fused slab-sweep surface features: normals + FPFH with no top-k.

Counterpart of ``tpu3d/ops/fused_features.py`` (``_pallas_prepare``,
``fused_prepare_sparse``, ``fused_prepare_features`` with both engines).
The Pallas engine's semantics run on the bucket-aligned layout of
``ops/slab2.py``:

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

``engine='xla'`` is the JAX package's ``lax.map`` formulation in plain
PyTorch (:func:`_xla_prepare`): the plain slab2 layout at bucket width 2r,
``block_windows`` per block of queries, the three sweeps as per-block
matmuls and threshold compares over each window's sub-tiles, each block
centred on its valid queries. It exists for API parity; 'auto' takes the
sweeps above on either device.

The neighbourhoods are radius-exact (every point within r), where the
reference caps them at 100 (registration.cpp:87); the gather route
(``ops/normals``, ``ops/fpfh``) keeps reference parity below
``FUSED_CAPACITY_THRESHOLD``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3d_torch.ops.features import (
    _BIN_THRESH,
    fpfh_sweep,
    moments_sweep,
    spfh_sweep,
)
from tpu3d_torch.ops.normals import smallest_eigvec_3x3
from tpu3d_torch.ops.slab2 import (
    AlignedSlab2,
    aligned_block_windows,
    block_windows,
    build_slab2,
    build_slab2_aligned,
)
from tpu3d_torch.types import FPFHFeatures, PointCloud
from tpu3d_torch.utils.profiling import span, spanned


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


@spanned("prepare.sparse")
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
    with span("prepare.fused"):
        return _pallas_prepare(cloud, r, r2, block,
                               nq=max(1, corr_cap // block))


@spanned("prepare.fused")
def fused_prepare_features(
    cloud: PointCloud,
    radius,
    block: int | None = None,
    sub: int | None = None,
    engine: str = "auto",
    k_windows: int | None = None,
) -> tuple[PointCloud, FPFHFeatures]:
    """Normals + FPFH for a cloud in original row order. 'auto'/'pallas':
    the Pallas engine's sweeps (``block`` 128 by default; ``sub`` is
    accepted for the JAX signature and ignored, as is ``k_windows``).
    'xla': the ``lax.map`` formulation (block 256, sub 512, k_windows 6
    by default; see the module docstring)."""
    if engine not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown engine {engine!r}")
    r = _f32(radius)
    r2 = float(np.float32(r) * np.float32(r))
    if engine == "xla":
        return _xla_prepare(cloud, r, r2, 256 if block is None else block,
                            512 if sub is None else sub,
                            6 if k_windows is None else k_windows)
    block = 128 if block is None else block
    return _pallas_prepare(cloud, r, r2, block)


# --------------------------------------------------------------------------
# The XLA engine (engine='xla')
# --------------------------------------------------------------------------

_BIG = 1e30
_XLA_GROUP_ELEMS = 1 << 21  # (blocks, B, sub) elements per tile step


def _window_scan(lo, length, m, sub, init, tile_fn):
    """``acc = tile_fn(rows, own, acc)`` over every sub-tile of every window
    [lo_k, lo_k + len_k) of a group of blocks (rows i64[G, sub] clamped
    into [0, m − sub], ``own`` the rows this sub-tile owns), windows in
    order, as the JAX ``_window_scan`` walks each block; a block past its
    last sub-tile owns nothing and adds zeros."""
    col = torch.arange(sub, device=lo.device)
    acc = init
    for k in range(lo.shape[1]):
        lo_k, len_k = lo[:, k].long(), length[:, k].long()
        for t in range(int(((len_k + sub - 1) // sub).max())):
            own_lo = lo_k + t * sub
            own_hi = lo_k + torch.clamp_max(len_k, (t + 1) * sub)
            start = torch.clamp(own_lo, 0, m - sub)
            rows = start[:, None] + col
            own = (rows >= own_lo[:, None]) & (rows < own_hi[:, None])
            acc = tile_fn(rows, own, acc)
    return acc


def _block_center(qc, qm):
    """Each block's origin: the mean of its valid queries (G, 3)."""
    wq = qm.to(torch.float32)[..., None]
    return (qc * wq).sum(1) / torch.clamp_min(wq.sum(1), 1.0)


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], -1)


def _xla_prepare(cloud: PointCloud, r: float, r2: float, block: int,
                 sub: int, k_windows: int):
    """The ``lax.map`` engine over groups of query blocks (see the module
    docstring): (cloud with normals, FPFHFeatures) in original row
    order."""
    slab = build_slab2(cloud.points, cloud.mask,
                       float(np.float32(2.0) * np.float32(r)))
    pts_t = slab.sorted_points_t  # (3, M) slab2 order
    pts = pts_t.T.contiguous()
    m = pts.shape[0]
    dev = pts.device
    pad = (-m) % block
    mb = torch.nn.functional.pad(slab.valid_sorted, (0, pad)).reshape(
        -1, block)
    sub = min(sub, m)
    qb = torch.cat([pts, torch.full((pad, 3), 2.9e4, device=dev)]).reshape(
        -1, block, 3)
    lo, length = block_windows(slab, qb, mb, r, k_max=k_windows)
    nb = qb.shape[0]
    group = max(1, _XLA_GROUP_ELEMS // (block * sub))

    def d2_planes(qc, rows):
        cand = pts[rows]  # (G, sub, 3)
        dx = cand[:, None, :, 0] - qc[:, :, 0:1]
        dy = cand[:, None, :, 1] - qc[:, :, 1:2]
        dz = cand[:, None, :, 2] - qc[:, :, 2:3]
        return cand, dx, dy, dz, dx * dx + dy * dy + dz * dz

    def by_groups(fn, *blocks):
        return torch.cat([fn(*(x[g:g + group] for x in blocks))
                          for g in range(0, nb, group)])

    # Sweep A: radius-PCA normals from the moments of the centred
    # neighbours.
    def normals_group(qc, qm, lo_g, len_g):
        g = qc.shape[0]
        center = _block_center(qc, qm)

        def tile(rows, own, acc):
            mom, cnt = acc
            cand, _, _, _, d2 = d2_planes(qc, rows)
            w = (own[:, None, :] & (d2 <= r2)).to(torch.float32)
            c = cand - center[:, None, :]
            feats = torch.cat([c, c * c, torch.stack([
                c[..., 0] * c[..., 1], c[..., 0] * c[..., 2],
                c[..., 1] * c[..., 2]], -1)], -1)  # (G, sub, 9)
            return mom + w @ feats, cnt + w.sum(2)

        mom, cnt = _window_scan(
            lo_g, len_g, m, sub,
            (torch.zeros((g, block, 9), device=dev),
             torch.zeros((g, block), device=dev)), tile)
        cnt = torch.clamp_min(cnt, 1.0)
        mu = mom[..., :3] / cnt[..., None]
        exx, eyy, ezz = (mom[..., i] / cnt for i in (3, 4, 5))
        exy, exz, eyz = (mom[..., i] / cnt for i in (6, 7, 8))
        cxy = exy - mu[..., 0] * mu[..., 1]
        cxz = exz - mu[..., 0] * mu[..., 2]
        cyz = eyz - mu[..., 1] * mu[..., 2]
        cov = torch.stack([
            torch.stack([exx - mu[..., 0] ** 2, cxy, cxz], -1),
            torch.stack([cxy, eyy - mu[..., 1] ** 2, cyz], -1),
            torch.stack([cxz, cyz, ezz - mu[..., 2] ** 2], -1),
        ], -2)
        nrm = smallest_eigvec_3x3(cov)
        flip = (nrm * (-qc)).sum(-1) < 0  # toward the viewpoint (origin)
        return torch.where(flip[..., None], -nrm, nrm)

    normals_blocks = by_groups(normals_group, qb, mb, lo, length)
    normals_sorted = normals_blocks.reshape(-1, 3)[:m]
    bxn = _cross(pts, normals_sorted)  # p × n, raw

    # Sweep B: SPFH histograms from matmul angles and threshold counts.
    thr = torch.tensor(_BIN_THRESH, dtype=torch.float32, device=dev)
    inv_pi = float(np.float32(1.0 / np.pi))

    def spfh_group(qc, qm, qn, lo_g, len_g):
        g = qc.shape[0]
        center = _block_center(qc, qm)
        ci = qc - center[:, None, :]
        bi = _cross(ci, qn)

        def tile(rows, own, acc):
            cum, cnt = acc
            cand, dx, dy, dz, d2 = d2_planes(qc, rows)
            nj = normals_sorted[rows]  # (G, sub, 3)
            cj = cand - center[:, None, :]
            bj = bxn[rows] - _cross(center[:, None, :].expand_as(nj), nj)
            aj = (cj * nj).sum(-1)  # (G, sub)
            njt = nj.transpose(1, 2)
            c = qn @ njt  # n_i·n_j
            pin = ci @ njt  # c_i·n_j
            anum = qn @ bj.transpose(1, 2) + bi @ njt  # alpha·d
            contrib = own[:, None, :] & (d2 <= r2) & (d2 >= 1e-16)
            inv_d = torch.rsqrt(torch.clamp_min(d2, 1e-24))
            phi = (qn[..., 0:1] * dx + qn[..., 1:2] * dy
                   + qn[..., 2:3] * dz) * inv_d
            e = (aj[:, None, :] - pin) * inv_d
            alpha = anum * inv_d
            theta = torch.atan2(phi * c - e, c)
            parts = [
                (torch.where(contrib, x, -_BIG)[..., None] >= thr).to(
                    torch.float32).sum(2)
                for x in (alpha, phi, theta * inv_pi)
            ]
            return (cum + torch.cat(parts, -1),
                    cnt + contrib.to(torch.float32).sum(2))

        cum, cnt = _window_scan(
            lo_g, len_g, m, sub,
            (torch.zeros((g, block, 30), device=dev),
             torch.zeros((g, block), device=dev)), tile)
        cols = []
        for a in range(3):
            ca = cum[..., a * 10:(a + 1) * 10]
            cols += [cnt[..., None] - ca[..., 0:1], ca[..., :-1] - ca[..., 1:],
                     ca[..., -1:]]
        hist = torch.cat(cols, -1)  # (G, B, 33)
        return _normalise_rows(hist)

    qn_blocks = torch.nn.functional.pad(
        normals_sorted, (0, 0, 0, pad)).reshape(-1, block, 3)
    spfh_sorted = by_groups(spfh_group, qb, mb, qn_blocks, lo,
                            length).reshape(-1, 33)[:m]

    # Sweep C: FPFH = own SPFH + Σ SPFH_j / d.
    def fpfh_group(qc, qs, lo_g, len_g):
        def tile(rows, own, f):
            _, _, _, _, d2 = d2_planes(qc, rows)
            contrib = own[:, None, :] & (d2 <= r2) & (d2 >= 1e-16)
            wgt = torch.where(contrib,
                              torch.rsqrt(torch.clamp_min(d2, 1e-24)), 0.0)
            return f + wgt @ spfh_sorted[rows]

        f = qs + _window_scan(lo_g, len_g, m, sub, torch.zeros_like(qs),
                              tile)
        return _normalise_rows(f)

    qs_blocks = torch.nn.functional.pad(
        spfh_sorted, (0, 0, 0, pad)).reshape(-1, block, 33)
    fpfh_sorted = by_groups(fpfh_group, qb, qs_blocks, lo,
                            length).reshape(-1, 33)[:m]

    # Slab order → original rows (a permutation), masked.
    normals = torch.zeros_like(normals_sorted)
    normals[slab.sorted_orig] = normals_sorted
    fpfh = torch.zeros_like(fpfh_sorted)
    fpfh[slab.sorted_orig] = fpfh_sorted
    normals = torch.where(cloud.mask[:, None], normals, 0.0)
    fpfh = torch.where(cloud.mask[:, None], fpfh, 0.0)
    return (cloud._replace(normals=normals),
            FPFHFeatures(descriptors=fpfh, mask=cloud.mask))


def _normalise_rows(h: torch.Tensor) -> torch.Tensor:
    """L1-normalised rows (zero rows stay zero), the XLA engine's sum."""
    s = h.sum(-1, keepdim=True)
    return torch.where(s > 0, h / torch.clamp_min(s, 1e-30), h)
