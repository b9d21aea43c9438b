"""RANSAC coarse registration: chunked hypotheses with an exact early exit.

Counterpart of ``tpu3d/ops/ransac.py`` (``decimation_stride``,
``build_scoring_factors``, ``build_rotation_table``,
``solve_rotation_chunk``, ``feature_correspondences`` and the chunked path
of ``ransac_registration``): 33-D descriptor nearest neighbours (K5),
gather-free rotation sampling, the plane-wise QCP solve, and rank-16
scoring (K6) chunk by chunk until a hypothesis exceeds ``confidence``.
``score_w16`` is :func:`tpu3d_torch.ops.ransac_score.score_hypotheses`.

The JAX ``while_loop`` over chunks becomes a Python loop that reads one
flag back per chunk. The per-(chunk, epoch) random triples come from an
injectable ``draws(chunk, epoch) -> (u0, u1, u2)`` callable, each in
[0, 2**30): :func:`torch_draws` by default; tests replay the JAX stream.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tpu3d_torch.ops.nn import nearest_neighbor
from tpu3d_torch.ops.ransac_score import score_hypotheses
from tpu3d_torch.ops.transforms import kabsch3_planes, make_transform
from tpu3d_torch.types import FPFHFeatures, PointCloud, RegistrationResult

Draws = Callable[[int, int], tuple[int, int, int]]

def hypothesis_chunk(max_iterations: int) -> int:
    """Hypotheses per chunk: a quarter of the budget, rounded up to 1,024,
    at least 16,384."""
    quarter = -(-max_iterations // 4)
    return max(16384, (quarter + 1023) // 1024 * 1024)


def torch_draws(seed: int) -> Draws:
    """Default draw stream: a seeded ``torch.Generator`` per (chunk, epoch)
    (a different stream from ``jax.random``, the same class of delta as any
    reseeding)."""

    def draw(chunk: int, epoch: int) -> tuple[int, int, int]:
        g = torch.Generator().manual_seed(
            (seed * 1_000_003 + chunk) * 1_000_003 + epoch
        )
        u = torch.randint(0, 1 << 30, (3,), generator=g)
        return int(u[0]), int(u[1]), int(u[2])

    return draw


def decimation_stride(n: int, cap: int) -> int:
    """Stride for strided decimation of ``n`` rows down to ``cap``, nudged
    away from raster-width factors 2 and 5 (only ever shrinks)."""
    stride = n // cap
    if stride > 2 and stride % 2 == 0:
        stride -= 1
    if stride > 5 and stride % 5 == 0:
        stride -= 2
    return stride


def strided_rows(x: torch.Tensor, cap: int) -> torch.Tensor:
    """Rows 0, s, 2s, … (``cap`` of them) with s = decimation_stride."""
    st = decimation_stride(x.shape[0], cap)
    return x[: st * cap : st]


def build_scoring_factors(p_, q_, mask_):
    """Point-side factors for err²[n,h] = F_n·W_h + pq_n + ‖t_h‖²: F as
    (16, N) K-major, pq with 1e30 on invalid rows."""
    px, py, pz = p_[:, 0], p_[:, 1], p_[:, 2]
    qx, qy, qz = q_[:, 0], q_[:, 1], q_[:, 2]
    pq = px * px + py * py + pz * pz + qx * qx + qy * qy + qz * qz
    pq = torch.where(mask_, pq, 1e30)
    ft = torch.stack(
        [
            2.0 * px, 2.0 * py, 2.0 * pz,
            -2.0 * qx, -2.0 * qy, -2.0 * qz,
            -2.0 * qx * px, -2.0 * qx * py, -2.0 * qx * pz,
            -2.0 * qy * px, -2.0 * qy * py, -2.0 * qy * pz,
            -2.0 * qz * px, -2.0 * qz * py, -2.0 * qz * pz,
            torch.zeros_like(px),
        ]
    )
    return ft.contiguous(), pq


def build_rotation_table(pq_packed, src_mask, count: int):
    """(6, 2n) plane table: valid rows first (stable), then a second copy
    starting at column ``count``, so columns [r, r + n) read row
    (i + r) mod count at position i for any r < count."""
    _, order = torch.sort((~src_mask).to(torch.int8), stable=True)
    pq_sorted_t = pq_packed[order].T
    n = pq_sorted_t.shape[1]
    table = torch.zeros((6, 2 * n), dtype=pq_sorted_t.dtype,
                        device=pq_sorted_t.device)
    table[:, :n] = pq_sorted_t
    table[:, count:count + n] = pq_sorted_t
    return table


def solve_rotation_chunk(draw, h, first_id, pq2p, count, max_iterations):
    """Gather-free 3-point sampling over ceil(h/n) epochs; epoch e pairs
    valid row i with rows (i + r1) mod count and (i + r2) mod count, from
    ``draw(e)``. Returns (w16t (16, h), t_norm (h,), disabled (h,),
    ids (h,), n_consumed): each valid triple consumes one iteration id."""
    n = pq2p.shape[1] // 2
    n_ep = -(-h // n)
    cm1 = max(count - 1, 1)
    cm2 = max(count - 2, 1)
    slots1, slots2, slots3 = [], [], []
    for e in range(n_ep):
        u0, u1, u2 = draw(e)
        a = u0 % cm1
        r1 = 1 + a
        r2 = 1 + (a + 1 + u1 % cm2) % cm1
        r0 = u2 % max(count, 1)
        for slots, r in ((slots1, r0), (slots2, (r0 + r1) % count),
                         (slots3, (r0 + r2) % count)):
            slots.append(pq2p[:, r:r + n])
    s1t = torch.cat(slots1, dim=1)[:, :h]
    s2t = torch.cat(slots2, dim=1)[:, :h]
    s3t = torch.cat(slots3, dim=1)[:, :h]
    valid1 = torch.arange(n, device=pq2p.device) < count
    vv = valid1.repeat(n_ep)[:h]
    ids = first_id + torch.cumsum(vv.to(torch.int32), 0) - 1
    # count < 3: no 3-point sample exists; every triple is disabled.
    disabled = (~vv) | (ids >= max_iterations) | (count < 3)
    ps = tuple((st[0], st[1], st[2]) for st in (s1t, s2t, s3t))
    qs = tuple((st[3], st[4], st[5]) for st in (s1t, s2t, s3t))
    r_pl, t_pl = kabsch3_planes(ps, qs)
    u = tuple(
        r_pl[j] * t_pl[0] + r_pl[3 + j] * t_pl[1] + r_pl[6 + j] * t_pl[2]
        for j in range(3)
    )
    w16t = torch.stack(
        list(u) + list(t_pl) + list(r_pl) + [torch.zeros_like(t_pl[0])]
    )
    t_norm = t_pl[0] * t_pl[0] + t_pl[1] * t_pl[1] + t_pl[2] * t_pl[2]
    n_consumed = (h // n) * count + min(h % n, count)
    return w16t, t_norm, disabled, ids, n_consumed


def feature_correspondences(
    source_features: FPFHFeatures, target_features: FPFHFeatures
) -> torch.Tensor:
    """Nearest target row in 33-D descriptor space per source row (K5,
    fp32; ties to the lowest index)."""
    idx, _ = nearest_neighbor(
        source_features.descriptors,
        target_features.descriptors,
        target_features.mask,
    )
    return idx


def _not_ported(what: str):
    return NotImplementedError(
        f"RANSAC {what} is not ported yet (ROADMAP.md queue 1, item 6: RANSAC)"
    )


def ransac_registration(
    source: PointCloud,
    target: PointCloud,
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    voxel_size: float,
    max_iterations: int = 100000,
    confidence: float = 0.999,
    seed: int = 42,
    two_stage: str | bool = "auto",
    corr_cap: int = 8192,
    corr_mode: str = "auto",
    est_cap: int = 2048,
    draws: Draws | None = None,
) -> RegistrationResult:
    """Coarse pose: the best hypothesis in the prefix that ends at the first
    one whose fitness exceeds ``confidence``, with fitness/rmse rescored
    directly at the winner. Ports the chunked route with rotation sampling
    and, for n ≥ 2·``est_cap``, the in-chunk estimate stage (every
    hypothesis scored on a strided ``est_cap``-row subset, the top 32
    rescored exactly).

    ``corr_mode`` 'auto' or 'subsample' with n ≥ 2·``corr_cap``: exact
    correspondences for the strided ``corr_cap``-row subset of the source
    (row k·stride, ``decimation_stride``), which the hypotheses are drawn
    from and scored on; fitness normalises by the subset's valid count.
    'exact' matches every source row."""
    device = source.points.device
    if draws is None:
        draws = torch_draws(seed)
    v32 = np.float32(voxel_size)
    thr2 = float((v32 * np.float32(1.5)) ** 2)  # strict < on err²
    n = source.capacity
    hyp_chunk = hypothesis_chunk(max_iterations)
    src_pts = source.points
    src_mask = source.mask
    src_desc = source_features.descriptors
    if corr_mode in ("subsample", "auto") and n >= 2 * corr_cap:
        stride = decimation_stride(n, corr_cap)
        src_pts, src_mask, src_desc = (
            x[: stride * corr_cap : stride]
            for x in (src_pts, src_mask, src_desc)
        )
        n = corr_cap
    h_total = -(-max_iterations // 512) * 512
    if two_stage == "auto":
        two_stage = n >= 2 * 16384 and h_total > 4 * min(1024, h_total)
    if two_stage:
        raise _not_ported("two-stage scoring")
    if not max_iterations > hyp_chunk:
        raise _not_ported("one-shot scoring with the gather sampler")
    if not hyp_chunk >= n >= 2048:
        raise _not_ported("the gather sampler (below 2,048 rows)")

    n_valid = max(float(src_mask.sum()), 1.0)
    count = max(int(n_valid), 1)
    corr = feature_correspondences(
        FPFHFeatures(src_desc, src_mask), target_features
    )
    p = src_pts.to(torch.float32)
    q = target.points[corr.long()].to(torch.float32)
    feat_t, pq_norm = build_scoring_factors(p, q, src_mask)
    pq2p = build_rotation_table(torch.cat([p, q], dim=1), src_mask, count)

    cons = (hyp_chunk // n) * count + min(hyp_chunk % n, count)
    n_chunks_bound = (max_iterations + cons - 1) // max(cons, 1)
    use_est = n >= 2 * est_cap
    if use_est:
        m_e = strided_rows(src_mask, est_cap)
        feat_e, pq_e = build_scoring_factors(
            strided_rows(p, est_cap), strided_rows(q, est_cap), m_e)
        n_valid_e = max(float(m_e.sum()), 1.0)
        k_fin = min(32, hyp_chunk)
    h_ids = torch.arange(hyp_chunk, device=device)

    def body(c, fid, bf, br, bw):
        w16t, t_norm, disabled, _, n_cons = solve_rotation_chunk(
            lambda e: draws(c, e), hyp_chunk, fid, pq2p, count, max_iterations
        )
        if use_est:
            cnt_e, _ = score_hypotheses(feat_e, pq_e, w16t, t_norm, thr2)
            fitness = torch.where(disabled, -1.0, cnt_e / n_valid_e)
        else:
            cnt, errsum = score_hypotheses(feat_t, pq_norm, w16t, t_norm, thr2)
            fitness = torch.where(disabled, -1.0, cnt / n_valid)
        exceed = fitness > confidence
        any_ex = exceed.any()
        first = torch.argmax(exceed.to(torch.int8))  # first True
        cutoff = torch.where(any_ex, first, hyp_chunk - 1)
        mf = torch.where(h_ids <= cutoff, fitness, -2.0)
        if use_est:
            # lax.top_k order: descending, ties lowest index first.
            topk = torch.sort(mf, descending=True, stable=True)[1][:k_fin]
            cnt_x, err_x = score_hypotheses(
                feat_t, pq_norm, w16t[:, topk].contiguous(), t_norm[topk], thr2
            )
            fit_x = torch.where(mf[topk] <= -1.0, mf[topk], cnt_x / n_valid)
            # Indices stay (1,) tensors: indexing with a 0-d tensor would
            # read it back to the host.
            bi = torch.argmax(fit_x, dim=0, keepdim=True)
            lb, lf, lc, le = topk[bi], fit_x[bi], cnt_x[bi], err_x[bi]
        else:
            # first of equals == strict >
            lb = torch.argmax(mf, dim=0, keepdim=True)
            lf, lc, le = mf[lb], cnt[lb], errsum[lb]
        lf, lc, le = lf[0], lc[0], le[0]
        lr = torch.where(
            lc > 0, torch.sqrt(le / torch.clamp_min(lc, 1.0)), 999.0
        )
        better = lf > bf  # strict: the earliest chunk keeps ties
        return (
            fid + n_cons,
            bool(any_ex),  # the chunk's one device→host sync
            torch.where(better, lf, bf),
            torch.where(better, lr, br),
            torch.where(better, w16t[:, lb][:, 0], bw),
        )

    bf = torch.zeros((), dtype=torch.float32, device=device)
    br = torch.zeros((), dtype=torch.float32, device=device)
    bw = torch.zeros((16,), dtype=torch.float32, device=device)
    bw[6:15] = torch.eye(3, dtype=torch.float32, device=device).reshape(9)
    fid, done, c = 0, False, 0
    # Chunk 1 always runs (the JAX peel); later chunks while the budget,
    # the bound and the early exit allow.
    while c == 0 or (
        c < n_chunks_bound and fid < max_iterations and not done
        and count >= 3
    ):
        fid, done, bf, br, bw = body(c, fid, bf, br, bw)
        c += 1
    best_R = bw[6:15].reshape(3, 3)
    best_t = bw[3:6]

    # Direct rescore of the single winner: the reported fitness/rmse come
    # from the plain residual, not the rank-16 expansion.
    dr = p @ best_R.T + best_t - q
    err2_d = (dr * dr).sum(1)
    inl_d = src_mask & (err2_d < thr2)
    cnt_d = inl_d.to(torch.float32).sum()
    won = (bf > 0.0) & (cnt_d > 0)
    fit_d = cnt_d / n_valid
    rmse_d = torch.where(
        cnt_d > 0,
        torch.sqrt(
            torch.where(inl_d, err2_d, 0.0).sum() / torch.clamp_min(cnt_d, 1.0)
        ),
        999.0,
    )
    T = make_transform(best_R, best_t)
    eye = torch.eye(4, dtype=torch.float32, device=device)
    return RegistrationResult(
        transformation=torch.where(won, T, eye),
        fitness=torch.where(won, fit_d, 0.0),
        rmse=torch.where(won, rmse_d, 0.0),
    )
