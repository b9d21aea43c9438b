"""RANSAC coarse registration: batches of hypotheses with an exact early exit.

Counterpart of ``tpu3d/ops/ransac.py`` (``decimation_stride``,
``build_scoring_factors``, ``pack_hypotheses``, ``build_rotation_table``,
``solve_rotation_chunk``, ``feature_correspondences`` and the chunked and
one-shot routes of ``ransac_registration``): 33-D descriptor nearest
neighbours (K5), 3-point samples solved by QCP, and rank-16 scoring (K6).
Two samplers, as in the JAX package: the gather-free rotation sampler
(chunked route, n ≥ 2,048) and the gather sampler (three independent
valid-row draws per hypothesis, duplicates disabled) below that and on the
one-shot route (``max_iterations`` ≤ the chunk size), which scores every
hypothesis at once. ``score_w16`` is
:func:`tpu3d_torch.ops.ransac_score.score_hypotheses`.

The JAX ``while_loop`` over chunks becomes a Python loop that reads one
flag back per chunk. The random draws come from an injectable
:class:`Draws` stream: :func:`torch_draws` by default; tests replay the
JAX stream.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from tpu3d_torch.device import launches_kernel
from tpu3d_torch.ops.nn import descriptor_targets, nearest_neighbor
from tpu3d_torch.ops.ransac_score import score_hypotheses
from tpu3d_torch.ops.transforms import (
    kabsch3_planes,
    kabsch_quat,
    make_transform,
)
from tpu3d_torch.types import FPFHFeatures, PointCloud, RegistrationResult


class Draws(Protocol):
    """The RANSAC draw stream.

    ``draws(chunk, epoch)`` is the rotation sampler's triple (u0, u1, u2),
    each in [0, 2**30). ``draws.triples(chunk, h, count)`` is the gather
    sampler's i64[h, 3] row draws in [0, count) (CPU), ``chunk`` None on
    the one-shot and the two-stage routes. ``draws.rows(n, count)`` is the
    two-stage route's stage-1 draw: i64[n] valid-row ranks in [0, count),
    with replacement (CPU). A plain function serves where only the
    rotation sampler runs."""

    def __call__(self, chunk: int, epoch: int) -> tuple[int, int, int]: ...

    def triples(self, chunk: int | None, h: int, count: int) -> torch.Tensor:
        ...

    def rows(self, n: int, count: int) -> torch.Tensor: ...


# Rows of the two-stage route's stage-1 estimate.
SUB_N = 16384


def hypothesis_chunk(max_iterations: int) -> int:
    """Hypotheses per chunk: a quarter of the budget, rounded up to 1,024,
    at least 16,384."""
    quarter = -(-max_iterations // 4)
    return max(16384, (quarter + 1023) // 1024 * 1024)


class TorchDraws:
    """Default draw stream: a seeded ``torch.Generator`` per (chunk, epoch),
    and per chunk for the gather sampler (a different stream from
    ``jax.random``, the same class of delta as any reseeding)."""

    def __init__(self, seed: int):
        self.seed = seed

    def _generator(self, chunk: int, epoch: int) -> torch.Generator:
        return torch.Generator().manual_seed(
            (self.seed * 1_000_003 + chunk) * 1_000_003 + epoch
        )

    def __call__(self, chunk: int, epoch: int) -> tuple[int, int, int]:
        u = torch.randint(0, 1 << 30, (3,),
                          generator=self._generator(chunk, epoch))
        return int(u[0]), int(u[1]), int(u[2])

    def triples(self, chunk: int | None, h: int, count: int) -> torch.Tensor:
        # Epoch −1 never occurs on the rotation side.
        g = self._generator(-1 if chunk is None else chunk, -1)
        return torch.randint(0, max(count, 1), (h, 3), generator=g)

    def rows(self, n: int, count: int) -> torch.Tensor:
        # Chunk −2 never occurs on either sampler's side.
        g = self._generator(-2, -1)
        return torch.randint(0, max(count, 1), (n,), generator=g)


def torch_draws(seed: int) -> TorchDraws:
    return TorchDraws(seed)


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


def pack_hypotheses(Rs, ts):
    """(h, 3, 3)/(h, 3) solutions → K-major (16, h) scoring factors
    [Rᵀt | t | vec(R) | 0] and ‖t‖²."""
    u = [(Rs[:, 0, j] * ts[:, 0] + Rs[:, 1, j] * ts[:, 1])
         + Rs[:, 2, j] * ts[:, 2] for j in range(3)]
    w16t = torch.stack(
        u + [ts[:, 0], ts[:, 1], ts[:, 2]]
        + [Rs[:, i, j] for i in range(3) for j in range(3)]
        + [torch.zeros_like(ts[:, 0])]
    )
    t_norm = (ts[:, 0] * ts[:, 0] + ts[:, 1] * ts[:, 1]) + ts[:, 2] * ts[:, 2]
    return w16t, t_norm


def solve_gather(triples, first_id, perm, pq_packed, max_iterations):
    """Gather sampling: hypothesis i takes the valid rows ``perm[triples[i]]``
    (three independent draws; a repeated draw disables it, as the
    reference rejects it), solved by QCP. Returns (w16t (16, h), t_norm
    (h,), disabled (h,))."""
    tri = triples.to(perm.device)
    h = tri.shape[0]
    dup = ((tri[:, 0] == tri[:, 1]) | (tri[:, 1] == tri[:, 2])
           | (tri[:, 0] == tri[:, 2]))
    ids = first_id + torch.arange(h, device=perm.device)
    disabled = dup | (ids >= max_iterations)
    s6 = pq_packed[perm[tri]]  # (h, 3, 6)
    Rs, ts = kabsch_quat(s6[..., :3], s6[..., 3:])
    w16t, t_norm = pack_hypotheses(Rs, ts)
    return w16t, t_norm, disabled


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


def with_target_operand(target_features: FPFHFeatures) -> FPFHFeatures:
    """``target_features`` with K5's packed target operand attached when
    they lie on the card, so that every :func:`feature_correspondences`
    against them packs only its queries. Call it once per target model."""
    d, m = target_features.descriptors, target_features.mask
    if target_features.nn_operand is not None or not launches_kernel(d, m):
        return target_features
    return target_features._replace(nn_operand=descriptor_targets(d, m))


def feature_correspondences(
    source_features: FPFHFeatures, target_features: FPFHFeatures
) -> torch.Tensor:
    """Nearest target row in 33-D descriptor space per source row (K5,
    fp32; ties to the lowest index)."""
    idx, _ = nearest_neighbor(
        source_features.descriptors,
        target_features.descriptors,
        target_features.mask,
        packed_targets=target_features.nn_operand,
    )
    return idx


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
    directly at the winner.

    Routes, as in the JAX package: with ``max_iterations`` above the chunk
    size, chunks of hypotheses until one exceeds (rotation sampling for
    ``hyp_chunk`` ≥ n ≥ 2,048, else the gather sampler), and for
    n ≥ 2·``est_cap`` the in-chunk estimate stage (every hypothesis scored
    on a strided ``est_cap``-row subset, the top 32 rescored exactly);
    otherwise one shot: ⌈max_iterations/512⌉·512 gather-sampled hypotheses
    scored at once. ``two_stage`` (True, or 'auto' with n ≥ 32,768 rows)
    replaces both: the one shot's hypotheses estimated on 16,384 rows drawn
    with replacement from the valid ones, the best 1,024 rescored exactly.

    ``corr_mode`` 'auto' or 'subsample' with n ≥ 2·``corr_cap``: exact
    correspondences for the strided ``corr_cap``-row subset of the source
    (row k·stride, ``decimation_stride``), which the hypotheses are drawn
    from and scored on; fitness normalises by the subset's valid count.
    'exact' matches every source row."""
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
    finalists = min(1024, h_total)
    if two_stage == "auto":
        two_stage = n >= 2 * SUB_N and h_total > 4 * finalists
    use_chunked = not two_stage and max_iterations > hyp_chunk
    use_rotation = use_chunked and hyp_chunk >= n >= 2048

    n_valid = max(float(src_mask.sum()), 1.0)
    count = max(int(n_valid), 1)
    corr = feature_correspondences(
        FPFHFeatures(src_desc, src_mask), target_features
    )
    p = src_pts.to(torch.float32)
    q = target.points[corr.long()].to(torch.float32)
    feat_t, pq_norm = build_scoring_factors(p, q, src_mask)
    pq_packed = torch.cat([p, q], dim=1)
    if use_rotation:
        pq2p = build_rotation_table(pq_packed, src_mask, count)
        # Every chunk consumes the same number of iterations at the cloud's
        # valid fraction: bound the loop by the chunks the budget needs.
        cons = (hyp_chunk // n) * count + min(hyp_chunk % n, count)
        n_chunks_bound = (max_iterations + cons - 1) // max(cons, 1)
    else:
        perm = torch.sort((~src_mask).to(torch.int8), stable=True)[1]
        n_chunks_bound = -(-max_iterations // hyp_chunk)

    def sample(c, first_id, h):
        """(w16t, t_norm, disabled, iterations consumed) of ``h``
        hypotheses from chunk ``c`` of the draw stream (None: one shot)."""
        if use_rotation:
            w16t, t_norm, disabled, _, n_cons = solve_rotation_chunk(
                lambda e: draws(c, e), h, first_id, pq2p, count,
                max_iterations)
            return w16t, t_norm, disabled, n_cons
        w16t, t_norm, disabled = solve_gather(
            draws.triples(c, h, count), first_id, perm, pq_packed,
            max_iterations)
        return w16t, t_norm, disabled, h

    if two_stage:
        rows = perm[draws.rows(SUB_N, count).to(perm.device)]
        bf, bw = _two_stage(sample(None, 0, h_total), feat_t, pq_norm, rows,
                            thr2, n_valid, confidence, finalists)
    elif not use_chunked:
        bf, bw = _one_shot(sample(None, 0, h_total), feat_t, pq_norm, thr2,
                           n_valid, confidence)
    else:
        bf, bw = _chunks(sample, hyp_chunk, n_chunks_bound, max_iterations,
                         confidence, thr2, n, count, n_valid, est_cap,
                         use_rotation, p, q, src_mask, feat_t, pq_norm)
    best_R = bw[6:15].reshape(3, 3)
    best_t = bw[3:6]
    return _rescore(p, q, src_mask, best_R, best_t, bf, thr2, n_valid)


def _one_shot(sampled, feat_t, pq_norm, thr2, n_valid, confidence):
    """Every hypothesis scored at once: (best fitness, best w16 column)."""
    w16t, t_norm, disabled, _ = sampled
    h_total = w16t.shape[1]
    cnt, _ = score_hypotheses(feat_t, pq_norm, w16t, t_norm, thr2)
    fitness = torch.where(disabled, -1.0, cnt / n_valid)
    exceed = fitness > confidence
    first = torch.argmax(exceed.to(torch.int8))  # first True
    cutoff = torch.where(exceed.any(), first, h_total - 1)
    h_ids = torch.arange(h_total, device=w16t.device)
    masked = torch.where(h_ids <= cutoff, fitness, -2.0)
    best = torch.argmax(masked, dim=0, keepdim=True)  # first of equals
    return fitness[best][0], w16t[:, best][:, 0]


def _two_stage(sampled, feat_t, pq_norm, rows, thr2, n_valid, confidence,
               finalists):
    """Stage 1 estimates every hypothesis on the drawn ``rows`` (fitness
    over their number), with the early-exit prefix on the estimates;
    stage 2 scores the best ``finalists`` exactly. (best fitness, best w16
    column)."""
    w16t, t_norm, disabled, _ = sampled
    h_total = w16t.shape[1]
    cnt1, _ = score_hypotheses(feat_t[:, rows].contiguous(), pq_norm[rows],
                               w16t, t_norm, thr2)
    fit1 = torch.where(disabled, -1.0, cnt1 / rows.shape[0])
    exceed = fit1 > confidence
    first = torch.argmax(exceed.to(torch.int8))  # first True
    cutoff = torch.where(exceed.any(), first, h_total - 1)
    h_ids = torch.arange(h_total, device=w16t.device)
    fit1 = torch.where(h_ids <= cutoff, fit1, -2.0)
    # lax.top_k order: descending, ties lowest index first.
    top = torch.sort(fit1, descending=True, stable=True)[1][:finalists]
    cnt2, _ = score_hypotheses(feat_t, pq_norm, w16t[:, top].contiguous(),
                               t_norm[top], thr2)
    fit2 = torch.where(fit1[top] <= -1.0, -1.0, cnt2 / n_valid)
    best = torch.argmax(fit2, dim=0, keepdim=True)  # first of equals
    return fit2[best][0], w16t[:, top[best]][:, 0]


def _chunks(sample, hyp_chunk, n_chunks_bound, max_iterations, confidence,
            thr2, n, count, n_valid, est_cap, use_rotation, p, q, src_mask,
            feat_t, pq_norm):
    """Chunks of ``hyp_chunk`` hypotheses until one exceeds ``confidence``
    or the budget is spent: (best fitness, best w16 column)."""
    device = p.device
    use_est = n >= 2 * est_cap
    if use_est:
        m_e = strided_rows(src_mask, est_cap)
        feat_e, pq_e = build_scoring_factors(
            strided_rows(p, est_cap), strided_rows(q, est_cap), m_e)
        n_valid_e = max(float(m_e.sum()), 1.0)
        k_fin = min(32, hyp_chunk)
    h_ids = torch.arange(hyp_chunk, device=device)

    def body(c, fid, bf, br, bw):
        w16t, t_norm, disabled, n_cons = sample(c, fid, hyp_chunk)
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
    # the bound and the early exit allow (count < 3 disables every
    # rotation triple).
    while c == 0 or (
        c < n_chunks_bound and fid < max_iterations and not done
        and (count >= 3 or not use_rotation)
    ):
        fid, done, bf, br, bw = body(c, fid, bf, br, bw)
        c += 1
    return bf, bw


def _rescore(p, q, src_mask, best_R, best_t, bf, thr2, n_valid):
    """The result at the winner; identity with fitness 0 when no hypothesis
    won."""
    device = p.device
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
