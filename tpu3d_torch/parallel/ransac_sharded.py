"""RANSAC over a device mesh: sharded descriptor NN and sharded hypotheses.

Counterpart of ``tpu3d/parallel/ransac_sharded.py``:

  1. **Feature correspondences**: the target descriptors are row-sharded,
     each shard runs K5 on its rows and the global winner is the argmin
     over the gathered (n_shards, Q) distances.
  2. **Hypotheses**: rounds of the single-device chunk (``hyp_chunk``,
     the budget of one round), each shard solving and scoring
     ``ceil(hyp_chunk / n_shards)`` of them (rotation table or gather
     draws, estimate scoring on the strided ``est_cap`` subset and an
     exact rescore of its top 32 by K6). Per round, two collectives
     restore the sequential prefix semantics: the cutoff is the least
     first confidence-exceeding global id over the shards, and the round
     champion the best fitness among ids ≤ cutoff with the earliest id
     breaking ties. The loop reads one flag back per round.
  3. **Direct winner rescore** outside the mesh, as on one device.

Shard ``s`` of round ``c`` draws chunk ``c·n_shards + s`` of the
:class:`~tpu3d_torch.ops.ransac.Draws` stream: the JAX package keys it
``fold_in(fold_in(PRNGKey(seed), 7), c·n_shards + s)``, so a replayed
stream reproduces its hypotheses shard for shard.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3d_torch.ops.nn import nearest_neighbor
from tpu3d_torch.ops.ransac import (
    Draws,
    _rescore,
    build_rotation_table,
    build_scoring_factors,
    decimation_stride,
    hypothesis_chunk,
    solve_gather,
    solve_rotation_chunk,
    strided_rows,
    torch_draws,
)
from tpu3d_torch.ops.ransac_score import score_hypotheses
from tpu3d_torch.parallel.mesh import (
    Mesh,
    all_gather,
    axis_index,
    for_shards,
    psum,
    shard_rows_of,
)
from tpu3d_torch.parallel.sharded_nn import global_top1
from tpu3d_torch.types import FPFHFeatures, PointCloud

_INT_MAX = 2**31 - 1


def feature_correspondences_sharded(
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    mesh: Mesh,
    axis: str = "shard",
) -> torch.Tensor:
    """Nearest 33-D target descriptor per source row, the targets
    row-sharded (K5 per shard): global target rows, i32[Q]. Ties go to
    the lowest global row, as on one device."""
    td = shard_rows_of(target_features.descriptors, mesh, axis)
    tm = shard_rows_of(target_features.mask, mesh, axis)
    per = for_shards(mesh, axis, nearest_neighbor,
                     source_features.descriptors, td, tm)
    return global_top1(per, td.shard_rows)[0]


def ransac_registration_sharded(
    source: PointCloud,
    target: PointCloud,
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    voxel_size,
    mesh: Mesh,
    axis: str = "shard",
    max_iterations: int = 100000,
    confidence: float = 0.999,
    seed: int = 42,
    corr_cap: int = 8192,
    corr_mode: str = "auto",
    hyp_chunk: int | str = "auto",
    est_cap: int = 2048,
    sampling: str = "auto",
    return_consumed: bool = False,
    draws: Draws | None = None,
):
    """Distributed :func:`~tpu3d_torch.ops.ransac.ransac_registration`
    (see the module docstring). ``hyp_chunk`` is the global budget of a
    round; ``return_consumed`` also returns the iteration ids consumed.
    ``draws`` replaces the draw stream (shard s of round c reads chunk
    c·n_shards + s)."""
    if draws is None:
        draws = torch_draws(seed)
    v32 = np.float32(voxel_size)
    thr2 = float((v32 * np.float32(1.5)) ** 2)
    n_shards = mesh.shape[axis]
    if hyp_chunk == "auto":
        hyp_chunk = hypothesis_chunk(max_iterations)
    hyp_l = -(-hyp_chunk // n_shards)  # a shard's slice of a round

    src_pts, src_mask = source.points, source.mask
    src_desc = source_features.descriptors
    n = src_pts.shape[0]
    if corr_mode in ("subsample", "auto") and n >= 2 * corr_cap:
        stride = decimation_stride(n, corr_cap)
        src_pts, src_mask, src_desc = (
            x[: stride * corr_cap: stride]
            for x in (src_pts, src_mask, src_desc))
        n = corr_cap

    corr = feature_correspondences_sharded(
        FPFHFeatures(src_desc, src_mask), target_features, mesh, axis)
    p = src_pts.to(torch.float32)
    q = target.points[corr.long().to(target.points.device)].to(
        torch.float32).to(p.device)
    n_valid = max(float(src_mask.sum()), 1.0)
    count = max(int(src_mask.sum()), 1)
    feat_t, pq_norm = build_scoring_factors(p, q, src_mask)
    perm = torch.sort((~src_mask).to(torch.int8), stable=True)[1]
    pq_packed = torch.cat([p, q], dim=1)
    use_rotation = n >= 2048 if sampling == "auto" else (
        sampling == "rotation")
    pq2p = (build_rotation_table(pq_packed, src_mask, count)
            if use_rotation else None)
    # Ids a shard consumes per round: full epochs `count` each, the tail
    # min(rem, count).
    cons = ((hyp_l // n) * count + min(hyp_l % n, count)
            if use_rotation else hyp_l)
    use_est = n >= 2 * est_cap
    if use_est:
        m_e = strided_rows(src_mask, est_cap)
        feat_e, pq_e = build_scoring_factors(
            strided_rows(p, est_cap), strided_rows(q, est_cap), m_e)
        n_valid_e = max(float(m_e.sum()), 1.0)
        k_fin = min(32, hyp_l)
    else:
        feat_e = pq_e = None

    def solve(c, fid, feat_l, pq_l, feat_el, pq_el, pq2p_l, perm_l, pqp_l):
        """Phase 1 of a round on one shard: its hypotheses, their
        (estimate) fitness and its first exceeding id."""
        sid = axis_index()
        chunk = c * n_shards + sid
        first_id = fid + sid * cons
        if use_rotation:
            w16t, t_norm, disabled, ids, _ = solve_rotation_chunk(
                lambda e: draws(chunk, e), hyp_l, first_id, pq2p_l, count,
                max_iterations)
        else:
            w16t, t_norm, disabled = solve_gather(
                draws.triples(chunk, hyp_l, count), first_id, perm_l, pqp_l,
                max_iterations)
            ids = first_id + torch.arange(hyp_l, device=w16t.device)
        if use_est:
            cnt, _ = score_hypotheses(feat_el, pq_el, w16t, t_norm, thr2)
            fitness = torch.where(disabled, -1.0, cnt / n_valid_e)
        else:
            cnt, _ = score_hypotheses(feat_l, pq_l, w16t, t_norm, thr2)
            fitness = torch.where(disabled, -1.0, cnt / n_valid)
        exceed = fitness > confidence
        first = torch.argmax(exceed.to(torch.int8), dim=0, keepdim=True)
        loc_first = torch.where(exceed.any(), ids[first][0].to(torch.int64),
                                _INT_MAX)
        return w16t, t_norm, ids, fitness, loc_first

    def champion(cutoff, feat_l, pq_l, w16t, t_norm, ids, fitness):
        """Phase 2 on one shard: the best fitness among ids ≤ cutoff
        (exact after the estimate top-k rescore) and its global id."""
        mf = torch.where(ids <= cutoff, fitness, -2.0)
        if use_est:
            # lax.top_k order: descending, ties lowest index first.
            topk = torch.sort(mf, descending=True, stable=True)[1][:k_fin]
            cnt_x, _ = score_hypotheses(feat_l, pq_l,
                                        w16t[:, topk].contiguous(),
                                        t_norm[topk], thr2)
            fit_x = torch.where(mf[topk] <= -1.0, mf[topk], cnt_x / n_valid)
            bi = torch.argmax(fit_x, dim=0, keepdim=True)
            lb, lf = topk[bi], fit_x[bi]
        else:
            lb = torch.argmax(mf, dim=0, keepdim=True)  # first of equals
            lf = mf[lb]
        return lf[0], ids[lb][0].to(torch.int64), w16t[:, lb][:, 0]

    lead = p.device
    bf = torch.zeros((), dtype=torch.float32, device=lead)
    bw = torch.zeros((16,), dtype=torch.float32, device=lead)
    bw[6:15] = torch.eye(3, dtype=torch.float32, device=lead).reshape(9)
    c, fid, done = 0, 0, False
    shared = (feat_t, pq_norm, feat_e, pq_e, pq2p, perm, pq_packed)
    while (fid < max_iterations and not done
           and (count >= 3 or not use_rotation)):
        sol = for_shards(mesh, axis, lambda *a: solve(c, fid, *a), *shared)
        # Collective 1: the global prefix cutoff.
        cutoff = all_gather([s[4] for s in sol]).min()

        def phase2(cut, feat_l, pq_l):
            w16t, t_norm, ids, fitness, _ = sol[axis_index()]
            return champion(cut, feat_l, pq_l, w16t, t_norm, ids, fitness)

        per = for_shards(mesh, axis, phase2, cutoff, feat_t, pq_norm)
        # Collective 2: the round champion, earliest id among the best.
        champs_f = all_gather([x[0] for x in per])
        champs_id = all_gather([x[1] for x in per])
        by_id = torch.sort(champs_id, stable=True)[1]
        win = by_id[torch.sort(-champs_f[by_id], stable=True)[1][:1]]
        onehot = (torch.arange(n_shards, device=lead) == win).to(
            torch.float32)
        gw = psum([x[2] * onehot[s].to(x[2].device)
                   for s, x in enumerate(per)])
        gf = champs_f[win][0]
        better = gf > bf  # strict: the earliest round keeps ties
        bf = torch.where(better, gf, bf)
        bw = torch.where(better, gw, bw)
        done = bool(cutoff < _INT_MAX)  # the round's one read-back
        fid += n_shards * cons
        c += 1

    best_R = bw[6:15].reshape(3, 3)
    best_t = bw[3:6]
    res = _rescore(p, q, src_mask, best_R, best_t, bf, thr2, n_valid)
    if return_consumed:
        return res, min(fid, max_iterations)
    return res
