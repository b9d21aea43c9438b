#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu3d_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from tpu3d_torch/csrc (nvcc, sm_90a) and print
     the build time and the compiler's per-kernel resource report;
  3. at the shapes the main path gives them (the bench fixture
     ``make_pair(8192, voxel=0.005)``, bucket 8,192), hold each kernel
     against its plain PyTorch version on the same card inputs and time
     both (CUDA events, 2 warm runs, median of 7): K5 top-1 NN at D=33
     (descriptors) and D=3 (points), K6 hypothesis scoring (25,600
     hypotheses x 2,048 estimate rows, and 32 finalists x 8,192 rows), K7
     ICP statistics (8,192 queries over the slab windows);
  4. drive ``tpu3d_torch.register_pair`` on that pair (100,000 RANSAC
     hypotheses, ICP <= 200 iterations): launch counts of K5, K6 and K7
     must all be > 0 in that run and the pose must pass bench.py's quality
     gate (rotation error < 0.02, translation error < 0.005 m); then time
     warm pairs and each stage of one pair.

Output: progress on stderr; on stdout the nvidia-smi line, a JSON line of
per-kernel results, a JSON line of main-path results, and last the line
{"ok": true, "device": {...}}. Exits non-zero, with no "ok" line, when
there is no CUDA device, when the repository is not beside the script, or
when any phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
VOXEL = 0.005
N_POINTS = 8192


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(torch, fn, warm=2, reps=7):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def run():
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    import tpu3d_torch
    from bench import make_pair
    from tpu3d_torch import build
    from tpu3d_torch.ops import icp, icp_stats, nn, ransac, ransac_score
    from tpu3d_torch.registration import downsample_bucketed, prepare_features

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # --- build -------------------------------------------------------------
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    build_s = time.perf_counter() - t0
    log(f"kernels built in {build_s:.1f} s")

    # --- slice inputs ------------------------------------------------------
    src_np, tgt_np, R_true, t_true = make_pair(N_POINTS, voxel=VOXEL)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL)
    src = tpu3d_torch.PointCloud.from_numpy(src_np, device=dev)
    tgt = tpu3d_torch.PointCloud.from_numpy(tgt_np, device=dev)
    sd = downsample_bucketed(src, cfg)
    td = downsample_bucketed(tgt, cfg)
    check(sd.capacity == td.capacity == 8192, f"bucket {sd.capacity}")
    sd, sf = prepare_features(sd, cfg)
    td, tf = prepare_features(td, cfg)
    torch.cuda.synchronize()
    log(f"prepared: {sd.count()} / {td.count()} rows, bucket {sd.capacity}")

    kernels = []

    # --- K5 ----------------------------------------------------------------
    k5 = {"name": "nn_top1 (K5)", "route": "cuda",
          "source": "tpu3d_torch/csrc/nn.cu",
          "replaces": "tpu3d/ops/nn_pallas.py:111"}
    for d, (q, t, m) in (
        (33, (sf.descriptors, tf.descriptors, tf.mask)),
        (3, (sd.points, td.points, td.mask)),
    ):
        ki, kd = nn.nearest_neighbor(q, t, m)
        pi, pd = nn.nearest_neighbor_plain(q, t, m)
        torch.cuda.synchronize()
        agree = float((ki == pi).float().mean())
        err = float((kd - pd).abs().max())
        rel = float(((kd - pd).abs() / pd.abs().clamp_min(1.0)).max())
        log(f"K5 D={d}: index agreement {agree:.6f}, max abs d2 err "
            f"{err:.3e}, max rel d2 err {rel:.3e}")
        # Indices may differ only on near-ties: every row's d² must agree.
        check(agree >= 0.999, f"K5 D={d} index agreement {agree}")
        check(rel <= 1e-5, f"K5 D={d} d2 error {rel}")
        ms = cuda_ms(torch, lambda: nn.nearest_neighbor(q, t, m))
        plain = cuda_ms(torch, lambda: nn.nearest_neighbor_plain(q, t, m))
        suffix = "" if d == 33 else "_d3"
        k5.update({f"max_abs_err{suffix}": err, f"ms{suffix}": ms,
                   f"plain_ms{suffix}": plain,
                   f"index_agreement{suffix}": agree})
    kernels.append(k5)

    # --- K6 ----------------------------------------------------------------
    corr = ransac.feature_correspondences(sf, tf).long()
    p = sd.points
    qq = td.points[corr]
    count = sd.count()
    feat, pq = ransac.build_scoring_factors(p, qq, sd.mask)
    table = ransac.build_rotation_table(torch.cat([p, qq], 1), sd.mask, count)
    draw = ransac.torch_draws(cfg.ransac_seed)
    iters = cfg.ransac_max_iterations
    w16t, tn, _, _, _ = ransac.solve_rotation_chunk(
        lambda e: draw(0, e), ransac.hypothesis_chunk(iters), 0, table,
        count, iters)
    feat_e, pq_e = ransac.build_scoring_factors(
        *(ransac.strided_rows(x, ransac.EST_CAP) for x in (p, qq, sd.mask)))
    thr2 = float((np.float32(VOXEL) * np.float32(1.5)) ** 2)
    k6 = {"name": "ransac_score (K6)", "route": "cuda",
          "source": "tpu3d_torch/csrc/ransac_score.cu",
          "replaces": "tpu3d/ops/ransac_pallas.py:51"}
    worst = 0.0
    for tag, args in (
        ("", (feat_e, pq_e, w16t, tn, thr2)),
        ("_finalists", (feat, pq, w16t[:, :32].contiguous(), tn[:32], thr2)),
    ):
        kc, ke = ransac_score.score_hypotheses(*args)
        pc, pe = ransac_score.score_hypotheses_plain(*args)
        torch.cuda.synchronize()
        dc = float((kc - pc).abs().max())
        same = kc == pc
        frac = float(same.float().mean())
        e_ok = bool(torch.all(
            (ke - pe).abs()[same] <= 1e-3 * pe[same] + 1e-5 * pc[same]))
        log(f"K6{tag}: max count diff {dc}, equal counts {frac:.6f}, "
            f"max count {float(kc.max())}, err sums ok {e_ok}")
        # Rows within the rank-16 expansion's rounding band of thr² may
        # count in one order of summation and not the other.
        check(dc <= 2 and frac >= 0.99 and e_ok, f"K6{tag} disagrees")
        worst = max(worst, dc)
        k6[f"ms{tag}"] = cuda_ms(
            torch, lambda: ransac_score.score_hypotheses(*args))
        k6[f"plain_ms{tag}"] = cuda_ms(
            torch, lambda: ransac_score.score_hypotheses_plain(*args))
    k6["max_abs_err"] = worst
    kernels.append(k6)

    # --- K7 ----------------------------------------------------------------
    T_true = torch.eye(4, device=dev)
    T_true[:3, :3] = torch.from_numpy(R_true).to(dev)
    T_true[:3, 3] = torch.from_numpy(t_true).to(dev)
    index = icp.build_icp_target(td)
    x0 = (sd.points @ T_true[:3, :3].T + T_true[:3, 3])[:, 0]
    _, order = torch.sort(torch.where(sd.mask, x0, 3e4), stable=True)
    thr = VOXEL * cfg.icp_distance_factor
    args = icp.SlabStats(index, sd.points[order], sd.mask[order],
                         thr).kernel_args(T_true)
    real = icp_stats.icp_p2plane_stats
    kp = real(*args)
    pp = icp_stats.icp_p2plane_stats_plain(*args)
    torch.cuda.synchronize()
    ks = icp_stats.unpack_partials(kp)
    ps = icp_stats.unpack_partials(pp)
    err7 = float((kp - pp).abs().max())
    log(f"K7: n_corr {float(ks[2])} vs {float(ps[2])}, "
        f"max partial err {err7:.3e}, window rows max "
        f"{int(args[4].max())} mean {float(args[4].float().mean()):.1f}")
    check(float(ks[2]) == float(ps[2]) > 0, "K7 n_corr")
    check(torch.allclose(ks[0], ps[0], rtol=1e-4, atol=1e-5), "K7 JtJ")
    check(torch.allclose(ks[1], ps[1], rtol=1e-4, atol=1e-6), "K7 Jtr")
    check(torch.allclose(ks[3], ps[3], rtol=1e-5, atol=0), "K7 sum d2")
    kernels.append({
        "name": "icp_p2plane_stats (K7)", "route": "cuda",
        "source": "tpu3d_torch/csrc/icp_stats.cu",
        "replaces": "tpu3d/ops/icp_pallas.py:141",
        "max_abs_err": err7,
        "ms": cuda_ms(torch, lambda: real(*args)),
        "plain_ms": cuda_ms(
            torch, lambda: icp_stats.icp_p2plane_stats_plain(*args)),
    })

    # --- main path -----------------------------------------------------------
    def pair():
        refined, coarse = tpu3d_torch.register_pair(src, tgt, cfg)
        return refined, coarse

    pair()  # warm: allocator and library state
    counters = (nn.nearest_neighbor, ransac_score.score_hypotheses,
                icp_stats.icp_p2plane_stats)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined, coarse = pair()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    for k, n in zip(kernels, launches):
        k["launches"] = n
    log(f"main path launches K5/K6/K7: {launches}")
    check(all(n > 0 for n in launches), f"a kernel did not launch: {launches}")

    T = refined.transformation.cpu().numpy()
    rot_err = float(np.abs(T[:3, :3] - R_true).max())
    trn_err = float(np.abs(T[:3, 3] - t_true).max())
    fit = float(refined.fitness)
    log(f"refined fitness {fit:.4f} rmse {float(refined.rmse):.6f} "
        f"coarse fitness {float(coarse.fitness):.4f}; pose error rot "
        f"{rot_err:.2e} trans {trn_err:.2e} m")
    check(np.isfinite(T).all() and T.shape == (4, 4), "non-finite pose")
    check(rot_err < 0.02 and trn_err < 0.005, "quality gate failed")

    times = [first_s]
    for _ in range(2):
        t0 = time.perf_counter()
        r, _ = pair()
        float(r.fitness)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    # Stage breakdown of one pair (host clock, synchronised per stage).
    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return out

    s_d = stage("downsample_ms", lambda: (downsample_bucketed(src, cfg),
                                          downsample_bucketed(tgt, cfg)))
    s_src = stage("prepare_source_ms", lambda: prepare_features(s_d[0], cfg))
    s_tgt = stage("prepare_target_ms", lambda: prepare_features(s_d[1], cfg))
    co = stage("ransac_ms", lambda: ransac.ransac_registration(
        s_src[0], s_tgt[0], s_src[1], s_tgt[1], VOXEL,
        max_iterations=cfg.ransac_max_iterations,
        confidence=cfg.ransac_confidence, seed=cfg.ransac_seed))
    stage("icp_ms", lambda: icp.icp_refine(
        s_src[0], s_tgt[0], co.transformation, VOXEL * cfg.icp_distance_factor,
        max_iterations=cfg.icp_max_iterations))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "main_path": "tpu3d_torch.register_pair",
        "fixture": f"bench.make_pair({N_POINTS}, voxel={VOXEL})",
        "bucket": sd.capacity, "ransac_max_iterations":
        cfg.ransac_max_iterations, "icp_max_iterations":
        cfg.icp_max_iterations, "build_s": build_s,
        "pair_ms": [t * 1e3 for t in times],
        "pair_ms_median": statistics.median(times) * 1e3,
        "stages_ms": stages, "fitness": fit, "coarse_fitness":
        float(coarse.fitness), "rot_err": rot_err, "trans_err": trn_err,
        "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
    }), flush=True)
    return {
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        log("chip_smoke: PyTorch is not installed")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU")
        return 2
    if not os.path.isdir(os.path.join(REPO, "tpu3d_torch")):
        log("chip_smoke: tpu3d_torch/ is not beside this script")
        return 2
    try:
        result = run()
    except Exception:  # every phase is fatal: report and exit non-zero
        traceback.print_exc()
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
