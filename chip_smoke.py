#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu3d_torch) on one NVIDIA GPU.

  python3 chip_smoke.py [--points N] [--voxel V] [--scene-points N]
                        [--instances B]

Phases, each fatal on failure:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from tpu3d_torch/csrc (one nvcc per source, all
     started together, sm_90a) and print the build time and the compiler's
     per-kernel resource report (registers and spills go into the kernels
     line); then the host runtime (g++, csrc/host) and its build time;
  3. the reference-parity route at bucket 8,192 (the bench fixture
     ``make_pair(8192, voxel=0.005)``): the gather arm's CUDA graph replay
     against the arm run eagerly, bit for bit, and both timed for one
     cloud; K12 against the stable sort and slice, bit for bit, on
     ``knn``'s 1,024 x 8,192 chunks (5,700 valid rows, and the fixture's
     source) at k 100 and 30, timed beside its bytes bound, the sort and
     ``torch.topk``; K5 top-1 NN at D=33 and D=3, K6
     hypothesis scoring (25,600 hypotheses x 2,048 estimate rows, and 32
     finalists x 8,192 rows) and K7 ICP statistics (its sums and its
     match-only epilogue) against their plain PyTorch versions on the same
     card inputs; then ``tpu3d_torch.register_pair`` with the K5/K6/K7/K12
     launch counts (K12: 16, two replays of 8 chunks), bench.py's quality
     gate (rotation error < 0.02, translation error < 0.005 m), warm pairs
     and a stage breakdown; and
     ``register_pair`` with ``use_point_to_plane=False`` (point-to-point
     ICP through K7's match-only epilogue, never its sums), through the
     gate;
  4. the at-scale route (``make_pair(100352)``, voxel 0.002, every other
     field of RegistrationConfig at its default: bucket 131,072, the sparse
     arm, 100,000 hypotheses, ICP <= 200 iterations):
     a. K2, K3 and K4 against their plain versions on both operand sets
        the main path gives them: the target's dense layout (block 128)
        and the source's sparse one (block 256, the member sets' pruned
        windows), each sweep fed the kernel chain's inputs;
     b. the sparse prepare of the source against the dense prepare at
        block 256, bit for bit on every retained row;
     c. K5, K6 and K7 against their plain versions at this route's shapes,
        with the library call beside K5 and K6, and the descriptor
        correspondence quality of K5's picks and of the plain version's
        (the share of valid source rows matched within 1.5 x voxel of
        their true-pose position, benchmarks/nn_precision_quality.py's
        metric; the kernel's at least the plain version's - 0.002);
        K10 (the rotation sampler's hypotheses) on a chunk of this route
        and K11 (the gather sampler's) on the same rows at 25,600 (a
        gather chunk), 4,096 (the 64 batch's one shot) and 100,352
        hypotheses (the two-stage one shot), each bit for bit;
     d. ``tpu3d_torch.register_pair``: all seven launch counts (K2-K7,
        K10) > 0 in that run, the quality gate, the escalation flag, warm
        pairs, a stage breakdown, peak device memory and one pair's
        device-busy time (torch.profiler); then with ``two_stage='on'``
        (the two-stage scorer ran, K11 launched) and with
        ``use_point_to_plane=False``, each through the gate;
  5. the pipeline (``tpu3d_torch.pipeline.Pipeline``) on 1280 x 720 frames:
     a. K9 (the bilateral filter) against its plain version on the bin
        frame (``models/fixtures.bin_frame``) masked to one instance, at
        r = 4 (sigma_s 2.0) and r = 5 (sigma_s 3.0), and on the whole
        frame: bit for bit, with each frame's live CTAs (a centre above
        zero) and live warps, and its device ms on an all-zero frame;
     b. the CLI demo: ``tpu3d_torch.__main__.main`` on a copy of
        config/pipeline_config.yaml with ``bilateral_filter: true`` and
        ``visualization: "none"`` (the procedural scene, voxel 1 mm,
        100,000 hypotheses, ICP <= 200 iterations): rc 0, one waypoint,
        no error branch or host ICP retry, K9 launched;
     c. ``Pipeline.run()`` on the bin frame at voxel 0.002 with the
        bilateral filter on, fed from files: the frame as dummy-data
        PNGs, four mask PNGs, three of 320 px (one capacity bucket: a
        batched group on the sparse arm) and one of 74 px (bucket 1,024:
        the gather sampler), and the reference model, the deprojected
        frame written with ``save_ply`` (fused mode). Every instance gets
        a pose, no error branch or host ICP retry runs, all four pass the
        quality gate against the identity, K2-K7 and K9 all launch, the
        two warm runs (the model's downsampled cloud kept, no PLY read)
        and a run after the model file is touched (read again) give the
        cold run's poses bit for bit;
        reported: the stage breakdown (wrappers around the pipeline's own
        functions), cold and warm run times, peak device memory and one
        run's device-busy time; K2-K4 against their plain versions on the
        reference's dense and the first instance's sparse prepare, and
        K7 on that instance's ICP; then one more run with ``two_stage: on``
        and ``use_point_to_plane: false``: every instance posed, no error
        branch, every kernel launched (K7 by its match-only epilogue),
        all four through the quality gate, and a second run with the
        same poses bit for bit;
     d. the host runtime (``tpu3d_torch.native``, built by g++ from the
        port's copy of the C++ source): it builds; the native and numpy
        PLY readers give equal arrays on the bin frame's reference model
        (both timed); the native mask resize equals the numpy nearest
        resize binarised at 10 on the bin masks, halved and doubled, and
        is timed against the numpy resize and cv2's (where installed); the
        bin frame's run after its model file was touched reads the model
        natively (the warm runs keep it);
  6. the 1M-point scene of bench.py's extras, at its sizes:
     a. top-1 NN within 2 mm, 1,048,576 x 1,048,576 (``make_pair(1 << 20,
        seed=5)``): ``ops.slab.slab_top1`` on the x-sorted points (block
        256, slice_cap 8,192; its time and overflow flag) and
        ``ops.nn_walk.slab2_top1`` (block 512, sub 512, K 8; host time
        with both index builds, K8's launches); the matched set and d²
        equal slab_top1's on its non-overflowed blocks; K8 against its
        plain version bit for bit (d² and the index on every row) on the
        scene's window tables and on queries jittered by 1 mm, with the
        window rows per block; every launch of its plan (CTAs a block and
        queries a thread, ``nn_walk_plan``) forced on both, on the
        self-join's first 96, 264, 660 and 1,024 blocks and on the
        self-join in blocks of 128 (``plan_sides``);
     b. the full 1M pair (``make_pair(1 << 20, seed=7, voxel=0.001)``):
        the target's dense fused prepare at r = 5 mm, ICP index and K5
        target operand (``ransac.with_target_operand``), then
        ``fused_prepare_sparse``, RANSAC (100,000 hypotheses, corr_mode
        'exact') and ICP (<= 50 iterations, the target index): K2-K7
        launched, the quality gate, warm pairs, stage times, peak memory,
        device-busy time; then K2-K5 and K7 against their plain versions
        at these shapes, K5's descriptor quality as in 4c, and, once the
        pair's state is freed, K5's library call at Q 8,192 x M 1,048,576
        (a 34.4 GB product; two query halves where it does not fit);
     c. the 64-instance batch (16,384-row target, 64 fused-prepared
        sources of 8,192 rows at bench.py's rng(1) poses,
        ``register_batch`` with 4,096 hypotheses and ICP <= 30
        iterations): every member through the gate, K2-K7 launched; then
        K2-K4 on the target's and the first source's prepares and K7 on
        that source's ICP, against their plain versions;
     d. the probe (``tpu3d_torch.probe``): each function's kernel against
        PyTorch on the card within its stated tolerance;
  7. the multiscale entry and the neighbour, ICP and RANSAC options:
     a. ``tpu3d_torch.register_pair_multiscale`` on phase 4's pair (levels
        2, scale_step 3: the coarse level at 3 x voxel takes the fused
        prepare, both levels ICP on normals-only targets whose neighbours
        come from ``slab_knn`` at k = 30), 100,000 hypotheses: K2-K7 all
        launched in that run, the quality gate, warm host ms, device busy,
        peak memory; the fine target's slab_knn timed, its largest
        window, overflow flag, and every valid row of a padding-free
        block its own first neighbour;
     b. bucket 8,192: ``prepare_features`` with neighbor_mode 'brute',
        'slab' and 'grid', then ``register_prepared``: each through the
        gate, its prepare ms and its descriptor correspondences' share
        equal to brute's;
     c. ``icp_refine`` from one RANSAC pose with nn_mode 'slab' (every
        source row), 'grid' and 'brute' at bucket 8,192, and 'slab'
        against 'grid' on phase 4's pair (<= 30 iterations): poses within
        1e-5 of the slab one (the CPU tests' tolerance), ms per stats
        pass;
     d. RANSAC on phase 4's sparse subset with hyp_chunk 16,384 and
        50,176, early_exit off and sampling 'gather', each refined by ICP
        through the gate: chunks run and RANSAC ms;
  8. the sharded stack (``tpu3d_torch.parallel``) on virtual meshes that
     list cuda:0 several times, so the shards run one after another on
     the one card (correctness and overhead, not a speedup):
     a. ``register_pair(..., mesh=)`` on phase 4's pair over 4 shards and
        over 2: both prepares distributed (``register_pair_sharded``'s
        ``return_info``), the gate, warm host ms (median of 3), device
        busy, and K2-K6 and K8 launched in the 4-shard run
        (``launches_sharded``);
     b. ``slab2_top1_sharded`` on the 1M scene over 4 shards at r = 2 mm:
        d2 bit for bit the single-device ``slab2_top1``'s, indices equal
        wherever the minimum is unique;
     c. on one shard of 8a: K2-K4 on its halo-extended layout, K5 on its
        descriptor rows, K6 on a shard's hypothesis slice (6,400 of the
        25,600-hypothesis round) and K8 on its walk of ICP's queries,
        each against its plain version (suffix ``_shard``);
     d. ``Pipeline.run()`` on the bin frame with ``parallel: {mode: on,
        devices: 4}``, the card seen 4 times: every instance posed through
        the gate, one sharded registration each;
     e. ``tpu3d_torch.parallel.dryrun.dryrun_multichip(4)`` (2 x 2 mesh).
  9. the examples and the timing helpers:
     a. ``examples/torch_register_pair.py`` (20,000 points, voxel 0.004,
        20,000 hypotheses) and ``examples/torch_register_pair_multichip.py
        --virtual 4`` (cuda:0 seen 4 times) through their ``main``, each
        through the quality gate with its launches counted;
     b. ``register_pair`` on phase 3's pair timed by the port's
        ``device_timeit`` and ``StageTimer`` beside ``host_ms``, and the
        card's ``roundtrip_ms``;
     c. phase 3's point-to-point (K7's match-only epilogue) and 'brute'
        (K5 at D = 3) ICP from its RANSAC pose on the card and on CPU
        copies (the plain versions): both through the gate, the largest
        pose difference printed and held within 1e-3;
  10. RANSAC's chunks replayed as one CUDA graph against the same chunks
     run eagerly (``ransac.CHUNK_GRAPH``): on phase 4's sparse subset (the
     rotation sampler, K10) and at bucket 8,192 with ``sampling='gather'``
     (K11, once a chunk either way): the same pose bit for bit, the CUDA
     API calls a chunk either way, RANSAC's host ms in turns and device
     busy; then ``register_pair`` on phase 4's pair either way. K11 also
     launches, and is counted, on the bin frame (5c: the 74-px
     instance's gather chunks; every instance with ``two_stage: on``),
     in the 64 batch (6c) and the two-stage pair (4d).
  Kernel and plain times are CUDA events, 2 warm runs, median of 5
  (slab_top1 and K8's plain version: 1 warm run, median of 3); beside
  them ``device_ms``, the device time of one call (10 calls queued behind
  a device-side sleep, between two CUDA events), for K2-K9 and each probe
  function and its PyTorch call (``library_device_ms``). K2-K4, K8
  and K9 are held bit for bit (K3 on all 40 rows), K7's n_corr and
  matches too. K7 also reports one ICP iteration with its readback
  (``iteration_ms``). Each side of every launch-plan threshold is forced
  (through ``moments_plan``, ``spfh_plan``, ``fpfh_plan``,
  ``nn_walk_plan``), held bit for bit to the plan's
  own result, and timed (``device_ms_<side>``), beside the side the plan
  picks (``plan``): K2 one CTA a block or two (``block``, ``halves``) and
  K3 a thread a query or its lane kernel (``threads``, ``lanes``) on
  every layout, K4 its two kernels on each dense layout, K8 ``s<slices>
  q<queries a thread>``.
  ``bound_ms`` is the larger of this run's operations over 67 TFLOP/s
  (fp32 without tensor cores) and its bytes (each input read once, each
  output written once) over 3.35 TB/s, an H100 SXM's peaks; the window
  kernels (K2-K4, K7, K8) count only the target columns that some
  window covers, K7 also the kept matches' normals and two binary
  searches of sorted_x per block with a valid query; K9 also
  reports the floor its expf calls set on the special-function units.
  K5 at D > 4 and K6 run 3xTF32 on the tensor cores: ``bound_tc_ms`` is
  three TF32 passes of their operations over 495 TFLOP/s, beside their
  split count (``splits``); K5's ``kernel_ms`` times its two launches
  on packed operands (``ms`` includes the operand pass, and
  ``ms_packed_targets`` is one call on a target operand built once, as
  RANSAC makes it), and ``device_ms`` is the device time of one call,
  without the host's launch gaps that the CUDA events around one call
  include. K6 also reports the share of its elements
  inside the band that it recomputes in fp32, the share of warp steps
  (8 rows x 32 hypotheses) that hold one, and the elements a warp defers
  per row slice.
  ``--points``/``--voxel`` shrink phases 4 and 8 and ``--scene-points``/
  ``--instances`` phases 6 and 8b for a rehearsal off the card.

Output: progress on stderr; on stdout the nvidia-smi line, a JSON line of
per-kernel results, one JSON line per route, and last the line
{"ok": true, "device": {...}}. Exits non-zero, with no "ok" line, when
there is no CUDA device, when the repository is not beside the script, or
when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import io
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
PEAK_FP32 = 67e12  # FLOP/s, H100 SXM without tensor cores
PEAK_TF32 = 495e12  # FLOP/s, H100 SXM tensor cores in TF32, dense
PEAK_HBM = 3.35e12  # bytes/s


# The kernel functions behind each kernels-line entry (its name before " (").
KERNEL_FUNCTIONS = {
    "moments_sweep": ["moments_kernel"],
    "spfh_sweep": ["spfh_kernel", "spfh_lanes_kernel"],
    "fpfh_sweep": ["fpfh_kernel", "fpfh_lanes_kernel"],
    "nn_top1": ["nn_desc_kernel", "nn_desc_reduce", "nn_top1_kernel"],
    "ransac_score": ["score_tc_kernel", "score_reduce"],
    "ransac_hyp": ["ransac_hyp_kernel"],
    "gather_hyp": ["gather_hyp_kernel"],
    "knn_select": ["knn_select_kernel"],
    "icp_p2plane_stats": ["icp_stats_kernel"],
    "icp_matches": ["icp_stats_kernel"],
    "bilateral_filter": ["bilateral_kernel"],
    "nn_walk_top1": ["nn_walk_top1_kernel", "nn_walk_order_kernel"],
    "atan2": ["unary_kernel"], "atan": ["unary_kernel"],
    "acos": ["unary_kernel"], "cos": ["unary_kernel"],
    "argmin": ["argmin_kernel"], "cumsum": ["cumsum_kernel"],
    "dot_axis0": ["dot_axis0_kernel"], "transpose": ["transpose_kernel"],
}


def card_state():
    """The card's SM clock, power draw and temperature now (nvidia-smi),
    to tell a slower phase from a slower card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(torch, fn, warm=2, reps=5):
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


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time for this work on the card."""
    t_ops = flops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_HBM * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bound_tc(flops):
    """The tensor-core bound of a 3xTF32 product: three TF32 passes of
    ``flops`` at the TF32 peak, in ms."""
    return 3.0 * flops / PEAK_TF32 * 1e3


def kernel_resources(report):
    """{kernel function: {registers, spill_bytes}} from the compiler's
    ``-Xptxas -v`` report, for the functions of ``KERNEL_FUNCTIONS`` (the
    largest over a template's instantiations)."""
    import re

    names = {f for funcs in KERNEL_FUNCTIONS.values() for f in funcs}
    out, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            hits = [n for n in names if n in m.group(1)]
            current = max(hits, key=len) if hits else None
            continue
        if current is None:
            continue
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        if sp:
            r = out.setdefault(current, {"registers": 0, "spill_bytes": 0})
            r["spill_bytes"] = max(r["spill_bytes"],
                                   int(sp.group(1)) + int(sp.group(2)))
        rg = re.search(r"Used (\d+) registers", line)
        if rg:
            r = out.setdefault(current, {"registers": 0, "spill_bytes": 0})
            r["registers"] = max(r["registers"], int(rg.group(1)))
    return out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


class Stages:
    """Host-clock stage times, synchronised at each stage boundary."""

    def __init__(self, torch):
        self.torch = torch
        self.ms = {}

    def __call__(self, name, fn):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        self.ms[name] = (time.perf_counter() - t0) * 1e3
        return out


def host_ms(torch, fn, warm=1, reps=3):
    """Host-clock milliseconds of synchronised runs of ``fn`` (after
    ``warm`` runs), and the last result."""
    out = None
    for _ in range(warm):
        out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def gate(np, refined, R_true, t_true):
    T = refined.transformation.cpu().numpy()
    rot = float(np.abs(T[:3, :3] - R_true).max())
    trn = float(np.abs(T[:3, 3] - t_true).max())
    check(np.isfinite(T).all() and T.shape == (4, 4), "non-finite pose")
    check(rot < 0.02 and trn < 0.005,
          f"quality gate failed: rotation {rot}, translation {trn}")
    return rot, trn


def descriptor_quality(torch, np, idx, src_pts, qmask, tgt_pts, R, t,
                       voxel):
    """Share of valid source rows whose descriptor match lies within
    1.5 x voxel of the row's true-pose position (the true-inlier
    correspondence quality of benchmarks/nn_precision_quality.py)."""
    Rt = torch.from_numpy(np.asarray(R, np.float32)).to(src_pts.device)
    tt = torch.from_numpy(np.asarray(t, np.float32)).to(src_pts.device)
    d = (src_pts @ Rt.T + tt - tgt_pts[idx.long()]).norm(dim=1)
    return float(((d < 1.5 * voxel) & qmask).sum()) / max(int(qmask.sum()), 1)


def nn_library_ms(torch, q, t, m):
    """One PyTorch call for K5's function, addmm(...).min(1), timed: (ms,
    note, halves). Where the card refuses the (Q x M) product for memory,
    the two query halves are timed one after the other."""
    tm = torch.where(m[:, None], t, 1.0e6)
    tn = (tm * tm).sum(1)

    def lib(qq):
        return torch.addmm(tn[None, :], qq, tm.T, alpha=-2.0).min(dim=1)

    torch.cuda.empty_cache()
    try:
        return cuda_ms(torch, lambda: lib(q)), "one call", None
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        h = q.shape[0] // 2
        halves = [cuda_ms(torch, lambda: lib(q[:h])),
                  cuda_ms(torch, lambda: lib(q[h:]))]
        log(f"K5 library call: the {q.shape[0]} x {t.shape[0]} product does "
            f"not fit; timed two query halves {halves} ms")
        return sum(halves), "two query halves (out of memory)", halves


def nn_phase(torch, nn, q, qmask, t, m, suffix, entry, library=True,
             quality=None):
    """K5 kernel against its plain version and, with ``library``, the
    library call; with ``quality`` (np, source points, target points,
    R_true, t_true, voxel), the descriptor correspondence quality of both.

    Each version picks the least d² in its own rounding of ‖t‖² − 2t·q
    (fp32 in the plain version, 3xTF32 in the D > 4 kernel), so the two
    may pick different rows among near-equal candidates (dense descriptor
    fields have many). Held: the returned d² agree, and on every valid row
    where the picks differ, the two picks' d² recomputed in float64 differ
    by at most 1e-6 (a near-tie)."""
    ki, kd = nn.nearest_neighbor(q, t, m)
    pi, pd = nn.nearest_neighbor_plain(q, t, m)
    torch.cuda.synchronize()
    differ = (ki != pi) & qmask
    agree = 1.0 - float(differ.sum()) / max(int(qmask.sum()), 1)
    err = float((kd - pd).abs().max())
    rel = float(((kd - pd).abs() / pd.abs().clamp_min(1.0)).max())
    rows = differ.nonzero()[:, 0]
    q64 = q[rows].double()
    gap = ((t[ki[rows].long()].double() - q64).pow(2).sum(1)
           - (t[pi[rows].long()].double() - q64).pow(2).sum(1)).abs()
    tie_gap = float(gap.max()) if rows.numel() else 0.0
    log(f"K5{suffix} {tuple(q.shape)} x {tuple(t.shape)}: index agreement "
        f"{agree:.6f} on valid rows, largest float64 d2 gap of differing "
        f"picks {tie_gap:.3e}, max abs d2 err {err:.3e}, max rel d2 err "
        f"{rel:.3e}")
    check(tie_gap <= 1e-6, f"K5{suffix} picks differ beyond a tie: {tie_gap}")
    check(rel <= 1e-5, f"K5{suffix} d2 error {rel}")
    qn, d = q.shape
    mn = t.shape[0]
    flops = 2.0 * qn * mn * d
    b_ms, b_by = bound(flops, nbytes(q, t, m, ki, kd))
    entry.update({
        f"max_abs_err{suffix}": err, f"index_agreement{suffix}": agree,
        f"tie_gap{suffix}": tie_gap,
        f"ms{suffix}": cuda_ms(torch, lambda: nn.nearest_neighbor(q, t, m)),
        f"plain_ms{suffix}": cuda_ms(
            torch, lambda: nn.nearest_neighbor_plain(q, t, m)),
        f"bound_ms{suffix}": b_ms, f"bound_by{suffix}": b_by,
        f"bound_tc_ms{suffix}": None, f"splits{suffix}": None,
    })
    if d > 4:
        # The tensor-core route: its bound, its split count, and the two
        # launches alone on packed operands (ms also packs the operands).
        qop, top = nn.descriptor_queries(q), nn.descriptor_targets(t, m)
        entry.update({
            f"bound_tc_ms{suffix}": bound_tc(flops),
            f"splits{suffix}": nn.split_plan(qn, mn)[1],
            f"kernel_ms{suffix}": cuda_ms(
                torch, lambda: nn.descriptor_top1(q, qop, top, mn)),
            f"operands_ms{suffix}": cuda_ms(
                torch, lambda: (nn.descriptor_queries(q),
                                nn.descriptor_targets(t, m))),
            f"device_ms{suffix}": per_call_device_ms(
                torch, lambda: nn.nearest_neighbor(q, t, m)),
            # One call on a target operand built once, as RANSAC makes it
            # against a target with its operand attached.
            f"ms_packed_targets{suffix}": cuda_ms(
                torch, lambda: nn.nearest_neighbor(q, t, m,
                                                   packed_targets=top)),
        })
        del qop, top
    ms = entry[f"ms{suffix}"]
    entry[f"share{suffix}"] = b_ms / ms
    if entry[f"bound_tc_ms{suffix}"] is not None:
        entry[f"share_tc{suffix}"] = entry[f"bound_tc_ms{suffix}"] / ms
    log(f"K5{suffix}: {ms:.4f} ms (kernel "
        f"{entry.get('kernel_ms' + suffix, ms):.4f}, device "
        f"{entry.get('device_ms' + suffix, ms):.4f}), plain "
        f"{entry['plain_ms' + suffix]:.4f}, bound {b_ms:.5f} ({b_by}), "
        f"tensor-core bound {entry['bound_tc_ms' + suffix]}, splits "
        f"{entry['splits' + suffix]}")
    if quality is not None:
        np_, src_pts, tgt_pts, R, tr, voxel = quality
        qk = descriptor_quality(torch, np_, ki, src_pts, qmask, tgt_pts, R,
                                tr, voxel)
        qp = descriptor_quality(torch, np_, pi, src_pts, qmask, tgt_pts, R,
                                tr, voxel)
        entry[f"quality{suffix}"] = qk
        entry[f"quality_plain{suffix}"] = qp
        log(f"K5{suffix} descriptor correspondence quality (within 1.5 x "
            f"voxel of the true pose): kernel {qk:.6f}, plain fp32 {qp:.6f}")
        check(qk >= qp - 0.002,
              f"K5{suffix} descriptor quality {qk} below plain {qp} - 0.002")
    if not library:
        entry[f"library_ms{suffix}"] = None
        return
    lib_ms, note, halves = nn_library_ms(torch, q, t, m)
    entry[f"library_ms{suffix}"] = lib_ms
    if halves is not None:
        entry[f"library_note{suffix}"] = note
        entry[f"library_halves_ms{suffix}"] = halves


def score_phase(torch, ransac_score, args, suffix, entry):
    """K6 kernel against its plain version and the library call."""
    kc, ke = ransac_score.score_hypotheses(*args)
    pc, pe = ransac_score.score_hypotheses_plain(*args)
    torch.cuda.synchronize()
    dc = float((kc - pc).abs().max())
    same = kc == pc
    frac = float(same.float().mean())
    e_ok = bool(torch.all(
        (ke - pe).abs()[same] <= 1e-3 * pe[same] + 1e-5 * pc[same]))
    log(f"K6{suffix} H={args[2].shape[1]} N={args[0].shape[1]}: max count "
        f"diff {dc}, equal counts {frac:.6f}, err sums ok {e_ok}")
    # Rows within the rank-16 expansion's rounding band of thr² may count
    # in one order of summation and not the other.
    check(dc <= 2 and frac >= 0.99 and e_ok, f"K6{suffix} disagrees")
    ft, pq, w, tn, thr2 = args
    n, h = ft.shape[1], w.shape[1]
    flops = 2.0 * h * n * 16
    b_ms, b_by = bound(flops, nbytes(ft, pq, w, tn, kc, ke))
    rows, slices = ransac_score.slice_plan(n, h)
    # The share of (row, hypothesis) elements inside the band that the
    # kernel recomputes in fp32; the share of warp steps (8 rows x 32
    # hypotheses) that hold one, each of which a re-check inside the step
    # would stall; and the elements a warp defers per slice instead.
    err2 = (ft.T @ w + pq[:, None]) + tn[None, :]
    band = ((err2 - thr2).abs() <= ransac_score.band_margin(pq, tn)).float()
    del err2
    steps = torch.zeros(-(-n // 8) * 8, -(-h // 32) * 32, device=band.device)
    steps[:n, :h] = band
    step_share = float(steps.view(steps.shape[0] // 8, 8, -1, 32)
                       .amax((1, 3)).mean())
    per_warp = float(band.sum()) / (slices * (steps.shape[1] // 32))
    del steps
    entry.update({
        f"max_abs_err{suffix}": dc, f"equal_counts{suffix}": frac,
        f"ms{suffix}": cuda_ms(
            torch, lambda: ransac_score.score_hypotheses(*args)),
        f"plain_ms{suffix}": cuda_ms(
            torch, lambda: ransac_score.score_hypotheses_plain(*args)),
        f"bound_ms{suffix}": b_ms, f"bound_by{suffix}": b_by,
        f"bound_tc_ms{suffix}": bound_tc(flops),
        f"splits{suffix}": slices, f"rows_per_slice{suffix}": rows,
        f"blocks{suffix}": slices * -(-h // ransac_score.HYP_TILE),
        f"band_share{suffix}": float(band.mean()),
        f"band_step_share{suffix}": step_share,
        f"band_per_warp_slice{suffix}": per_warp,
        f"device_ms{suffix}": per_call_device_ms(
            torch, lambda: ransac_score.score_hypotheses(*args)),
    })
    ms = entry[f"ms{suffix}"]
    entry[f"share{suffix}"] = b_ms / ms
    entry[f"share_tc{suffix}"] = entry[f"bound_tc_ms{suffix}"] / ms
    log(f"K6{suffix}: {ms:.4f} ms (device {entry['device_ms' + suffix]:.4f}), "
        f"plain {entry['plain_ms' + suffix]:.4f}, "
        f"bound {b_ms:.5f} ({b_by}), tensor-core bound "
        f"{entry['bound_tc_ms' + suffix]:.5f}, {slices} slices of {rows} "
        f"rows, band share {entry['band_share' + suffix]:.5f} of the "
        f"elements, {step_share:.5f} of the warp steps, {per_warp:.2f} "
        f"deferred a warp and slice")
    def lib():
        err2 = torch.addmm(pq[:, None], ft.T, w) + tn[None, :]
        inl = err2 < thr2
        return inl.sum(0), torch.where(inl, err2, 0.0).sum(0)

    entry[f"library_ms{suffix}"] = cuda_ms(torch, lib)


def icp_phase(torch, icp, icp_stats, index, src_pts, smask, T, thr, suffix,
              entry, match_entry=None):
    """K7 against its plain version on the slab windows at T: the sums
    (n_corr exact, the rest within the stated tolerances) and the
    match-only epilogue (P, d² and rows equal); wrapper time, device time
    per call, plain time and bound for both."""
    x0 = (src_pts @ T[:3, :3].T + T[:3, 3])[:, 0]
    _, order = torch.sort(torch.where(smask, x0, 3e4), stable=True)
    stats = icp.SlabStats(index, src_pts[order], smask[order], thr)
    args = stats.kernel_args(T.cpu())
    src, qmask, packed, sorted_x, Th, radius, thr2, block = args
    margs = args[:6] + (block,)
    real = icp_stats.icp_p2plane_stats
    plain = icp_stats.icp_p2plane_stats_plain
    ks = real(*args)
    ps = plain(*args)
    km = icp_stats.icp_matches(*margs)
    pm = icp_stats.icp_matches_plain(*margs)
    torch.cuda.synchronize()
    err = float((ks - ps).abs().max())
    lo, length = icp_stats.query_windows(sorted_x, pm[0], qmask > 0.5,
                                        radius, block)
    log(f"K7{suffix}: {src.shape[0]} queries, n_corr {float(ks[42])} vs "
        f"{float(ps[42])}, max err {err:.3e}, window rows max "
        f"{int(length.max())} mean {float(length.float().mean()):.1f}")
    check(float(ks[42]) == float(ps[42]) > 0, f"K7{suffix} n_corr")
    check(torch.allclose(ks[:36], ps[:36], rtol=1e-4, atol=1e-5),
          f"K7{suffix} JtJ")
    check(torch.allclose(ks[36:42], ps[36:42], rtol=1e-4, atol=1e-6),
          f"K7{suffix} Jtr")
    check(torch.allclose(ks[43], ps[43], rtol=1e-5, atol=0),
          f"K7{suffix} sum d2")
    same = [torch.equal(k, p) for k, p in zip(km, pm)]
    log(f"K7{suffix} match-only epilogue: P, d2, rows equal {same}; "
        f"{int((pm[2] >= 0).sum())} of {src.shape[0]} queries matched")
    check(all(same), f"K7{suffix} matches differ from the plain version's")
    # Work: d² (8 operations) for every (valid query, window row) pair,
    # and ~80 for each valid query's match and sums.
    valid_b = (qmask > 0.5).reshape(-1, block).sum(1)
    pairs = int((valid_b * length).sum())
    kept = (qmask > 0.5) & (pm[1] <= thr2) & (pm[2] >= 0)
    walk_bytes = icp_bytes(torch, src, sorted_x, lo, length, valid_b)
    b_ms, b_by = bound(8.0 * pairs + 80.0 * int(valid_b.sum()),
                       walk_bytes + 12 * int(pm[2][kept].unique().numel())
                       + nbytes(ks))
    entry.update({
        f"max_abs_err{suffix}": err, f"pairs{suffix}": pairs,
        f"window_rows_mean{suffix}": float(length.float().mean()),
        f"ms{suffix}": cuda_ms(torch, lambda: real(*args)),
        f"device_ms{suffix}": per_call_device_ms(torch, lambda: real(*args)),
        f"plain_ms{suffix}": cuda_ms(torch, lambda: plain(*args)),
        f"bound_ms{suffix}": b_ms, f"bound_by{suffix}": b_by,
        # One ICP iteration as the host loop runs it: the pass and its
        # readback.
        f"iteration_ms{suffix}": cuda_ms(torch, lambda: stats(Th).vec.cpu()),
    })
    log(f"K7{suffix}: {entry['ms' + suffix]:.4f} ms (device "
        f"{entry['device_ms' + suffix]:.4f}), one iteration with its readback "
        f"{entry['iteration_ms' + suffix]:.4f}, plain "
        f"{entry['plain_ms' + suffix]:.4f}, bound {b_ms:.5f} ({b_by})")
    if match_entry is None:
        return
    mb_ms, mb_by = bound(8.0 * pairs + 20.0 * int(valid_b.sum()),
                         walk_bytes + nbytes(*km))
    match_entry.update({
        f"max_abs_err{suffix}": float((km[1] - pm[1]).abs().max()),
        f"ms{suffix}": cuda_ms(torch, lambda: icp_stats.icp_matches(*margs)),
        f"device_ms{suffix}": per_call_device_ms(
            torch, lambda: icp_stats.icp_matches(*margs)),
        f"plain_ms{suffix}": cuda_ms(
            torch, lambda: icp_stats.icp_matches_plain(*margs)),
        f"bound_ms{suffix}": mb_ms, f"bound_by{suffix}": mb_by,
    })
    log(f"K7{suffix} match-only: {match_entry['ms' + suffix]:.4f} ms "
        f"(device {match_entry['device_ms' + suffix]:.4f}), plain "
        f"{match_entry['plain_ms' + suffix]:.4f}, bound {mb_ms:.5f} "
        f"({mb_by})")


def icp_bytes(torch, src, sorted_x, lo, length, valid_b):
    """Bytes K7's walk must read: the source rows and their mask, the
    coordinate planes of the target rows that some block's window covers,
    and, for each block with a valid query, the sorted_x entries of two
    binary searches. (The sums also read the kept matches' normals; both
    modes write their own outputs.)"""
    import math

    m = sorted_x.shape[0]
    searches = 2 * int((valid_b > 0).sum()) * math.ceil(math.log2(m + 1))
    return (16 * src.shape[0]
            + 12 * covered_columns(torch, lo, length, m) + 4 * searches)


def knn_select_phase(torch, neighbors, dev, entry, cloud_rows=None):
    """K12 on ``knn``'s own chunks at bucket 8,192: the 1,024 x 8,192
    distance rows of a cloud with 5,700 valid rows (``pair_8k``'s), as
    ``knn`` builds them (the matmul expansion plus the invalid targets'
    sentinel), at k 100 (the gather route's) and 30 (the normals' and
    ``prepare_icp_target``'s): bit for bit against the stable sort and
    slice, on the first chunk and on the one that holds the last valid rows
    and the padding, and on ``cloud_rows`` (a real cloud's (points, mask))
    when given; then timed on the first chunk against the sort and
    ``torch.topk``. Bound: bytes, Q*M*4 read and Q*k*8 written."""
    g = torch.Generator().manual_seed(5700)
    pts = torch.zeros(8192, 3)
    pts[:5700] = torch.rand(5700, 3, generator=g) * torch.tensor(
        [0.18, 0.18, 0.01])
    clouds = [(pts.to(dev), torch.arange(8192, device=dev) < 5700)]
    if cloud_rows is not None:
        clouds.append(cloud_rows)

    def chunk(points, mask, start):
        invalid = torch.where(mask, 0.0, 1e30).to(torch.float32)
        return (neighbors.pairwise_sqdist(points[start:start + 1024], points)
                + invalid[None, :])

    first = chunk(*clouds[0], 0)
    for k in (100, 30):
        for points, mask in clouds:
            last = (int(mask.sum()) - 1) // 1024 * 1024
            for start in (0, last):
                d2 = chunk(points, mask, start)
                before = neighbors.knn_select.launches
                kv, ki = neighbors.knn_select(d2, k)
                pv, pi = neighbors.knn_select_plain(d2, k)
                torch.cuda.synchronize()
                check(neighbors.knn_select.launches == before + 1,
                      "K12 did not launch")
                check(torch.equal(ki, pi) and torch.equal(
                    kv.view(torch.int32), pv.view(torch.int32)),
                      f"K12 differs from the sort at k {k}, rows {start}")
        q, m = first.shape
        sfx = f"_k{k}"
        b_ms, b_by = bound(0, 4.0 * q * m + 8.0 * q * k)
        entry.update({
            f"shape{sfx}": [q, m, k], f"bit_equal{sfx}": True,
            f"ms{sfx}": cuda_ms(
                torch, lambda: neighbors.knn_select(first, k)),
            f"device_ms{sfx}": per_call_device_ms(
                torch, lambda: neighbors.knn_select(first, k)),
            f"plain_ms{sfx}": cuda_ms(
                torch, lambda: neighbors.knn_select_plain(first, k)),
            f"library_ms{sfx}": cuda_ms(
                torch, lambda: torch.topk(first, k, dim=1, largest=False)),
            f"bound_ms{sfx}": b_ms, f"bound_by{sfx}": b_by,
        })
        log(f"K12{sfx}: {entry['ms' + sfx]:.4f} ms (device "
            f"{entry['device_ms' + sfx]:.4f}), bound {b_ms:.5f} ({b_by}), "
            f"the stable sort and slice {entry['plain_ms' + sfx]:.4f}, "
            f"torch.topk {entry['library_ms' + sfx]:.4f}")


def reference_route(torch, np, dev):
    """Phase 3: bucket 8,192, the reference-parity route."""
    import tpu3d_torch
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.ops import (
        icp,
        icp_stats,
        neighbors,
        nn,
        ransac,
        ransac_score,
    )
    from tpu3d_torch.registration import (
        downsample_bucketed,
        gather_arm,
        prepare_features,
    )

    src_np, tgt_np, R_true, t_true = make_pair(N_POINTS, voxel=VOXEL)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL)
    src = tpu3d_torch.PointCloud.from_numpy(src_np, device=dev)
    tgt = tpu3d_torch.PointCloud.from_numpy(tgt_np, device=dev)
    sd = downsample_bucketed(src, cfg)
    td = downsample_bucketed(tgt, cfg)
    check(sd.capacity == td.capacity == 8192, f"bucket {sd.capacity}")
    down = sd
    sd, sf = prepare_features(sd, cfg)
    td, tf = prepare_features(td, cfg)
    torch.cuda.synchronize()
    log(f"bucket 8192: {sd.count()} / {td.count()} rows")
    # The gather arm's graph replay against the same arm run eagerly.
    radius = float(np.float32(VOXEL * 5.0))
    _, eager, eager_feat = gather_arm(down, radius)
    check(torch.equal(sd.normals, eager.normals)
          and torch.equal(sf.descriptors, eager_feat.descriptors),
          "the gather graph's replay differs from the eager arm")
    gather_ms = {
        "eager_ms": cuda_ms(torch, lambda: gather_arm(down, radius)),
        "replay_ms": cuda_ms(torch, lambda: prepare_features(down, cfg)),
    }
    log(f"bucket 8192 gather arm, one cloud: {gather_ms}")

    k5, k6, k7, k7m, k12 = {}, {}, {}, {}, {}
    sfx = "_b8192"
    knn_select_phase(torch, neighbors, dev, k12, (down.points, down.mask))
    nn_phase(torch, nn, sf.descriptors, sd.mask, tf.descriptors, tf.mask,
             sfx, k5)
    nn_phase(torch, nn, sd.points, sd.mask, td.points, td.mask,
             "_d3" + sfx, k5)

    corr = ransac.feature_correspondences(sf, tf).long()
    p, qq = sd.points, td.points[corr]
    count = sd.count()
    feat, pq = ransac.build_scoring_factors(p, qq, sd.mask)
    table = ransac.build_rotation_table(torch.cat([p, qq], 1), sd.mask, count)
    draw = ransac.torch_draws(cfg.ransac_seed)
    iters = cfg.ransac_max_iterations
    w16t, tn, _, _, _ = ransac.solve_rotation_chunk(
        lambda e: draw(0, e), ransac.hypothesis_chunk(iters), 0, table,
        count, iters)
    feat_e, pq_e = ransac.build_scoring_factors(
        *(ransac.strided_rows(x, 2048) for x in (p, qq, sd.mask)))
    thr2 = float((np.float32(VOXEL) * np.float32(1.5)) ** 2)
    score_phase(torch, ransac_score, (feat_e, pq_e, w16t, tn, thr2), sfx, k6)
    score_phase(torch, ransac_score,
                (feat, pq, w16t[:, :32].contiguous(), tn[:32], thr2),
                "_finalists" + sfx, k6)

    T_true = torch.eye(4, device=dev)
    T_true[:3, :3] = torch.from_numpy(R_true).to(dev)
    T_true[:3, 3] = torch.from_numpy(t_true).to(dev)
    icp_phase(torch, icp, icp_stats, icp.build_icp_target(td), sd.points,
              sd.mask, T_true, VOXEL * cfg.icp_distance_factor, sfx, k7,
              k7m)

    def pair():
        return tpu3d_torch.register_pair(src, tgt, cfg)

    pair()  # warm: allocator and library state
    counters = (nn.nearest_neighbor, ransac_score.score_hypotheses,
                icp_stats.icp_p2plane_stats, neighbors.knn_select)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined, coarse = pair()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = [c.launches for c in counters]
    log(f"bucket 8192 main path launches K5/K6/K7/K12: {launches}")
    check(all(n > 0 for n in launches), f"a kernel did not launch: {launches}")
    # Two clouds, each one graph replay of 8 chunks of K12.
    check(launches[3] == 2 * 8, f"K12 launched {launches[3]} times, not 16")
    for k, n in zip((k5, k6, k7, k12), launches):
        k["launches" + sfx] = n
    rot_err, trn_err = gate(np, refined, R_true, t_true)
    times = [first_ms] + host_ms(torch, pair, warm=0, reps=2)[0]

    stage = Stages(torch)
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
    route = {
        "route": "reference parity", "main_path": "tpu3d_torch.register_pair",
        "fixture": f"make_pair({N_POINTS}, voxel={VOXEL})",
        "bucket": sd.capacity, "pair_ms": times,
        "pair_ms_median": statistics.median(times), "stages_ms": stage.ms,
        "fitness": float(refined.fitness),
        "coarse_fitness": float(coarse.fitness), "rot_err": rot_err,
        "trans_err": trn_err, "launches": launches,
        "gather_arm_one_cloud": gather_ms,
        "point_to_point": knob_pair(
            torch, np, src, tgt, tpu3d_torch.RegistrationConfig(
                voxel_size=VOXEL, use_point_to_plane=False),
            R_true, t_true, "bucket 8192, point-to-point", k7m, sfx),
    }
    return k5, k6, k7, k7m, k12, route


def knob_pair(torch, np, src, tgt, cfg, R_true, t_true, label, k7m=None,
              sfx=""):
    """``register_pair`` with ``cfg``'s two_stage or use_point_to_plane
    knob: the route it asks for ran (the two-stage scorer, or K7's
    match-only epilogue and never its sums), the quality gate, and warm
    pair times. Puts the epilogue's launches into ``k7m``."""
    import tpu3d_torch
    from tpu3d_torch.ops import icp_stats, ransac

    calls = []
    two_stage = ransac._two_stage

    def counted(*a):
        calls.append(1)
        return two_stage(*a)

    def pair():
        return tpu3d_torch.register_pair(src, tgt, cfg)

    ransac._two_stage = counted
    try:
        pair()  # warm
        calls.clear()
        icp_stats.icp_matches.launches = 0
        icp_stats.icp_p2plane_stats.launches = 0
        ransac.gather_hypotheses.launches = 0
        torch.cuda.synchronize()
        times, (refined, coarse) = host_ms(torch, pair, warm=0, reps=3)
    finally:
        ransac._two_stage = two_stage
    matches = icp_stats.icp_matches.launches
    sums = icp_stats.icp_p2plane_stats.launches
    k11 = ransac.gather_hypotheses.launches
    if cfg.use_point_to_plane:
        check(calls, f"{label}: the two-stage scorer did not run")
        check(k11 > 0, f"{label}: K11 did not launch")
    else:
        check(matches > 0 and sums == 0,
              f"{label}: K7 match-only {matches}, sums {sums} launches")
    if k7m is not None:
        k7m["launches" + sfx] = matches // 3
    rot_err, trn_err = gate(np, refined, R_true, t_true)
    log(f"{label}: pose error rot {rot_err:.2e} trans {trn_err:.2e} m, "
        f"fitness {float(refined.fitness):.5f}, coarse "
        f"{float(coarse.fitness):.5f}, pairs {[round(t, 2) for t in times]} "
        f"ms, two-stage scorer runs {len(calls) // 3}, K7 match-only "
        f"launches {matches // 3}, K11 launches {k11 // 3} a pair")
    return {
        "knob": label, "rot_err": rot_err, "trans_err": trn_err,
        "fitness": float(refined.fitness),
        "coarse_fitness": float(coarse.fitness), "pair_ms": times,
        "pair_ms_median": statistics.median(times),
        "two_stage_runs_per_pair": len(calls) // 3,
        "k7_match_only_launches_per_pair": matches // 3,
        "k7_sums_launches_per_pair": sums // 3,
        "k11_launches_per_pair": k11 // 3,
    }


def covered_columns(torch, lo, ln, m):
    """Columns of an m-column operand that some window [lo, lo + ln)
    covers."""
    live = ln > 0
    ones = torch.ones(int(live.sum()), dtype=torch.int64, device=lo.device)
    diff = torch.zeros(m + 1, dtype=torch.int64, device=lo.device)
    diff.index_add_(0, lo[live].long(), ones)
    diff.index_add_(0, (lo + ln)[live].long(), -ones)
    return int((diff.cumsum(0)[:m] > 0).sum())


def sweep_bytes(torch, q_rows, packed, lo, ln, block, out_values,
                every_query):
    """Bytes a prepare sweep must move: the ``q_rows`` query planes it
    reads (on every block when ``every_query``, else on blocks with a live
    window), the candidate planes' columns that some window covers, the
    window tables, and the ``out_values`` per row it returns."""
    nbk, mp = lo.shape[0], packed.shape[1]
    q_blocks = nbk if every_query else int((ln > 0).any(1).sum())
    covered = covered_columns(torch, lo, ln, mp)
    return 4 * (q_rows * q_blocks * block + packed.shape[0] * covered
                + out_values * mp) + nbytes(lo, ln)


def sweep_phase(torch, name, fn, plain, args, block, q8, entry, sfx,
                per_neighbour, q_rows, out_values, out_check,
                every_query=False, **kw):
    """One prepare sweep's kernel against its plain version."""
    ko = fn(*args, block, **kw)
    po = plain(*args, block, **kw)
    torch.cuda.synchronize()
    err = float((ko - po).abs().max())
    neighbours = out_check(ko, po)
    lo, ln = args[2], args[3]
    valid_b = (q8[3] > 0.5).reshape(-1, block).sum(1)
    pairs = int((valid_b * ln.sum(1)).sum())
    b_ms, b_by = bound(
        8.0 * pairs + per_neighbour * neighbours,
        sweep_bytes(torch, q_rows, args[1], lo, ln, block, out_values,
                    every_query))
    entry.update({
        f"max_abs_err{sfx}": err, f"pairs{sfx}": pairs,
        f"neighbours{sfx}": neighbours,
        f"ms{sfx}": cuda_ms(torch, lambda: fn(*args, block, **kw)),
        f"device_ms{sfx}": per_call_device_ms(
            torch, lambda: fn(*args, block, **kw)),
        f"plain_ms{sfx}": cuda_ms(torch, lambda: plain(*args, block, **kw)),
        f"bound_ms{sfx}": b_ms, f"bound_by{sfx}": b_by,
        f"library_ms{sfx}": None,
    })
    log(f"{name}{sfx}: max abs err {err:.3e}, {pairs} pairs, {neighbours} "
        f"neighbours, kernel {entry['ms' + sfx]:.4f} ms (device "
        f"{entry['device_ms' + sfx]:.4f}), plain "
        f"{entry['plain_ms' + sfx]:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return ko


def prepare_sweeps(torch, features, fused_features, al, lo, lens, block, r2,
                   entries, sfx, blocks=None):
    """K2, K3 and K4 against their plain versions on one aligned layout with
    windows ``lens`` (sweeps A, B, C), each fed the kernel chain's inputs;
    ``blocks`` K4's block list (the sparse prepare's query blocks)."""
    len_a, len_b, len_c = lens
    e2, e3, e4 = entries
    q8 = fused_features.moments_operands(al)
    mp = q8.shape[1]
    log(f"layout{sfx}: Mp {mp}, {mp // block} blocks of {block}; live "
        f"blocks A/B/C {[int((x > 0).any(1).sum()) for x in lens]}; window "
        f"rows mean {float(len_a.sum(1).float().mean()):.1f} max "
        f"{int(len_a.sum(1).max())}")

    def k2_check(ko, po):
        check(torch.equal(ko[3], po[3]), f"K2{sfx} counts differ")
        well = (po[3] >= 3) & (q8[3] > 0.5)
        cos = (ko[:3] * po[:3]).sum(0).abs()[well]
        log(f"K2{sfx}: normals |cos| min {float(cos.min()):.7f} on "
            f"{int(well.sum())} rows; bit for bit: {torch.equal(ko, po)}")
        check(int(well.sum()) > 0 and torch.equal(ko, po),
              f"K2{sfx} differs from its plain version")
        return int(po[3][q8[3] > 0.5].sum())

    sparse = blocks is not None
    nblocks = lo.shape[0]
    sms = torch.cuda.get_device_properties(q8.device).multi_processor_count
    # K2 reads xyz and validity and returns the normal and the count.
    k2_args = (q8, al.padded_points_t, lo, len_a, r2)
    nrm8 = sweep_phase(torch, "K2", features.moments_sweep,
                       features.moments_sweep_plain, k2_args, block, q8, e2,
                       sfx, 18.0, 4, 4, k2_check, every_query=True,
                       sparse=sparse)
    force_plans(torch, features, "K2", "moments_plan",
                features.moments_plan(block, nblocks, sparse, sms),
                {"block": (1, block // 32, 1), "halves": (2, block // 64, 1),
                 "tile2": (1, block // 64, 2), "tile4": (1, block // 128, 4),
                 "halves_tile2": (2, block // 128, 2)},
                k2_args, block, nrm8, e2, sfx, sparse)
    q8n, pb = fused_features.spfh_operands(al, nrm8)

    def k3_check(ko, po):
        check(torch.equal(ko[33], po[33]), f"K3{sfx} counts differ")
        live = po[33] > 0
        differ = ~(ko == po).all(0)
        ids = differ.nonzero()[:, 0].tolist()
        e3["rows_differing" + sfx] = len(ids)
        log(f"K3{sfx}: all 40 rows bit for bit on {ko.shape[1] - len(ids)} "
            f"of {ko.shape[1]} columns ({int(live.sum())} with neighbours); "
            f"differing (padded-row ids) {ids[:20]}")
        check(int(live.sum()) > 0 and not ids,
              f"K3{sfx} differs from its plain version")
        return int(po[33][q8n[3] > 0.5].sum())

    # K3 reads centred xyz, validity and the normal; returns 33 bins and the
    # count.
    k3_args = (q8n, pb, lo, len_b, r2)
    spfh40 = sweep_phase(torch, "K3", features.spfh_sweep,
                         features.spfh_sweep_plain, k3_args, block, q8n, e3,
                         sfx, 100.0, 7, 34, k3_check, sparse=sparse)
    force_plans(torch, features, "K3", "spfh_plan",
                features.spfh_plan(block, nblocks, sparse, sms),
                {"threads": (1, block // 32, False),
                 "lanes": (block // 32, 8, True)},
                k3_args, block, spfh40, e3, sfx, sparse)
    pc = fused_features.fpfh_operands(al, spfh40)

    def k4_check(ko, po):
        check(torch.equal(ko, po), f"K4{sfx} differs from its plain version")
        # Its neighbours are sweep B's (the same radius test on raw rather
        # than centred coordinates) on the blocks its own windows serve.
        rows = (q8[3] > 0.5) & (len_c > 0).any(1).repeat_interleave(block)
        return int(spfh40[33][rows].sum())

    # K4 reads raw xyz and returns 33 weighted sums.
    k4 = sweep_phase(torch, "K4", features.fpfh_sweep,
                     features.fpfh_sweep_plain, (q8, pc, lo, len_c, r2),
                     block, q8, e4, sfx, 69.0, 3, 33, k4_check,
                     blocks=blocks)
    if blocks is None:
        force_plans(torch, features, "K4", "fpfh_plan",
                    features.fpfh_plan(block, nblocks, False, sms),
                    {"threads": (1, block // 32), "lanes": (block // 32, 8)},
                    (q8, pc, lo, len_c, r2), block, k4, e4, sfx, None)


def force_plans(torch, features, name, plan_fn, chosen, forced, args, block,
                out, entry, sfx, sparse):
    """The sweep ``name`` under each launch of ``forced`` ({label: plan}),
    each forced through ``features.<plan_fn>``: bit for bit equal to the
    plan's own result ``out``, and each one's device ms per call, the data
    behind the plan's thresholds. ``chosen`` is the plan's own launch on
    this layout. ``sparse`` is passed to K2 and K3 (None: K4, which takes
    no such argument)."""
    plan = getattr(features, plan_fn)
    fn = {"K2": features.moments_sweep, "K3": features.spfh_sweep,
          "K4": features.fpfh_sweep}[name]
    kw = {} if sparse is None else {"sparse": sparse}
    nblocks = args[2].shape[0]
    entry[f"plan{sfx}"] = [k for k, v in forced.items() if v == chosen][0]
    try:
        for label, launch in forced.items():
            setattr(features, plan_fn, lambda *a, launch=launch: launch)
            check(torch.equal(fn(*args, block, **kw), out),
                  f"{name}{sfx}: the {label} launch differs")
            entry[f"device_ms_{label}{sfx}"] = per_call_device_ms(
                torch, lambda: fn(*args, block, **kw))
    finally:
        setattr(features, plan_fn, plan)
    log(f"{name}{sfx}: {nblocks} blocks, plan {entry['plan' + sfx]}; device "
        + ", ".join(f"{k} {entry[f'device_ms_{k}{sfx}']:.4f}"
                    for k in forced) + " ms")


def sparse_sweeps(torch, features, fused_features, cloud, radius, r2,
                  entries, sfx):
    """prepare_sweeps on the sparse prepare's operands: block 256, the
    member sets' windows and K4's block list, as fused_prepare_sparse
    builds them for 8,192 rows."""
    import numpy as np

    al, lo, ln = fused_features.aligned_layout(cloud, radius, 256)
    nq = 8192 // 256
    lens = fused_features.member_lengths(lo, ln, 256, nq)[:3]
    blocks = torch.from_numpy(fused_features.query_blocks(
        lo.shape[0], nq).astype(np.int32)).to(lo.device)
    prepare_sweeps(torch, features, fused_features, al, lo, lens, 256, r2,
                   entries, sfx, blocks=blocks)


def at_scale_route(torch, np, dev, n_points, voxel, k5, k6, k7, k7m, k10,
                   k11):
    """Phase 4: the at-scale route (sparse arm)."""
    import tpu3d_torch
    from tpu3d_torch import registration as reg
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.ops import (
        features,
        fused_features,
        icp,
        icp_stats,
        nn,
        ransac,
        ransac_score,
    )

    src_np, tgt_np, R_true, t_true = make_pair(n_points)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=voxel)
    src = tpu3d_torch.PointCloud.from_numpy(src_np, device=dev)
    tgt = tpu3d_torch.PointCloud.from_numpy(tgt_np, device=dev)
    sd = reg.downsample_bucketed(src, cfg)
    td = reg.downsample_bucketed(tgt, cfg)
    # compact() keeps the input's rows when the bucket is larger, as the
    # JAX package's does: the bucket of 100,352 input rows is 131,072, the
    # capacity 100,352.
    bucket = reg.bucket_capacity(td.count())
    check(td.capacity >= reg.FUSED_CAPACITY_THRESHOLD, f"rows {td.capacity}")
    check(reg.sparse_prepare_active(cfg, "fused", sd), "sparse arm inactive")
    log(f"at scale: {sd.count()} / {td.count()} rows, bucket {bucket}, "
        f"capacity {sd.capacity} / {td.capacity}")
    radius = float(np.float32(voxel * 5.0))
    r2 = float(np.float32(radius) * np.float32(radius))

    # --- a. K2, K3, K4 on both layouts the main path gives them -----------
    e2 = {"name": "moments_sweep (K2, three windows a block)", "route": "cuda",
          "source": "tpu3d_torch/csrc/features.cu",
          "replaces": "tpu3d/ops/features_pallas.py:200"}
    e3 = {"name": "spfh_sweep (K3, three windows a block)", "route": "cuda",
          "source": "tpu3d_torch/csrc/features.cu",
          "replaces": "tpu3d/ops/features_pallas.py:346"}
    e4 = {"name": "fpfh_sweep (K4, three windows a block)", "route": "cuda",
          "source": "tpu3d_torch/csrc/features.cu",
          "replaces": "tpu3d/ops/features_pallas.py:390"}
    sweeps = [(e2, features.moments_sweep), (e3, features.spfh_sweep),
              (e4, features.fpfh_sweep)]
    # The target's dense prepare: every window, block 128.
    al, lo, ln = fused_features.aligned_layout(td, radius, 128)
    prepare_sweeps(torch, features, fused_features, al, lo, (ln, ln, ln),
                   128, r2, (e2, e3, e4), "")
    # The source's sparse prepare: block 256, the member sets' windows.
    sparse_sweeps(torch, features, fused_features, sd, radius, r2,
                  (e2, e3, e4), "_sparse256")

    # --- b. sparse equals dense on the source, block 256 -------------------
    _, dense_f = fused_features.fused_prepare_features(sd, radius, block=256)
    sub_c, sub_f, sub_orig = fused_features.fused_prepare_sparse(sd, radius)
    sm = sub_f.mask
    same = torch.equal(sub_f.descriptors[sm],
                       dense_f.descriptors[sub_orig[sm]])
    log(f"sparse subset: {int(sm.sum())} valid of {sm.shape[0]} rows; "
        f"bit-identical to dense at block 256: {same}")
    check(same and int(sm.sum()) > 0, "sparse prepare differs from dense")

    # --- c. K5, K6, K7 at this route's shapes -----------------------------
    tdp, tf = reg.prepare_features(td, cfg, "fused")
    nn_phase(torch, nn, sub_f.descriptors, sm, tf.descriptors, tf.mask, "",
             k5, quality=(np, sub_c.points, tdp.points, R_true, t_true,
                          voxel))
    corr = ransac.feature_correspondences(sub_f, tf).long()
    p, qq = sub_c.points, tdp.points[corr]
    count = int(sm.sum())
    feat, pq = ransac.build_scoring_factors(p, qq, sm)
    table = ransac.build_rotation_table(torch.cat([p, qq], 1), sm, count)
    draw = ransac.torch_draws(cfg.ransac_seed)
    iters = cfg.ransac_max_iterations
    w16t, tn, _, _, _ = ransac.solve_rotation_chunk(
        lambda e: draw(0, e), ransac.hypothesis_chunk(iters), 0, table,
        count, iters)
    h = ransac.hypothesis_chunk(iters)
    params = torch.tensor(ransac.epoch_params(
        lambda e: draw(0, e), -(-h // (table.shape[1] // 2)), 0, count,
        iters), dtype=torch.int32, device=dev)
    hyp_phase(torch, ransac, table, params, h, "", k10)
    feat_e, pq_e = ransac.build_scoring_factors(
        *(ransac.strided_rows(x, 2048) for x in (p, qq, sm)))
    thr2 = float((np.float32(voxel) * np.float32(1.5)) ** 2)
    score_phase(torch, ransac_score, (feat_e, pq_e, w16t, tn, thr2), "", k6)
    score_phase(torch, ransac_score,
                (feat, pq, w16t[:, :32].contiguous(), tn[:32], thr2),
                "_finalists", k6)
    T_true = torch.eye(4, device=dev)
    T_true[:3, :3] = torch.from_numpy(R_true).to(dev)
    T_true[:3, 3] = torch.from_numpy(t_true).to(dev)
    stride = ransac.decimation_stride(sd.capacity, 16384)
    icp_phase(torch, icp, icp_stats, icp.build_icp_target(tdp),
              sd.points[: stride * 16384 : stride],
              sd.mask[: stride * 16384 : stride], T_true,
              voxel * cfg.icp_distance_factor, "", k7, k7m)
    k7["library_ms"] = None
    k7m["library_ms"] = None

    # --- d. the main path ---------------------------------------------------
    def pair():
        return tpu3d_torch.register_pair(src, tgt, cfg)

    pair()  # warm: allocator and library state
    counters = [k for _, k in sweeps] + [
        nn.nearest_neighbor, ransac_score.score_hypotheses,
        icp_stats.icp_p2plane_stats, ransac.rotation_hypotheses]
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined, coarse = pair()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    launches = [c.launches for c in counters]
    log(f"at-scale main path launches K2/K3/K4/K5/K6/K7/K10: {launches}")
    check(all(n > 0 for n in launches), f"a kernel did not launch: {launches}")
    entries = [e for e, _ in sweeps] + [k5, k6, k7, k10]
    for e, n in zip(entries, launches):
        e["launches"] = n
    rot_err, trn_err = gate(np, refined, R_true, t_true)
    log(f"at scale: refined fitness {float(refined.fitness):.5f} rmse "
        f"{float(refined.rmse):.6f}, coarse fitness "
        f"{float(coarse.fitness):.5f}; pose error rot {rot_err:.2e} trans "
        f"{trn_err:.2e} m")
    times = [first_ms] + host_ms(torch, pair, warm=0, reps=3)[0]

    stage = Stages(torch)
    s_d = stage("downsample_ms", lambda: (reg.downsample_bucketed(src, cfg),
                                          reg.downsample_bucketed(tgt, cfg)))
    t_p = stage("prepare_target_ms",
                lambda: reg.prepare_features(s_d[1], cfg, "fused"))
    s_p = stage("prepare_source_sparse_ms",
                lambda: fused_features.fused_prepare_sparse(s_d[0], radius))
    co = stage("ransac_ms", lambda: ransac.ransac_registration(
        s_p[0], t_p[0], s_p[1], t_p[1], voxel,
        max_iterations=cfg.ransac_max_iterations,
        confidence=cfg.ransac_confidence, seed=cfg.ransac_seed,
        corr_mode="exact"))
    stage("icp_ms", lambda: icp.icp_refine(
        s_d[0], t_p[0], co.transformation, voxel * cfg.icp_distance_factor,
        max_iterations=cfg.icp_max_iterations))
    _, _, escalated = stage("sparse_arm_ms", lambda: (
        reg.sparse_register_escalated(
            s_d[0], t_p[0], t_p[1], voxel=voxel, radius=radius,
            escalate_below=cfg.min_fitness)))
    route = {
        "route": "at scale (sparse arm)",
        "main_path": "tpu3d_torch.register_pair",
        "fixture": f"make_pair({n_points}), voxel {voxel}",
        "bucket": bucket, "capacity": [sd.capacity, td.capacity],
        "rows": [sd.count(), td.count()],
        "escalated": bool(escalated), "pair_ms": times,
        "pair_ms_median": statistics.median(times), "stages_ms": stage.ms,
        "fitness": float(refined.fitness),
        "coarse_fitness": float(coarse.fitness), "rot_err": rot_err,
        "trans_err": trn_err, "launches": launches, "peak_mem_mb": peak_mb,
        "device_busy_ms": device_busy_ms(torch, pair),
        "two_stage": knob_pair(
            torch, np, src, tgt, tpu3d_torch.RegistrationConfig(
                voxel_size=voxel, two_stage="on"),
            R_true, t_true, "at scale, two_stage on"),
        "point_to_point": knob_pair(
            torch, np, src, tgt, tpu3d_torch.RegistrationConfig(
                voxel_size=voxel, use_point_to_plane=False),
            R_true, t_true, "at scale, point-to-point", k7m),
    }
    # K11 on the same rows at the gather routes' sizes: a chunk of this
    # budget, the 64 batch's one shot (4,096) and the two-stage one shot;
    # after the main path, so that its times follow what the parent's do.
    perm = torch.sort((~sm).to(torch.int8), stable=True)[1]
    pq_packed = torch.cat([p, qq], 1)
    h_two = -(-iters // 512) * 512
    for h_g, max_it, sfx in ((h, iters, ""), (4096, 4096, "_batch"),
                             (h_two, iters, "_two_stage")):
        gather_phase(torch, ransac, perm, pq_packed, count, h_g, max_it,
                     cfg.ransac_seed, sfx, k11)
    return [e for e, _ in sweeps], route


def hyp_phase(torch, ransac, table, params, h, suffix, entry):
    """K10 against its plain version run on the card, on one chunk's
    table and params: the flags equal and the w16 columns and ‖t‖² bit for
    bit (both round each operation once and contract the same products)."""
    kw, kt, kd = ransac.rotation_hypotheses(table, params, h)
    pw, pt, pd = ransac.rotation_hypotheses_plain(table, params, h)
    torch.cuda.synchronize()
    err = max(float((kw - pw).abs().max()), float((kt - pt).abs().max()))
    same = float(((kw == pw).all(0) & (kt == pt)).float().mean())
    flags = bool(torch.equal(kd, pd))
    log(f"K10{suffix} H={h} table {tuple(table.shape)}: max |w16 diff| "
        f"{err:.3e}, columns bit for bit {same:.6f}, flags equal {flags}, "
        f"disabled {int(kd.sum())}")
    check(flags and err == 0.0, f"K10{suffix} disagrees with its plain "
          f"version: max diff {err}, flags equal {flags}")
    b_ms, b_by = bound(ransac.FLOPS_PER_HYPOTHESIS * h,
                       nbytes(table, params, kw, kt, kd))
    entry.update({
        f"max_abs_err{suffix}": err, f"bit_for_bit{suffix}": same,
        f"ms{suffix}": cuda_ms(
            torch, lambda: ransac.rotation_hypotheses(table, params, h)),
        f"plain_ms{suffix}": cuda_ms(
            torch, lambda: ransac.rotation_hypotheses_plain(table, params,
                                                            h)),
        f"bound_ms{suffix}": b_ms, f"bound_by{suffix}": b_by,
        f"device_ms{suffix}": per_call_device_ms(
            torch, lambda: ransac.rotation_hypotheses(table, params, h)),
        f"library_ms{suffix}": None,
    })
    log(f"K10{suffix}: {entry['ms' + suffix]:.4f} ms (device "
        f"{entry['device_ms' + suffix]:.4f}), plain "
        f"{entry['plain_ms' + suffix]:.4f}, bound {b_ms:.5f} ({b_by})")


def gather_phase(torch, ransac, perm, pq, count, h, max_it, seed, suffix,
                 entry):
    """K11 against its plain version run on the card, on ``h`` triples of
    the default draw stream over these rows: the flags equal and the w16
    columns and ‖t‖² bit for bit (both round each operation once, in one
    order)."""
    tri = ransac.torch_draws(seed).triples(None, h, count)
    params = ransac.gather_params(tri, 0, max_it, perm.shape[0]).to(
        perm.device)
    kw, kt, kd = ransac.gather_hypotheses(params, perm, pq, h)
    pw, pt, pd = ransac.gather_hypotheses_plain(params, perm, pq, h)
    torch.cuda.synchronize()
    err = max(float((kw - pw).abs().max()), float((kt - pt).abs().max()))
    same = float(((kw == pw).all(0) & (kt == pt)).float().mean())
    flags = bool(torch.equal(kd, pd))
    log(f"K11{suffix} H={h} on {perm.shape[0]} rows ({count} valid): max "
        f"|w16 diff| {err:.3e}, columns bit for bit {same:.6f}, flags equal "
        f"{flags}, disabled {int(kd.sum())}")
    check(flags and err == 0.0 and same == 1.0,
          f"K11{suffix} disagrees with its plain version: max diff {err}, "
          f"flags equal {flags}")
    # Bytes: the params, the outputs, and only the rows of perm and pq
    # that this run's draws reach (each read once).
    rows = perm[torch.unique(params[2:2 + 3 * h].long())]
    b_ms, b_by = bound(ransac.GATHER_FLOPS_PER_HYPOTHESIS * h,
                       nbytes(params, rows, pq[rows], kw, kt, kd))
    entry.update({
        f"max_abs_err{suffix}": err, f"bit_for_bit{suffix}": same,
        f"shape{suffix}": [h, perm.shape[0], count],
        f"rows_read{suffix}": rows.numel(),
        f"ms{suffix}": cuda_ms(
            torch, lambda: ransac.gather_hypotheses(params, perm, pq, h)),
        f"plain_ms{suffix}": cuda_ms(
            torch, lambda: ransac.gather_hypotheses_plain(params, perm, pq,
                                                          h)),
        f"bound_ms{suffix}": b_ms, f"bound_by{suffix}": b_by,
        f"device_ms{suffix}": per_call_device_ms(
            torch, lambda: ransac.gather_hypotheses(params, perm, pq, h)),
        f"library_ms{suffix}": None,
    })
    log(f"K11{suffix}: {entry['ms' + suffix]:.4f} ms (device "
        f"{entry['device_ms' + suffix]:.4f}), plain "
        f"{entry['plain_ms' + suffix]:.4f}, bound {b_ms:.5f} ({b_by})")


def per_call_device_ms(torch, fn, calls=10):
    """Device time of one call of ``fn``: ``calls`` calls enqueued behind a
    device-side sleep, so that the host's launch gaps between them do not
    show, timed by two CUDA events, over ``calls``. (The profiler's
    per-kernel sums came back empty for some calls late in a long run.)
    ``fn`` must not synchronise."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms: the host queues the calls
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_profile(torch, fn, top=10):
    """(device time summed over one call of ``fn``, its ``top`` device
    entries by ms as [name, ms]) from torch.profiler's key averages.

    Only the device's own rows count (kernels, copies, sets): a host op's
    row carries the device time of the kernels it launched too, so a sum
    over every row counts each kernel twice (the log line gives both). A
    host range (the program's ``tpu3d:`` spans) shows on the device's
    timeline as a user annotation as long as the range: not a device row."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, every_row = [], 0.0
    for ev in prof.key_averages():
        if (getattr(ev, "is_user_annotation", False)
                or ev.key.startswith("tpu3d:")):
            continue
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        every_row += ms
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            rows.append((ev.key, ms))
    total = sum(ms for _, ms in rows)
    log(f"device profile: {total:.3f} ms on the device's rows, {every_row:.3f}"
        f" ms over every row")
    return (total,
            [[k, ms] for k, ms in sorted(rows, key=lambda r: -r[1])[:top]])


def device_busy_ms(torch, fn):
    """Device kernel time summed over one call of ``fn`` (torch.profiler)."""
    return device_profile(torch, fn)[0]


def bin_masks(np, width, height):
    """The bin frame's four instance masks (u8, 255 inside): at 1280 x 720,
    three squares of 320 px, which share one capacity bucket (a batched
    group on the sparse arm), and one of 74 px on a bump-rich patch that
    registers (~790 rows, bucket 1,024: the gather sampler)."""
    big, small = width // 4, width * 37 // 640
    boxes = [(width // 32, height // 18, big),
             (3 * width // 8, height // 2, big),
             (45 * width // 64, height // 12, big),
             (width * 579 // 640, height * 67 // 80, small)]
    masks = []
    for x0, y0, side in boxes:
        m = np.zeros((height, width), np.uint8)
        m[y0:y0 + side, x0:x0 + side] = 255
        masks.append(m)
    return masks


def k9_phase(torch, depth, depth_m, sigma_s, sfx, entry):
    """K9 against its plain version on one masked frame (5a)."""
    ko = depth.bilateral_filter(depth_m, sigma_s, 0.05)
    po = depth.bilateral_filter_plain(depth_m, sigma_s, 0.05)
    torch.cuda.synchronize()
    err = float((ko - po).abs().max())
    zeros_equal = torch.equal(ko == 0, po == 0)
    # The work this frame needs: one tap (~8 operations and one expf) for
    # every non-zero neighbour of every non-zero centre.
    r = depth.bf_radius(sigma_s)
    h, w = depth_m.shape
    nz = torch.nn.functional.pad((depth_m > 0).to(torch.int32), (r, r, r, r))
    nbrs = sum(nz[dy:dy + h, dx:dx + w]
               for dy in range(2 * r + 1) for dx in range(2 * r + 1))
    taps = int(nbrs[depth_m > 0].sum())
    b_ms, b_by = bound(8.0 * taps, 2 * 4 * h * w)
    # expf on the special-function units: 16 per clock per SM, 132 SMs at
    # the 1.98 GHz boost clock.
    sfu_ms = taps / (16 * 132 * 1.98e9) * 1e3
    entry.update({
        f"max_abs_err{sfx}": err, f"radius{sfx}": r, f"taps{sfx}": taps,
        f"ms{sfx}": cuda_ms(
            torch, lambda: depth.bilateral_filter(depth_m, sigma_s, 0.05)),
        f"device_ms{sfx}": per_call_device_ms(
            torch, lambda: depth.bilateral_filter(depth_m, sigma_s, 0.05)),
        f"plain_ms{sfx}": cuda_ms(
            torch, lambda: depth.bilateral_filter_plain(depth_m, sigma_s,
                                                        0.05)),
        f"bound_ms{sfx}": b_ms, f"bound_by{sfx}": b_by,
        f"sfu_floor_ms{sfx}": sfu_ms, f"library_ms{sfx}": None,
    })
    log(f"K9{sfx} {h}x{w} r={r}: {taps} taps, max abs err {err:.3e}, zero "
        f"sets equal {zeros_equal}, kernel {entry['ms' + sfx]:.4f} ms, plain "
        f"{entry['plain_ms' + sfx]:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
        f"expf floor {sfu_ms:.5f} ms")
    check(zeros_equal and torch.equal(ko, po),
          f"K9{sfx} differs from its plain version: {err}")
    # The kernel's occupancy on this frame: its CTAs cover 32 x 16 pixels
    # (a warp 32 x 2); a CTA with a centre above zero stages its halo, a
    # warp with one runs the taps. Resident on the card's SMs at once.
    live = torch.nn.functional.pad(depth_m > 0, (0, (-w) % 32, 0, (-h) % 16))
    warps = live.reshape(-1, 2, live.shape[1] // 32, 32).any(3).any(1)
    ctas = warps.reshape(-1, 8, warps.shape[1]).any(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    entry.update({
        f"ctas{sfx}": ctas.numel(), f"live_ctas{sfx}": int(ctas.sum()),
        f"live_warps{sfx}": int(warps.sum()),
        f"resident_warps_per_sm{sfx}": 8 * int(ctas.sum()) / sms,
    })
    log(f"K9{sfx}: {entry['live_ctas' + sfx]} of {ctas.numel()} CTAs live, "
        f"{entry['live_warps' + sfx]} warps in the taps, "
        f"{entry['resident_warps_per_sm' + sfx]:.1f} warps an SM")


def launch_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def reset_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def cli_demo(torch, counters, tmp):
    """5b: ``python -m tpu3d_torch`` on the repository's config with the
    bilateral filter on and no viewer."""
    import tpu3d_torch.__main__ as cli

    with open(os.path.join(REPO, "config", "pipeline_config.yaml")) as f:
        text = f.read()
    for old, new in (("bilateral_filter: false", "bilateral_filter: true"),
                     ('visualization: "opengl"', 'visualization: "none"')):
        check(text.count(old) == 1, f"config has no single '{old}'")
        text = text.replace(old, new)
    path = os.path.join(tmp, "pipeline_config.yaml")
    with open(path, "w") as f:
        f.write(text)

    made = []

    class Recorded(cli.Pipeline):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    from tpu3d_torch.ops import ransac

    saved, cli.Pipeline = cli.Pipeline, Recorded
    reset_counts(counters)
    ransac.rotation_hypotheses.launches = 0
    ransac.gather_hypotheses.launches = 0
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rc = cli.main([path])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        cli.Pipeline = saved
    launches = launch_counts(counters)
    # The demo's 8,192-row correspondence subset takes the rotation
    # sampler: K10, not K11.
    hyp_launches = {"K10": ransac.rotation_hypotheses.launches,
                    "K11": ransac.gather_hypotheses.launches}
    pipe = made[0] if made else None
    log(f"CLI demo: rc {rc}, {ms:.1f} ms, launches {launches}, "
        f"{hyp_launches}")
    check(rc == 0 and pipe is not None, f"CLI rc {rc}")
    check(pipe.device.type == "cuda", f"CLI ran on {pipe.device}")
    check(len(pipe.waypoints) == 1, f"{len(pipe.waypoints)} waypoints")
    check(pipe._degraded == 0, f"{pipe._degraded} error branches ran")
    check(pipe._host_icp_retries == 0, "the host ICP retry ran")
    check(launches["K9"] > 0, "K9 did not launch in the CLI demo")
    res = pipe.instance_results[0]
    return {
        "route": "CLI demo", "main_path": "python -m tpu3d_torch",
        "config": "config/pipeline_config.yaml, bilateral_filter: true, "
                  "visualization: none",
        "rc": rc, "ms": ms, "waypoints": len(pipe.waypoints),
        "fitness": res["fitness"], "coarse_fitness": res["coarse_fitness"],
        "launches": launches, "hyp_launches": hyp_launches,
    }


class RunProbe:
    """Host-clock stage times of one ``Pipeline.run()``, from wrappers
    around the pipeline's own functions and methods (synchronised at each
    boundary); it also keeps what the prepare and register stages saw."""

    def __init__(self, torch, pl, pipe):
        self.torch, self.pl, self.pipe = torch, pl, pipe
        self.marks, self.prepared, self.reference = {}, {}, None
        self.poses = None

    def _timed(self, name, fn):
        def wrapped(*a, **k):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.marks.setdefault(name, []).append((t0, time.perf_counter()))
            return out
        return wrapped

    @contextlib.contextmanager
    def patched(self):
        pl, pipe = self.pl, self.pipe
        funcs = {n: getattr(pl, n) for n in
                 ("get_masks", "load_ply", "filter_duplicates")}
        prepare, register = pipe.prepare_instance, pipe._register_instances

        def prepare_kept(mask, depth_raw, rgb, K, i):
            out = prepare(mask, depth_raw, rgb, K, i)
            self.prepared[i] = out
            return out

        def register_kept(prepared, ref_cloud, ref_features):
            self.reference = (ref_cloud, ref_features)
            self.poses = register(prepared, ref_cloud, ref_features)
            return self.poses

        for n, fn in funcs.items():
            setattr(pl, n, self._timed(n, fn))
        pipe.prepare_instance = self._timed("prepare_instance", prepare_kept)
        pipe._register_instances = self._timed("register", register_kept)
        try:
            yield
        finally:
            for n, fn in funcs.items():
                setattr(pl, n, fn)
            del pipe.prepare_instance, pipe._register_instances

    def run(self):
        """(waypoints, host ms, stage ms) of one ``run()``."""
        self.marks, self.prepared = {}, {}
        with self.patched(), contextlib.redirect_stdout(sys.stderr):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            waypoints = self.pipe.run()
            self.torch.cuda.synchronize()
            t1 = time.perf_counter()
        m = self.marks
        masks1 = m["get_masks"][0][1]
        prep0 = min(s for s, _ in m["prepare_instance"])
        prep1 = max(e for _, e in m["prepare_instance"])
        (reg0, reg1), = m["register"]
        (dd0, dd1), = m["filter_duplicates"]
        stages = {"frame_and_masks_ms": (masks1 - t0) * 1e3}
        # A run that keeps the model's downsampled cloud reads no PLY: its
        # reference stage is the model's normals and FPFH alone.
        if "load_ply" in m:
            (ply0, ply1), = m["load_ply"]
            stages["load_reference_ms"] = (ply1 - ply0) * 1e3
            masks1 = ply1
        stages.update({
            "prepare_reference_ms": (prep0 - masks1) * 1e3,
            "prepare_instances_ms": (prep1 - prep0) * 1e3,
            "register_instances_ms": (reg1 - reg0) * 1e3,
            "dedup_ms": (dd1 - dd0) * 1e3,
        })
        total = (t1 - t0) * 1e3
        stages["other_ms"] = total - sum(stages.values())
        return waypoints, total, stages


def bin_frame_route(torch, np, counters, tmp, frame, K, voxel=0.002,
                    knobs=False, entries=None):
    """5c: ``Pipeline.run()`` on the bin frame, from files as a user feeds
    it: the depth PNG and a gray RGB PNG as dummy data, four mask PNGs in
    a mask directory, and the reference model as a PLY file (the frame
    itself, unfiltered, so every instance's true pose is the identity).
    ``knobs``: once more with ``two_stage: on`` and ``use_point_to_plane:
    false``, two runs, K7 counted by its match-only epilogue, held to the
    same checks. ``entries``
    (the kernels line's K2, K3, K4, K7 entries): those kernels against
    their plain versions at this frame's shapes, after the run."""
    import cv2

    from tpu3d_torch.config import PipelineConfig
    from tpu3d_torch.models.ply import save_ply
    from tpu3d_torch.ops import deproject, depth
    from tpu3d_torch.pipeline import pipeline as pl

    height, width = frame.shape
    # run() reads dummy data with these intrinsics.
    check(np.array_equal(K, np.array([[900, 0, 640], [0, 900, 360],
                                      [0, 0, 1]], np.float32)),
          f"the bin frame's intrinsics differ from run()'s: {K}")
    cfg = PipelineConfig()
    cfg.use_camera = cfg.use_robot = False
    cfg.visualization = "none"
    cfg.camera.width, cfg.camera.height = width, height
    cfg.depth.scale_to_meters = 10000.0
    cfg.depth.bilateral_filter = True
    cfg.registration.voxel_size = voxel
    if knobs:
        cfg.registration.two_stage = "on"
        cfg.registration.use_point_to_plane = False
    cfg.camera_extrinsics = np.eye(4, dtype=np.float32)
    cfg.dummy_depth_path = os.path.join(tmp, "bin_depth.png")
    cfg.dummy_rgb_path = os.path.join(tmp, "bin_rgb.png")
    cfg.segmentation.masks_input_dir = os.path.join(tmp, "bin_masks")
    cfg.reference_model_path = os.path.join(tmp, "bin_frame.ply")
    check(cv2.imwrite(cfg.dummy_depth_path, frame)
          and cv2.imwrite(cfg.dummy_rgb_path,
                          np.full((height, width, 3), 90, np.uint8)),
          "could not write the frame's PNGs")
    os.makedirs(cfg.segmentation.masks_input_dir, exist_ok=True)
    for i, m in enumerate(bin_masks(np, width, height)):
        cv2.imwrite(os.path.join(cfg.segmentation.masks_input_dir,
                                 f"mask_{i}.png"), m)
    with contextlib.redirect_stdout(sys.stderr):
        pipe = pl.Pipeline(cfg, sleep_fn=lambda s: None)
    d_m = depth.depth_preprocess(
        torch.from_numpy(frame.astype(np.float32)).to(pipe.device), None,
        cfg.depth.scale_to_meters)
    cloud = deproject.deproject(d_m, None, torch.from_numpy(K),
                                cfg.depth.clipping_max)
    save_ply(cfg.reference_model_path, cloud.points[cloud.mask].cpu().numpy())
    probe = RunProbe(torch, pl, pipe)

    from tpu3d_torch.ops import ransac

    reset_counts(counters)
    ransac.rotation_hypotheses.launches = 0
    ransac.gather_hypotheses.launches = 0
    torch.cuda.reset_peak_memory_stats()
    waypoints, first_ms, _ = probe.run()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    launches = launch_counts(counters)
    # K10 runs where an instance takes the rotation sampler (n >= 2,048;
    # not with two_stage on), K11 where it takes the gather sampler (the
    # 74-px instance's chunks; every instance with two_stage on).
    k10_launches = ransac.rotation_hypotheses.launches
    k11_launches = ransac.gather_hypotheses.launches
    log(f"bin frame: launches {launches}, K10 {k10_launches}, K11 "
        f"{k11_launches}")
    check(k11_launches > 0, "K11 did not launch on the bin frame")
    prepared = [probe.prepared[i] for i in range(len(probe.prepared))]
    poses = probe.poses
    check(len(prepared) == 4 and all(p is not None for p in prepared),
          "an instance was not prepared")
    check(all(p is not None for p in poses), "an instance has no pose")
    check(pipe._degraded == 0, f"{pipe._degraded} error branches ran")
    check(pipe._host_icp_retries == 0, "the host ICP retry ran")
    check(all(n > 0 for n in launches.values()),
          f"a kernel did not launch: {launches}")
    check(len(waypoints) >= 1, "no waypoint")
    caps = [p[0].capacity for p in prepared]
    sparse = [p[1] is None for p in prepared]
    check(caps[0] == caps[1] == caps[2] and all(sparse[:3])
          and pipe._batched_groups == 1,
          f"the large instances did not batch on the sparse arm: {caps}, "
          f"{sparse}")
    check(caps[3] < 2048 and not sparse[3],
          f"the small instance's capacity is {caps[3]}")
    errs = []
    for T in poses:
        rot = float(np.abs(T[:3, :3] - np.eye(3)).max())
        trn = float(np.abs(T[:3, 3]).max())
        errs.append((rot, trn))
        check(np.isfinite(T).all() and rot < 0.02 and trn < 0.005,
              f"quality gate failed: rotation {rot}, translation {trn}")
    results = sorted(pipe.instance_results, key=lambda r: r["instance_id"])
    log(f"bin frame{' (two_stage on, point-to-point)' if knobs else ''}: "
        f"capacities {caps}, fitness "
        f"{[round(r['fitness'], 5) for r in results]}, pose errors {errs}, "
        f"{len(waypoints)} waypoints after dedup, {first_ms:.1f} ms cold")
    if knobs:
        again = probe.run()[1]
        check(same_poses(np, poses, probe.poses),
              "a second run's poses differ from the first's")
        return {
            "route": "pipeline, bin frame, two_stage: on, "
                     "use_point_to_plane: false",
            "degraded": pipe._degraded, "instance_capacities": caps,
            "fitness": [r["fitness"] for r in results],
            "coarse_fitness": [r["coarse_fitness"] for r in results],
            "pose_errors": errs,
            "launches": launches, "k10_launches": k10_launches,
            "k11_launches": k11_launches,
            "pipeline_ms_cold": first_ms, "pipeline_ms_warm": again,
        }
    if entries is not None:
        bin_shapes(torch, np, probe, voxel, entries)

    warm = []
    for _ in range(2):
        warm.append(probe.run())
        check(same_poses(np, poses, probe.poses),
              "a warm run's poses differ from the cold run's")
        check("load_reference_ms" not in warm[-1][2],
              "a warm run read the kept reference model again")
    # The model file touched: the run reads it again (natively), with the
    # same poses.
    st = os.stat(cfg.reference_model_path)
    os.utime(cfg.reference_model_path,
             ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    reload_ms, reload_stages = probe.run()[1:]
    check("load_reference_ms" in reload_stages,
          "a touched reference model was not read again")
    check(same_poses(np, poses, probe.poses),
          "the reloaded model's poses differ from the cold run's")
    # The same frame with RANSAC's chunks run eagerly, not replayed.
    ransac.CHUNK_GRAPH = False
    try:
        eager_ms = probe.run()[1]
    finally:
        ransac.CHUNK_GRAPH = True
    check(same_poses(np, poses, probe.poses),
          "the eager chunks' poses differ from the graph's")
    log(f"bin frame: eager chunks {eager_ms:.1f} ms, poses equal the "
        f"graph's")
    busy = device_busy_ms(torch, probe.run)
    return {
        "route": "pipeline, bin frame",
        "main_path": "Pipeline.run: dummy-data PNGs, mask directory, PLY "
                     "reference",
        "frame": [width, height], "voxel": voxel,
        "neighbor_mode": pipe._neighbor_mode,
        "reference_capacity": probe.reference[0].capacity,
        "instance_capacities": caps, "instance_rows": [
            p[0].count() for p in prepared],
        "sparse_arm": sparse, "batched_groups": pipe._batched_groups,
        "fitness": [r["fitness"] for r in results],
        "coarse_fitness": [r["coarse_fitness"] for r in results],
        "pose_errors": errs, "waypoints_after_dedup": len(waypoints),
        "launches": launches, "k10_launches": k10_launches,
        "k11_launches": k11_launches, "pipeline_ms_cold": first_ms,
        "pipeline_ms_warm": [ms for _, ms, _ in warm],
        "pipeline_ms_reload": reload_ms, "stages_ms_reload": reload_stages,
        "pipeline_ms_warm_eager_chunks": eager_ms,
        "stages_ms": warm[-1][2], "peak_mem_mb": peak_mb,
        "device_busy_ms": busy,
    }


def same_poses(np, a, b):
    """Whether two runs' poses are equal bit for bit."""
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


def bin_shapes(torch, np, probe, voxel, entries):
    """K2-K4 and K7 against their plain versions on what the bin frame's
    run gave them: the reference's dense prepare (block 128), the first
    instance's sparse one, and that instance's ICP against the reference
    at its true pose, the identity."""
    from tpu3d_torch.ops import features, fused_features, icp, icp_stats
    from tpu3d_torch.ops.ransac import decimation_stride

    e2, e3, e4, k7 = entries
    radius = float(np.float32(voxel * 5.0))
    r2 = float(np.float32(radius) * np.float32(radius))
    ref = probe.reference[0]
    al, lo, ln = fused_features.aligned_layout(ref, radius, 128)
    prepare_sweeps(torch, features, fused_features, al, lo, (ln, ln, ln),
                   128, r2, (e2, e3, e4), "_bin_reference")
    inst = probe.prepared[0][0]
    sparse_sweeps(torch, features, fused_features, inst, radius, r2,
                  (e2, e3, e4), "_bin_sparse")
    pts, mask = inst.points, inst.mask
    if pts.shape[0] >= 2 * 16384:  # icp_refine's source subset
        stride = decimation_stride(pts.shape[0], 16384)
        pts, mask = pts[: stride * 16384: stride], mask[: stride * 16384:
                                                         stride]
    icp_phase(torch, icp, icp_stats, icp.build_icp_target(ref), pts, mask,
              torch.eye(4, device=pts.device), voxel * 0.4, "_bin", k7)


def native_route(np, ply_path, masks, bin_route):
    """5d: the port's host runtime (g++ at first use): the native and numpy
    PLY readers equal on the bin frame's reference model, both timed; the
    native mask resize equal to the numpy nearest resize binarised at 10
    on the bin masks, halved and doubled, and timed against the numpy and
    cv2 resizes; the bin frame's warm ms (the model kept) and its PLY
    read on the main path, natively, in the run after the file was
    touched."""
    from tpu3d_torch import native
    from tpu3d_torch.models import ply

    check(native.available(), "the host runtime did not build")

    def timed(fn, reps=3):
        out = fn()  # warm
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t) * 1e3)
        return times, out

    available = native.available
    native.available = lambda: False  # the numpy reader
    try:
        numpy_ms, (pts_np, cols_np) = timed(lambda: ply.load_ply(ply_path))
    finally:
        native.available = available
    native_ms, out = timed(lambda: native.load_ply(ply_path))
    check(out is not None, "the native parser declined the bin frame's PLY")
    check(np.array_equal(out[0], pts_np) and out[1] is None
          and cols_np is None,
          "the native and numpy PLY readers differ on the bin frame")
    for mask in masks:
        h, w = mask.shape
        for oh, ow in ((h // 2, w // 2), (2 * h, 2 * w)):
            got = native.resize_mask_nearest_threshold(mask, oh, ow)
            ys = (np.arange(oh) * h / oh).astype(np.int64)
            xs = (np.arange(ow) * w / ow).astype(np.int64)
            want = np.where(mask[ys[:, None], xs[None, :]] > 10, 255,
                            0).astype(np.uint8)
            check(got is not None and np.array_equal(got, want),
                  f"the native mask resize differs at {oh} x {ow}")
    # The pipeline's resize: a mask at half the frame's size brought up to
    # the frame, by each path io.segmentation can take (cv2 where it is
    # installed), median of 20 calls each over the four masks.
    from tpu3d_torch.io import segmentation

    h, w = masks[0].shape
    halves = [np.ascontiguousarray(m[::2, ::2]) for m in masks]

    def numpy_resize(m):
        ys = (np.arange(h) * m.shape[0] / h).astype(np.int64)
        xs = (np.arange(w) * m.shape[1] / w).astype(np.int64)
        return m[ys[:, None], xs[None, :]]

    paths = {"native": lambda m: native.resize_mask_nearest_threshold(m, h, w),
             "numpy": numpy_resize}
    if segmentation.cv2 is not None:
        paths["cv2"] = lambda m: segmentation.cv2.resize(
            m, (w, h), interpolation=segmentation.cv2.INTER_NEAREST)
    resize_ms = {}
    for name, fn in paths.items():
        resize_ms[name] = statistics.median(
            timed(lambda: [fn(m) for m in halves], reps=20)[0]) / len(halves)
    log(f"native runtime: PLY of {len(pts_np)} points, native "
        f"{statistics.median(native_ms):.2f} ms, numpy "
        f"{statistics.median(numpy_ms):.2f} ms; mask resize "
        f"{(h // 2, w // 2)} -> {(h, w)} ms a mask: {resize_ms} (cv2 "
        f"{'installed' if 'cv2' in paths else 'not installed'}); bin frame "
        f"warm {bin_route['pipeline_ms_warm']} ms, load_reference "
        f"{bin_route['stages_ms_reload']['load_reference_ms']:.2f} ms")
    return {
        "route": "native host runtime",
        "main_path": "models.ply.load_ply (tpu3d_torch.native); the "
                     "resizes io.segmentation.resize_mask_nearest "
                     "chooses from",
        "ply_points": len(pts_np),
        "native_ply_ms": native_ms,
        "native_ply_ms_median": statistics.median(native_ms),
        "numpy_ply_ms": numpy_ms,
        "numpy_ply_ms_median": statistics.median(numpy_ms),
        "mask_resize_ms": resize_ms,
        "bin_frame_warm_ms": bin_route["pipeline_ms_warm"],
        "bin_frame_load_reference_ms":
            bin_route["stages_ms_reload"]["load_reference_ms"],
    }


def pipeline_phase(torch, np, counters, k9, entries):
    """Phase 5: K9 against its plain version, the CLI demo, the bin frame
    through the pipeline, also with both registration knobs set, and the
    host runtime on the bin frame's files."""
    from tpu3d_torch.ops import icp_stats

    import tempfile

    from tpu3d_torch.models.fixtures import bin_frame
    from tpu3d_torch.ops import depth

    frame, K = bin_frame()
    height, width = frame.shape
    dev = torch.device("cuda", 0)
    raw = torch.from_numpy(frame.astype(np.float32)).to(dev)
    masked = depth.depth_preprocess(
        raw, torch.from_numpy(bin_masks(np, width, height)[0]).to(dev),
        10000.0)
    k9_phase(torch, depth, masked, 2.0, "", k9)
    k9_phase(torch, depth, masked, 3.0, "_r5", k9)
    k9_phase(torch, depth, depth.depth_preprocess(raw, None, 10000.0), 2.0,
             "_full_frame", k9)
    # The floor of a launch: a frame with no centre above zero, where
    # every CTA writes zeros without staging a halo.
    zero = torch.zeros_like(masked)
    check(torch.equal(depth.bilateral_filter(zero, 2.0, 0.05), zero),
          "K9 on an all-zero frame is not zero")
    k9["device_ms_zero_frame"] = per_call_device_ms(
        torch, lambda: depth.bilateral_filter(zero, 2.0, 0.05))
    log(f"K9 all-zero frame: device {k9['device_ms_zero_frame']:.4f} ms")
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_demo(torch, counters, tmp)
        route = bin_frame_route(torch, np, counters, tmp, frame, K,
                                entries=entries)
        knob_counters = dict(counters, K7=icp_stats.icp_matches)
        route["knobs"] = bin_frame_route(torch, np, knob_counters, tmp,
                                         frame, K, knobs=True)
        host = native_route(np, os.path.join(tmp, "bin_frame.ply"),
                            bin_masks(np, width, height), route)
    return cli, route, host


# --------------------------------------------------------------------------
# Phase 6: the 1M-point scene
# --------------------------------------------------------------------------


def walk_sides(block):
    """Every launch K8's plan can take at ``block``: {label: (slices,
    per)}, a multiple of 32 threads a CTA."""
    return {f"s{s}q{p}": (s, p) for s in (1, 2, 4) for p in (1, 2, 4)
            if (block // (s * p)) % 32 == 0}


def force_walk_plans(torch, nn_walk, q4, packed, lo, ln, r2, block, sub,
                     label, entry, plain=False):
    """K8 under every launch its plan can take (``walk_sides``), forced
    through ``nn_walk.nn_walk_plan`` on the window tables given: each bit
    for bit equal to the plan's own launch (``plain``: which is held to
    the plain version first), and each one's device ms per call, the data
    behind the plan's thresholds; under entry["plan_sides"][label]."""
    plan = nn_walk.nn_walk_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = plan(block, lo.shape[0], sms)
    ref = nn_walk.top1_walk(q4, packed, lo, ln, r2, block, sub)
    if plain:
        pd, pi = nn_walk.top1_walk_plain(q4, packed, lo, ln, r2, block)
        check(torch.equal(ref[0], pd) and torch.equal(ref[1], pi),
              f"K8 {label} differs from its plain version")
    sides = walk_sides(block)
    row = {"block": block, "blocks": lo.shape[0],
           "plan": [k for k, v in sides.items() if v == chosen][0]}
    try:
        for side, launch in sides.items():
            nn_walk.nn_walk_plan = lambda *a, launch=launch: launch
            d2, idx = nn_walk.top1_walk(q4, packed, lo, ln, r2, block, sub)
            check(torch.equal(d2, ref[0]) and torch.equal(idx, ref[1]),
                  f"K8 {label}: the {side} launch differs")
            row[f"device_ms_{side}"] = per_call_device_ms(
                torch, lambda: nn_walk.top1_walk(q4, packed, lo, ln, r2,
                                                 block, sub))
    finally:
        nn_walk.nn_walk_plan = plan
    entry.setdefault("plan_sides", {})[label] = row
    log(f"K8 {label}: {row['blocks']} blocks of {block}, plan {row['plan']}; "
        "device " + ", ".join(f"{k} {row[f'device_ms_{k}']:.4f}"
                              for k in sides) + " ms")


def walk_phase(torch, nn_walk, q4, packed, lo, ln, r2, block, sub, sfx,
               entry):
    """K8 against its plain version on one set of window tables: d² and
    the index bit for bit on every row (rows without a match included),
    and its times."""
    kd, ki = nn_walk.top1_walk(q4, packed, lo, ln, r2, block, sub)
    pd, pi = nn_walk.top1_walk_plain(q4, packed, lo, ln, r2, block)
    torch.cuda.synchronize()
    n_idx = int((ki != pi).sum())
    err = float((kd - pd).abs().max())
    matched = int((pd < 1e29).sum())
    rows = ln.sum(1)
    valid_b = (q4[3] > 0.5).reshape(-1, block).sum(1)
    pairs = int((valid_b * rows).sum())
    log(f"K8{sfx}: {q4.shape[1]} queries x {packed.shape[1]} targets, "
        f"block {block}, K {lo.shape[1]}: {matched} matched, idx differing "
        f"on {n_idx} rows, d2 equal {torch.equal(kd, pd)}; window rows per "
        f"block mean {float(rows.float().mean()):.1f} max {int(rows.max())}, "
        f"longest window {int(ln.max())}, live windows per block mean "
        f"{float((ln > 0).sum(1).float().mean()):.2f}; {pairs} pairs")
    check(n_idx == 0 and torch.equal(kd, pd),
          f"K8{sfx} differs from its plain version")
    entry.update({
        f"max_abs_err{sfx}": err, f"idx_differing{sfx}": n_idx,
        f"matched{sfx}": matched, f"pairs{sfx}": pairs,
        f"window_rows_mean{sfx}": float(rows.float().mean()),
        f"window_rows_max{sfx}": int(rows.max()),
        f"longest_window{sfx}": int(ln.max()),
    })
    # ~9 operations per (query, window row) pair; bytes: the query planes,
    # the packed planes' covered columns, the window tables, d² and idx.
    b_ms, b_by = bound(9.0 * pairs, 4 * (
        4 * q4.shape[1] + 4 * covered_columns(torch, lo, ln, packed.shape[1])
        + 2 * q4.shape[1]) + nbytes(lo, ln))
    entry.update({
        f"ms{sfx}": cuda_ms(torch, lambda: nn_walk.top1_walk(
            q4, packed, lo, ln, r2, block, sub)),
        f"device_ms{sfx}": per_call_device_ms(torch, lambda: nn_walk.top1_walk(
            q4, packed, lo, ln, r2, block, sub)),
        f"plain_ms{sfx}": cuda_ms(torch, lambda: nn_walk.top1_walk_plain(
            q4, packed, lo, ln, r2, block), warm=1, reps=3),
        f"bound_ms{sfx}": b_ms, f"bound_by{sfx}": b_by,
        f"library_ms{sfx}": None,
    })
    entry[f"share{sfx}"] = b_ms / entry["ms" + sfx]
    log(f"K8{sfx}: kernel {entry['ms' + sfx]:.4f} ms, plain "
        f"{entry['plain_ms' + sfx]:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
        f"share {entry['share' + sfx]:.3f}")


def scene_nn(torch, np, dev, n, k8):
    """6a: top-1 NN within 2 mm, 1M x 1M, as bench.py's extra runs it:
    slab_top1 on the x-sorted points, slab2_top1 (K8) on the raw ones."""
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.ops import nn_walk, slab

    radius, block, sub, k_windows = 0.002, 512, 512, 8
    r2 = float(np.float32(radius) * np.float32(radius))
    src_np, _, _, _ = make_pair(n, seed=5)
    perm = np.argsort(src_np[:, 0], kind="stable")
    pts = torch.from_numpy(src_np[perm]).to(dev)
    raw = torch.from_numpy(src_np).to(dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)

    sl = slab.build_slab(pts, mask)
    slab_ms = cuda_ms(torch, lambda: slab.slab_top1(sl, pts, radius,
                                                    slice_cap=8192),
                      warm=1, reps=3)
    s_idx, s_d2, s_ovf = slab.slab_top1(sl, pts, radius, slice_cap=8192)

    def pass_():
        return nn_walk.slab2_top1(raw, mask, raw, mask, radius, block=block,
                                  sub=sub, k_windows=k_windows)

    pass_()  # warm
    k8["launches"] = 0
    nn_walk.top1_walk.launches = 0
    times, (w_idx, w_d2) = host_ms(torch, pass_, warm=0, reps=3)
    launches = nn_walk.top1_walk.launches
    check(launches == 3, f"K8 launched {launches} times in 3 passes")
    k8["launches"] = launches // 3

    # The matched set and d² agree with slab_top1's on blocks within its
    # slice_cap (here the queries are the targets: every row matches).
    _, length = slab.block_slices(sl, pts.reshape(-1, 256, 3)[..., 0], radius)
    ok = (length <= 8192).repeat_interleave(256)[:n]
    perm_t = torch.from_numpy(perm).to(dev)
    w_d2_s = w_d2[perm_t]
    s_m, w_m = s_d2 < 1e29, w_d2_s < 1e29
    check(torch.equal(s_m[ok], w_m[ok]), "slab2_top1 and slab_top1 match "
          "different rows")
    check(torch.equal(s_d2[ok & s_m], w_d2_s[ok & s_m]),
          "slab2_top1 and slab_top1 differ in d2")
    log(f"1M scene: slab_top1 {slab_ms:.2f} ms/pass (overflow "
        f"{bool(s_ovf)}, {int((~ok).sum())} rows in overflowed blocks), "
        f"slab2_top1 with both index builds {statistics.median(times):.2f} "
        f"ms/pass, {int(w_m.sum())} of {n} matched")

    wt = nn_walk.build_walk_target(raw, mask, radius)
    r = np.float32(radius)
    nb_r = int(torch.ceil(torch.tensor(r) * wt.inv_w.cpu()[0]))
    q4, lo, ln, _ = nn_walk.walk_operands(wt, raw, mask, radius, block,
                                          k_windows)
    walk_phase(torch, nn_walk, q4, wt.packed, lo, ln, r2, block, sub, "",
               k8)
    # Queries off the points (1 mm jitter): real searches, some with no
    # target within the radius.
    jit = raw + torch.from_numpy(np.random.default_rng(6).normal(
        0, 0.001, (n, 3)).astype(np.float32)).to(dev)
    q4j, loj, lnj, _ = nn_walk.walk_operands(wt, jit, mask, radius, block,
                                             k_windows)
    walk_phase(torch, nn_walk, q4j, wt.packed, loj, lnj, r2, block, sub,
               "_jittered", k8)
    # The plan's sides: the self-join, its first 96, 264, 660 and 1,024
    # blocks (fewer blocks than SMs, then 2, 5 and 8 an SM), the jittered
    # queries, and the self-join in blocks of 128.
    force_walk_plans(torch, nn_walk, q4, wt.packed, lo, ln, r2, block, sub,
                     "self_join", k8)
    for nb in (96, 264, 660, 1024):
        if nb < lo.shape[0]:
            force_walk_plans(torch, nn_walk,
                             q4[:, :nb * block].contiguous(), wt.packed,
                             lo[:nb].contiguous(), ln[:nb].contiguous(), r2,
                             block, sub, f"self_join_first_{nb}", k8)
    force_walk_plans(torch, nn_walk, q4j, wt.packed, loj, lnj, r2, block,
                     sub, "jittered", k8)
    q4b, lob, lnb, _ = nn_walk.walk_operands(wt, raw, mask, radius, 128,
                                             k_windows)
    force_walk_plans(torch, nn_walk, q4b, wt.packed, lob, lnb, r2, 128, sub,
                     "self_join_block_128", k8, plain=True)
    return {
        "route": "1M scene, NN", "fixture": f"make_pair({n}, seed=5)",
        "radius": radius, "block": block, "sub": sub,
        "k_windows": k_windows, "nb_r": nb_r,
        "slab_top1_ms": slab_ms, "slab_top1_overflow": bool(s_ovf),
        "slab2_top1_host_ms": times,
        "slab2_top1_host_ms_median": statistics.median(times),
        "matched": int(w_m.sum()),
    }


def scene_pair(torch, np, dev, n, entries, counters):
    """6b: the full 1M pair (bench.py's extra): the target's dense fused
    prepare and ICP index, then per pair the sparse source prepare, RANSAC
    (100,000 hypotheses, corr_mode 'exact') and ICP (<= 50 iterations)."""
    from tpu3d_torch import PointCloud
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.ops import (
        features,
        fused_features,
        icp,
        icp_stats,
        nn,
        ransac,
    )

    e2, e3, e4, k5, k6, k7 = entries
    voxel = 0.001
    radius = float(np.float32(voxel * 5))
    r2 = float(np.float32(radius) * np.float32(radius))
    src_np, tgt_np, R_true, t_true = make_pair(n, seed=7, voxel=voxel)
    src = PointCloud.from_numpy(src_np, capacity=n, device=dev)
    tgt = PointCloud.from_numpy(tgt_np, capacity=n, device=dev)

    def pair(tgt_p, tgt_f, index):
        sub_c, sub_f, _ = fused_features.fused_prepare_sparse(src, radius)
        c = ransac.ransac_registration(sub_c, tgt_p, sub_f, tgt_f, voxel,
                                       max_iterations=100000,
                                       corr_mode="exact")
        r = icp.icp_refine(src, tgt_p, c.transformation, voxel * 0.4,
                           max_iterations=50, point_to_plane=True,
                           target_index=index)
        return r, c

    # The main path once, from the target's prepare, with the counts.
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    stage = Stages(torch)
    tgt_p, tgt_f = stage("prepare_target_ms", lambda: (
        fused_features.fused_prepare_features(tgt, radius)))
    index = stage("icp_index_ms", lambda: icp.build_icp_target(tgt_p))
    tgt_f = stage("nn_operand_ms", lambda: ransac.with_target_operand(tgt_f))
    refined, coarse = stage("first_pair_ms",
                            lambda: pair(tgt_p, tgt_f, index))
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    launches = launch_counts(counters)
    log(f"1M pair: launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel did not launch: {launches}")
    rot_err, trn_err = gate(np, refined, R_true, t_true)
    log(f"1M pair: refined fitness {float(refined.fitness):.5f}, coarse "
        f"{float(coarse.fitness):.5f}; pose error rot {rot_err:.2e} trans "
        f"{trn_err:.2e} m; peak {peak_mb:.1f} MB")

    def one():
        return pair(tgt_p, tgt_f, index)

    times, _ = host_ms(torch, one, warm=0, reps=3)
    s_p = stage("prepare_source_sparse_ms",
                lambda: fused_features.fused_prepare_sparse(src, radius))
    co = stage("ransac_ms", lambda: ransac.ransac_registration(
        s_p[0], tgt_p, s_p[1], tgt_f, voxel, max_iterations=100000,
        corr_mode="exact"))
    stage("icp_ms", lambda: icp.icp_refine(
        src, tgt_p, co.transformation, voxel * 0.4, max_iterations=50,
        point_to_plane=True, target_index=index))
    busy = device_busy_ms(torch, one)

    # K2-K5 and K7 against their plain versions at this path's shapes (K6
    # sees the same shapes as at 100,352 points: the 8,192-row subset).
    al, lo, ln = fused_features.aligned_layout(tgt, radius, 128)
    prepare_sweeps(torch, features, fused_features, al, lo, (ln, ln, ln),
                   128, r2, (e2, e3, e4), "_1m")
    sparse_sweeps(torch, features, fused_features, src, radius, r2,
                  (e2, e3, e4), "_sparse256_1m")
    sub_c, sub_f, _ = s_p
    nn_phase(torch, nn, sub_f.descriptors, sub_f.mask, tgt_f.descriptors,
             tgt_f.mask, "_1m", k5, library=False,
             quality=(np, sub_c.points, tgt_p.points, R_true, t_true, voxel))
    T_true = torch.eye(4, device=dev)
    T_true[:3, :3] = torch.from_numpy(R_true).to(dev)
    T_true[:3, 3] = torch.from_numpy(t_true).to(dev)
    stride = ransac.decimation_stride(n, 16384)
    icp_phase(torch, icp, icp_stats, index,
              src.points[: stride * 16384: stride],
              src.mask[: stride * 16384: stride], T_true, voxel * 0.4,
              "_1m", k7)
    for e, name in zip(entries, counters):
        e["launches_1m_pair"] = launches[name]
    # K5's library call at these shapes, a (8,192 x 1,048,576) fp32 product
    # of 34.4 GB, once the pair's state is freed.
    q1, t1, m1 = sub_f.descriptors, tgt_f.descriptors, tgt_f.mask
    del s_p, sub_c, sub_f, tgt_p, tgt_f, index, al, lo, ln, co
    lib_ms, note, halves = nn_library_ms(torch, q1, t1, m1)
    k5["library_ms_1m"] = lib_ms
    k5["library_note_1m"] = note
    if halves is not None:
        k5["library_halves_ms_1m"] = halves
    log(f"K5_1m library call ({note}): {lib_ms:.4f} ms")
    return {
        "route": "1M pair", "main_path": "fused_prepare_features, "
        "build_icp_target, then fused_prepare_sparse, ransac_registration, "
        "icp_refine",
        "fixture": f"make_pair({n}, seed=7, voxel={voxel})",
        "pair_ms": times, "pair_ms_median": statistics.median(times),
        "stages_ms": stage.ms, "fitness": float(refined.fitness),
        "coarse_fitness": float(coarse.fitness), "rot_err": rot_err,
        "trans_err": trn_err, "launches": launches, "peak_mem_mb": peak_mb,
        "device_busy_ms": busy,
    }


def scene_batch(torch, np, dev, n_inst, entries, counters):
    """6c: the 64-instance batch (bench.py's extra, its rng(1) poses):
    sources of 8,192 rows drawn from a 16,384-row target, each fused-
    prepared, registered by register_batch; every member's pose against
    its true [Rb | tb]."""
    from tpu3d_torch import FPFHFeatures, PointCloud
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.ops import fused_features
    from tpu3d_torch.parallel.batched import register_batch, stack_clouds

    voxel, ntgt, nsrc = 0.005, 16384, 8192
    radius = float(np.float32(voxel * 5))
    _, tgt_np, _, _ = make_pair(ntgt, voxel=voxel)
    rng = np.random.default_rng(1)
    poses, src_nps = [], []
    for _ in range(n_inst):
        aa = rng.normal(size=3) * 0.15
        th = np.linalg.norm(aa)
        k = aa / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                      [-k[1], k[0], 0]])
        Rb = (np.eye(3) + np.sin(th) * K
              + (1 - np.cos(th)) * K @ K).astype(np.float32)
        tb = (rng.normal(size=3) * 0.03).astype(np.float32)
        sel = rng.choice(ntgt, nsrc, replace=False)
        poses.append((Rb, tb))
        src_nps.append((tgt_np[sel] - tb) @ Rb)

    def batch():
        tgt, tf = fused_features.fused_prepare_features(
            PointCloud.from_numpy(tgt_np, capacity=ntgt, device=dev), radius)
        srcs, feats = [], []
        for s in src_nps:
            c, fe = fused_features.fused_prepare_features(
                PointCloud.from_numpy(s, capacity=nsrc, device=dev), radius)
            srcs.append(c)
            feats.append(fe)
        fb = FPFHFeatures(torch.stack([f.descriptors for f in feats]),
                          torch.stack([f.mask for f in feats]))
        return register_batch(stack_clouds(srcs), tgt, fb, tf, voxel,
                              ransac_max_iterations=4096,
                              icp_max_iterations=30)

    from tpu3d_torch.ops import ransac

    batch()  # warm
    reset_counts(counters)
    ransac.gather_hypotheses.launches = 0
    times, (refined, _) = host_ms(torch, batch, warm=0, reps=1)
    launches = launch_counts(counters)
    # 4,096 hypotheses: every member takes the one-shot gather route.
    k11_launches = ransac.gather_hypotheses.launches
    T = refined.transformation.cpu().numpy()
    fit = refined.fitness.cpu().numpy()
    errs = [(float(np.abs(T[b, :3, :3] - Rb).max()),
             float(np.abs(T[b, :3, 3] - tb).max()))
            for b, (Rb, tb) in enumerate(poses)]
    failed = [b for b, (rot, trn) in enumerate(errs)
              if not (np.isfinite(T[b]).all() and rot < 0.02 and trn < 0.005)]
    log(f"64 batch: {times[0]:.1f} ms ({n_inst / times[0] * 1e3:.1f} "
        f"instances/s), mean fitness {float(fit.mean()):.4f}, worst pose "
        f"error rot {max(e[0] for e in errs):.2e} trans "
        f"{max(e[1] for e in errs):.2e} m, launches {launches}, K11 "
        f"{k11_launches}")
    check(k11_launches > 0, "K11 did not launch in the batch")
    check(not failed, f"batch members {failed} failed the gate: "
          f"{[errs[b] for b in failed]}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel did not launch: {launches}")
    for e, name in zip(entries, counters):
        e["launches_batch"] = launches[name]
    # K2-K4 and K7 at the batch's own shapes: the target's and the first
    # source's dense prepares, and that source's ICP at its true pose.
    from tpu3d_torch.ops import features, icp, icp_stats

    e2, e3, e4, _, _, k7 = entries
    r2 = float(np.float32(radius) * np.float32(radius))
    for pts_np, cap, sfx in ((tgt_np, ntgt, "_batch_target"),
                             (src_nps[0], nsrc, "_batch_source")):
        cloud = PointCloud.from_numpy(pts_np, capacity=cap, device=dev)
        al, lo, ln = fused_features.aligned_layout(cloud, radius, 128)
        prepare_sweeps(torch, features, fused_features, al, lo,
                       (ln, ln, ln), 128, r2, (e2, e3, e4), sfx)
    tgt_p, _ = fused_features.fused_prepare_features(
        PointCloud.from_numpy(tgt_np, capacity=ntgt, device=dev), radius)
    src0 = PointCloud.from_numpy(src_nps[0], capacity=nsrc, device=dev)
    Rb, tb = poses[0]
    T0 = torch.eye(4, device=dev)
    T0[:3, :3] = torch.from_numpy(Rb).to(dev)
    T0[:3, 3] = torch.from_numpy(tb).to(dev)
    icp_phase(torch, icp, icp_stats, icp.build_icp_target(tgt_p),
              src0.points, src0.mask, T0, voxel * 0.4, "_batch", k7)
    return {
        "route": "64-instance batch",
        "main_path": "fused_prepare_features x 65, register_batch",
        "fixture": f"make_pair({ntgt}, voxel={voxel}), {n_inst} sources of "
                   f"{nsrc} rows, rng(1) poses",
        "batch_ms": times[0], "instances_per_s": n_inst / times[0] * 1e3,
        "fitness_mean": float(fit.mean()), "fitness_min": float(fit.min()),
        "rot_err_max": max(e[0] for e in errs),
        "trans_err_max": max(e[1] for e in errs), "launches": launches,
        "k11_launches": k11_launches,
    }


def probe_phase(torch, dev):
    """6d: the probe's kernels against PyTorch on the card."""
    from tpu3d_torch import probe

    for f in probe.WRAPPERS.values():
        f.launches = 0
    results = probe.run(dev)
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in probe.WRAPPERS.items()}
    for r in results:
        log(f"probe {r['name']}: {'OK' if r['ok'] else 'FAIL'} (max "
            f"{r['unit']} {r['err']:.3g}, tolerance {r['tol']:.3g})")
    bad = [r["name"] for r in results if not r["ok"]]
    check(not bad, f"probe functions disagree with PyTorch: {bad}")
    check(all(v > 0 for v in launches.values()),
          f"a probe kernel did not launch: {launches}")
    x, y, a = probe.probe_inputs(dev)
    reads = {"dot_axis0": (a, y), "transpose": (y,)}
    wrapper = {"argmin": "row_argmin", "cumsum": "row_cumsum",
               "dot_axis0": "dot_axis0", "transpose": "transpose"}
    entries = []
    # The one PyTorch call of each function; the cumsum's plain version is
    # the kernel's order of additions, not torch.cumsum.
    library = {"cumsum": lambda: torch.cumsum(x, 1)}
    for (name, kern, plain, _), r in zip(probe.cases(dev), results):
        ins = reads.get(name, (x,))
        lib = library.get(name, plain)
        out = kern()
        # Each input read once, the output written once; the product does
        # 2 operations per term, the others about one per element.
        ops = (2.0 * a.shape[0] * out.numel() if name == "dot_axis0"
               else float(ins[0].numel()))
        b_ms, b_by = bound(ops, nbytes(*ins, out))
        plain_ms = cuda_ms(torch, plain)
        entries.append({
            "name": f"probe {name}", "route": "cuda",
            "source": "tpu3d_torch/csrc/probe.cu",
            "replaces": "benchmarks/pallas_probe.py:12",
            "launches": launches[wrapper.get(name, "unary")],
            "max_abs_err": r["err"], "err_unit": r["unit"],
            "tolerance": r["tol"], "ms": cuda_ms(torch, kern),
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(torch, lib),
            "device_ms": per_call_device_ms(torch, kern),
            "library_device_ms": per_call_device_ms(torch, lib),
        })
    return entries


def scene_phase(torch, np, dev, args, entries, counters):
    """Phase 6: the 1M-point scene (6a-6c) and the probe (6d). ``entries``
    are the kernels lines' K2-K7 entries, ``counters`` their wrappers, in
    the same order."""
    k8 = {"name": "nn_walk_top1 (K8)", "route": "cuda",
          "source": "tpu3d_torch/csrc/nn_walk.cu",
          "replaces": "tpu3d/ops/nn_walk.py:140"}
    nn_route = scene_nn(torch, np, dev, args.scene_points, k8)
    pair_route = scene_pair(torch, np, dev, args.scene_points, entries,
                            counters)
    batch_route = scene_batch(torch, np, dev, args.instances, entries,
                              counters)
    return k8, probe_phase(torch, dev), [nn_route, pair_route, batch_route]


# --------------------------------------------------------------------------
# Phase 7: the multiscale entry and the neighbour backends, ICP backends
# and RANSAC routes
# --------------------------------------------------------------------------


class RecordedDraws:
    """The default draw stream, recording the chunks it was asked for
    (None: the one-shot or two-stage draw)."""

    def __init__(self, seed):
        from tpu3d_torch.ops import ransac

        self.inner = ransac.torch_draws(seed)
        self.chunks = set()

    def __call__(self, c, e):
        self.chunks.add(c)
        return self.inner(c, e)

    def triples(self, c, h, count):
        self.chunks.add(c)
        return self.inner.triples(c, h, count)

    def rows(self, n, count):
        return self.inner.rows(n, count)


def iteration_counter(icp):
    """A context that counts the stats passes of every ``icp_loop`` (one a
    Gauss-Newton iteration); yields the one-element count."""

    @contextlib.contextmanager
    def counting():
        n = [0]
        loop = icp.icp_loop

        def counted_loop(stats_fn, *a, **k):
            def counted(T):
                n[0] += 1
                return stats_fn(T)
            return loop(counted, *a, **k)

        icp.icp_loop = counted_loop
        try:
            yield n
        finally:
            icp.icp_loop = loop
    return counting()


def multiscale_route(torch, np, dev, n_points, voxel, counters):
    """7a: ``register_pair_multiscale`` at the bench fixture's width, levels
    2, step 3, 100,000 hypotheses (RANSAC's default caps): K2-K7 launched,
    the quality gate, warm host ms, device busy, peak memory, and the fine
    target's slab_knn (k = 30) timed with its largest window."""
    import tpu3d_torch
    from tpu3d_torch import registration as reg
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.ops import slab

    src_np, tgt_np, R_true, t_true = make_pair(n_points)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=voxel)
    src = tpu3d_torch.PointCloud.from_numpy(src_np, device=dev)
    tgt = tpu3d_torch.PointCloud.from_numpy(tgt_np, device=dev)

    def pair():
        return tpu3d_torch.register_pair_multiscale(src, tgt, cfg, levels=2,
                                                    scale_step=3.0)

    knn_calls = []
    slab_knn = reg.slab_knn

    def counted(index, q, radius, k, **kw):
        knn_calls.append((q.shape[0], k))
        return slab_knn(index, q, radius, k=k, **kw)

    reg.slab_knn = counted
    try:
        pair()  # warm
        knn_calls.clear()
        reset_counts(counters)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refined, coarse = pair()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        launches = launch_counts(counters)
    finally:
        reg.slab_knn = slab_knn
    log(f"multiscale launches {launches}, slab_knn calls {knn_calls}")
    check(all(n > 0 for n in launches.values()),
          f"a kernel did not launch on the multiscale path: {launches}")
    fine = reg.downsample_bucketed(tgt, cfg)
    check((fine.capacity, 30) in knn_calls,
          f"the fine target's slab_knn at k = 30 did not run: {knn_calls}")
    rot_err, trn_err = gate(np, refined, R_true, t_true)
    times = [first_ms] + host_ms(torch, pair, warm=0, reps=3)[0]
    busy, top = device_profile(torch, pair)
    log(f"multiscale device time by entry (ms): {top}")

    # The fine level's search on its own (surface_neighbors' call): its
    # time, windows and overflow flag. The queries are the slab's sorted
    # rows, valid ones first; the padding rows keep their coordinates
    # (zeros), so the one block that holds both the last valid rows and
    # padding spans x from 0 to the cloud's end and overflows slice_cap,
    # as in the JAX package. Every valid row of a block without padding
    # finds itself first, at d² = 0.
    radius = float(np.float32(voxel * 5.0))
    index = slab.build_slab(fine.points, fine.mask)
    q = index.sorted_points_t.T.contiguous()
    knn_ms = cuda_ms(torch, lambda: slab.slab_knn(index, q, radius, k=30),
                     warm=1, reps=3)
    idx, d2, overflowed = slab.slab_knn(index, q, radius, k=30)
    pad = (-q.shape[0]) % 256
    qb = torch.cat([q, torch.full((pad, 3), 2.9e4, device=dev)])
    _, length = slab.block_slices(index, qb.reshape(-1, 256, 3)[..., 0],
                                  radius)
    n_valid = fine.count()
    full = n_valid // 256  # blocks of valid rows only
    check(torch.equal(idx[:full * 256, 0].long(),
                      index.sorted_orig[:full * 256])
          and bool((d2[:full * 256, 0] == 0).all()),
          "a valid row's first slab neighbour is not itself")
    check(bool(torch.isfinite(d2).all()), "slab_knn gave a non-finite d²")
    check(int(length[:full].max()) <= 8192,
          "a block of valid rows overflows slice_cap")
    log(f"multiscale: pose error rot {rot_err:.2e} trans {trn_err:.2e} m, "
        f"fitness {float(refined.fitness):.5f}, coarse "
        f"{float(coarse.fitness):.5f}, pairs {[round(t, 2) for t in times]} "
        f"ms, busy {busy:.2f} ms; slab_knn {q.shape[0]} x k 30: "
        f"{knn_ms:.3f} ms, windows max {int(length.max())} (valid blocks "
        f"{int(length[:full].max())}), overflowed {bool(overflowed)}")
    return {
        "route": "multiscale",
        "main_path": "tpu3d_torch.register_pair_multiscale",
        "fixture": f"make_pair({n_points}), voxel {voxel}, levels 2, "
                   "scale_step 3",
        "level_voxels": [voxel * 3.0, voxel],
        "rot_err": rot_err, "trans_err": trn_err,
        "fitness": float(refined.fitness),
        "coarse_fitness": float(coarse.fitness), "pair_ms": times,
        "pair_ms_median": statistics.median(times), "device_busy_ms": busy,
        "device_ms_top": top, "peak_mem_mb": peak_mb, "launches": launches,
        "slab_knn_calls": knn_calls,
        "slab_knn": {"rows": q.shape[0], "k": 30, "ms": knn_ms,
                     "max_window": int(length.max()),
                     "max_window_valid_blocks": int(length[:full].max()),
                     "mean_window": float(length.float().mean()),
                     "overflowed": bool(overflowed),
                     "valid_rows_in_the_padded_block":
                         n_valid - full * 256},
    }


def neighbor_modes_route(torch, np, dev):
    """7b: at bucket 8,192, prepare_features with each neighbour mode, then
    register_prepared: each through the gate, its prepare ms and its
    descriptor correspondences' agreement with 'brute'. Returns the route
    and the brute mode's prepared pair and coarse pose (for 7c)."""
    import tpu3d_torch
    from tpu3d_torch import registration as reg
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.ops import ransac

    src_np, tgt_np, R_true, t_true = make_pair(N_POINTS, voxel=VOXEL)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL)
    sd = reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(src_np, device=dev), cfg)
    td = reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(tgt_np, device=dev), cfg)
    check(sd.capacity == td.capacity == 8192, f"bucket {sd.capacity}")
    modes, brute = {}, None
    for mode in ("brute", "slab", "grid"):
        times, (sp, sf) = host_ms(
            torch, lambda: reg.prepare_features(sd, cfg, mode), reps=3)
        tp, tf = reg.prepare_features(td, cfg, mode)
        refined, coarse = reg.register_prepared(sp, tp, sf, tf, cfg)
        rot_err, trn_err = gate(np, refined, R_true, t_true)
        corr = ransac.feature_correspondences(sf, tf)
        if brute is None:
            brute = (sp, tp, sf, tf, coarse, corr)
        agree = float((corr == brute[5])[sd.mask].float().mean())
        modes[mode] = {
            "prepare_ms": times, "prepare_ms_median": statistics.median(times),
            "correspondence_agreement_with_brute": agree,
            "rot_err": rot_err, "trans_err": trn_err,
            "fitness": float(refined.fitness),
            "coarse_fitness": float(coarse.fitness)}
        log(f"neighbour mode {mode}: prepare {statistics.median(times):.2f} "
            f"ms, correspondences equal brute's on {agree:.4f}, pose error "
            f"rot {rot_err:.2e} trans {trn_err:.2e} m")
    route = {"route": "neighbour modes, bucket 8192",
             "main_path": "prepare_features(neighbor_mode), "
                          "register_prepared",
             "fixture": f"make_pair({N_POINTS}, voxel={VOXEL})",
             "modes": modes}
    return route, brute[:5]


# The pose tolerance between ICP backends: the CPU tests' (each backend
# against JAX's within 1e-5).
ICP_BACKEND_ATOL = 1e-5


def icp_backends(torch, np, icp, source, target, T0, thr, modes, label,
                 max_iterations=200):
    """icp_refine from ``T0`` with each of ``modes`` (the slab backend over
    every source row): poses within ICP_BACKEND_ATOL of the first mode's,
    each backend's host ms and ms per stats pass."""
    out, first = {}, None
    for mode in modes:
        def refine():
            return icp.icp_refine(source, target, T0, thr,
                                  max_iterations=max_iterations,
                                  nn_mode=mode, src_mode="exact")

        refine()  # warm
        with iteration_counter(icp) as n:
            times, res = host_ms(torch, refine, warm=0, reps=3)
        passes = n[0] // 3
        T = res.transformation.cpu().numpy()
        check(np.isfinite(T).all(), f"{label} {mode}: non-finite pose")
        if first is None:
            first = T
        diff = float(np.abs(T - first).max())
        check(diff <= ICP_BACKEND_ATOL,
              f"{label}: {mode} lands {diff} from {modes[0]}")
        ms = statistics.median(times)
        out[mode] = {"ms": times, "ms_median": ms, "stats_passes": passes,
                     "ms_per_pass": ms / max(passes, 1),
                     "fitness": float(res.fitness),
                     "pose_diff_from_" + modes[0]: diff}
        log(f"{label} ICP {mode}: {ms:.2f} ms, {passes} passes, fitness "
            f"{float(res.fitness):.5f}, {diff:.2e} from {modes[0]}")
    return out


def ransac_routes(torch, np, ransac, icp, sub_c, sub_f, tgt, tgt_f, src,
                  voxel, R_true, t_true):
    """7d: RANSAC's routing arguments on the 100k pair's sparse subset
    against the dense target, each refined by ICP through the gate: chunks
    run and RANSAC ms."""
    out = {}
    for name, kw in (("hyp_chunk 16384", dict(hyp_chunk=16384)),
                     ("hyp_chunk 50176", dict(hyp_chunk=50176)),
                     ("early_exit off", dict(early_exit=False)),
                     ("sampling gather", dict(sampling="gather"))):
        draws = RecordedDraws(42)

        def coarse():
            return ransac.ransac_registration(
                sub_c, tgt, sub_f, tgt_f, voxel, max_iterations=100000,
                corr_mode="exact", draws=draws, **kw)

        times, co = host_ms(torch, coarse, reps=3)
        refined = icp.icp_refine(src, tgt, co.transformation, voxel * 0.4)
        rot_err, trn_err = gate(np, refined, R_true, t_true)
        chunks = sorted(c for c in draws.chunks if c is not None)
        if name == "early_exit off":
            check(draws.chunks == {None}, f"{name}: chunks {draws.chunks}")
        else:
            check(chunks and None not in draws.chunks,
                  f"{name}: chunks {draws.chunks}")
        out[name] = {"ms": times, "ms_median": statistics.median(times),
                     "chunks_run": len(chunks),
                     "coarse_fitness": float(co.fitness),
                     "fitness": float(refined.fitness), "rot_err": rot_err,
                     "trans_err": trn_err}
        log(f"RANSAC {name}: {statistics.median(times):.2f} ms, "
            f"{len(chunks)} chunks, pose error rot {rot_err:.2e} trans "
            f"{trn_err:.2e} m")
    return out


def entry_points_phase(torch, np, dev, args, counters):
    """Phase 7: 7a multiscale, 7b neighbour modes, 7c ICP backends (at
    bucket 8,192 slab, grid and brute; on the 100k pair slab and grid,
    <= 30 iterations), 7d RANSAC routes on the 100k pair."""
    import tpu3d_torch
    from tpu3d_torch import registration as reg
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.ops import fused_features, icp, ransac

    multiscale = multiscale_route(torch, np, dev, args.points, args.voxel,
                                  counters)
    modes, (sp, tp, _, _, coarse) = neighbor_modes_route(torch, np, dev)
    backends = {"bucket 8192": icp_backends(
        torch, np, icp, sp, tp, coarse.transformation,
        VOXEL * 0.4, ("slab", "grid", "brute"), "bucket 8192")}

    voxel = args.voxel
    src_np, tgt_np, R_true, t_true = make_pair(args.points)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=voxel)
    sd = reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(src_np, device=dev), cfg)
    tgt, tgt_f = reg.prepare_features(reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(tgt_np, device=dev), cfg), cfg,
        "fused")
    tgt_f = ransac.with_target_operand(tgt_f)
    sub_c, sub_f, _ = fused_features.fused_prepare_sparse(
        sd, float(np.float32(voxel * 5.0)))
    co = ransac.ransac_registration(sub_c, tgt, sub_f, tgt_f, voxel,
                                    corr_mode="exact")
    backends["100k"] = icp_backends(
        torch, np, icp, sd, tgt, co.transformation, voxel * 0.4,
        ("slab", "grid"), "100k", max_iterations=30)
    routes = ransac_routes(torch, np, ransac, icp, sub_c, sub_f, tgt, tgt_f,
                           sd, voxel, R_true, t_true)
    return [multiscale, modes,
            {"route": "ICP backends", "main_path": "icp_refine(nn_mode)",
             "tolerance": ICP_BACKEND_ATOL, "backends": backends},
            {"route": "RANSAC routes, 100k pair",
             "main_path": "ransac_registration(hyp_chunk, early_exit, "
                          "sampling), icp_refine",
             "routes": routes}]


# --------------------------------------------------------------------------
# Phase 8: the sharded stack on virtual meshes
# --------------------------------------------------------------------------


def sharded_pair_route(torch, np, dev, n_points, voxel, counters):
    """8a: ``register_pair(..., mesh=)`` on phase 4's pair over 4 and 2
    shards of cuda:0. Returns (route, the 4-shard run's launches, the
    pieces 8c holds kernels at)."""
    import tpu3d_torch
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.parallel import mesh as pm
    from tpu3d_torch.parallel import register_sharded as rs

    src_np, tgt_np, R_true, t_true = make_pair(n_points)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=voxel)
    src = tpu3d_torch.PointCloud.from_numpy(src_np, device=dev)
    tgt = tpu3d_torch.PointCloud.from_numpy(tgt_np, device=dev)
    route = {"route": "sharded register_pair (virtual mesh on cuda:0)",
             "main_path": "tpu3d_torch.register_pair(..., mesh=)",
             "fixture": f"make_pair({n_points}), voxel {voxel}",
             "note": "the shards run one after another on one card: "
                     "correctness and overhead, not a speedup"}
    launches_4 = None
    for n_sh in (4, 2):
        mesh = pm.make_mesh(devices=[dev] * n_sh)
        refined, coarse, info = rs.register_pair_sharded(
            src, tgt, cfg, mesh, return_info=True)
        log(f"8a {n_sh} shards: {info}")
        check(info["src_prepare_distributed"]
              and info["tgt_prepare_distributed"],
              f"a prepare fell back to one device on {n_sh} shards: {info}")

        def pair(mesh=mesh):
            return tpu3d_torch.register_pair(src, tgt, cfg, mesh=mesh)

        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refined, coarse = pair()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts(counters)
        log(f"8a {n_sh} shards: launches {launches}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel did not launch on {n_sh} shards: {launches}")
        rot_err, trn_err = gate(np, refined, R_true, t_true)
        times = [first_ms] + host_ms(torch, pair, warm=0, reps=3)[0]
        busy = device_busy_ms(torch, pair)
        log(f"8a {n_sh} shards: fitness {float(refined.fitness):.5f}, "
            f"coarse {float(coarse.fitness):.5f}, pose error rot "
            f"{rot_err:.2e} trans {trn_err:.2e}; host ms {times}, device "
            f"busy {busy:.2f} ms")
        route[f"shards_{n_sh}"] = {
            "info": info, "launches": launches, "pair_ms": times,
            "pair_ms_warm_median": statistics.median(times[1:]),
            "device_busy_ms": busy, "fitness": float(refined.fitness),
            "coarse_fitness": float(coarse.fitness), "rot_err": rot_err,
            "trans_err": trn_err,
        }
        if n_sh == 4:
            launches_4 = launches
            pieces = (mesh, src, tgt, cfg, coarse)
    return route, launches_4, pieces


def sharded_scene_nn(torch, np, dev, n):
    """8b: the 1M self-join within 2 mm over 4 shards against one device:
    d2 bit for bit, indices equal wherever the minimum is unique."""
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.ops import nn_walk
    from tpu3d_torch.parallel import mesh as pm
    from tpu3d_torch.parallel import sharded_nn

    radius, block, sub, k_windows = 0.002, 512, 512, 8
    src_np, _, _, _ = make_pair(n, seed=5)
    raw = torch.from_numpy(src_np).to(dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    mesh = pm.make_mesh(devices=[dev] * 4)
    i1, d1 = nn_walk.slab2_top1(raw, mask, raw, mask, radius, block=block,
                                sub=sub, k_windows=k_windows)
    sw = sharded_nn.build_walk_sharded(raw, mask, radius, mesh)

    def query():
        return sharded_nn.slab2_top1_sharded(sw, raw, mask, radius, mesh,
                                             block=block, sub=sub,
                                             k_windows=k_windows)

    i4, d4 = query()
    matched = d1 < 1e29
    check(torch.equal(matched, d4 < 1e29), "8b: matched rows differ")
    check(torch.equal(d4[matched], d1[matched]), "8b: d2 differs")
    differ = (i4 != i1) & matched
    rows = differ.nonzero()[:, 0]
    q = raw[rows]
    # A differing pick must be a tie: its plain d2 equals the other's.
    tie = torch.equal(((raw[i4[rows].long()] - q) ** 2).sum(1),
                      ((raw[i1[rows].long()] - q) ** 2).sum(1))
    check(tie, "8b: indices differ where the minimum is unique")
    times = host_ms(torch, query, warm=0, reps=3)[0]
    one = host_ms(torch, lambda: nn_walk.slab2_top1_indexed(
        nn_walk.build_walk_target(raw, mask, radius), raw, mask, radius,
        block=block, sub=sub, k_windows=k_windows), warm=0, reps=3)[0]
    log(f"8b: {int(matched.sum())} of {n} matched, {rows.numel()} tie "
        f"picks differ; 4 shards {statistics.median(times):.2f} ms/pass, "
        f"one device (with its build) {statistics.median(one):.2f} ms")
    return {"route": "sharded slab2_top1, 1M scene, 4 shards of cuda:0",
            "rows": n, "matched": int(matched.sum()),
            "tie_picks_differing": int(rows.numel()),
            "pass_ms_4_shards": times, "pass_ms_one_device_with_build": one}


def sharded_kernels(torch, np, pieces, entries):
    """8c: on shard 1 of 8a's 4-shard run, K2-K4 (its halo-extended
    layout), K5 (its descriptor rows), K6 (one shard's hypothesis slice)
    and K8 (its walk of ICP's queries at the coarse pose) against their
    plain versions."""
    from tpu3d_torch import registration as reg
    from tpu3d_torch.ops import (
        features,
        fused_features,
        nn,
        nn_walk,
        ransac,
        ransac_score,
    )
    from tpu3d_torch.parallel import prepare_sharded as ps
    from tpu3d_torch.parallel import ransac_sharded as rsh
    from tpu3d_torch.parallel import register_sharded as rs
    from tpu3d_torch.types import PointCloud

    mesh, src, tgt, cfg, coarse = pieces
    e2, e3, e4, k5, k6, k8 = entries
    voxel = cfg.voxel_size
    n_sh, s = 4, 1
    radius = float(np.float32(voxel * 5.0))
    r2 = float(np.float32(radius) * np.float32(radius))
    sd = reg.downsample_bucketed(src, cfg)
    td = reg.downsample_bucketed(tgt, cfg)
    # K2-K4: shard 1's [left halo | own | right halo] rows (a contiguous
    # run of the x-partition for a middle shard).
    pts, msk, _ = ps.x_partition(td.points, td.mask, n_sh)
    sr = pts.shape[0] // n_sh
    halo = min(rs.default_halo(td, voxel), sr)
    loc = PointCloud(points=pts[s * sr - halo:(s + 1) * sr + halo],
                     mask=msk[s * sr - halo:(s + 1) * sr + halo])
    al, lo, ln = fused_features.aligned_layout(loc, radius, 128)
    prepare_sweeps(torch, features, fused_features, al, lo, (ln, ln, ln),
                   128, r2, (e2, e3, e4), "_shard")
    # K5: the corr_cap subset of the source's descriptors against the
    # target's shard rows.
    sp, sf, _ = rs.prepare_features_sharded(sd, cfg, mesh)
    tp, tf, _ = rs.prepare_features_sharded(td, cfg, mesh)
    tp, tf = rs.pad_cloud_to_multiple(tp, tf, n_sh)
    sub = [ransac.strided_rows(x, 8192)
           for x in (sp.points, sp.mask, sf.descriptors)]
    tr = tf.descriptors.shape[0] // n_sh
    nn_phase(torch, nn, sub[2], sub[1], tf.descriptors[s * tr:(s + 1) * tr],
             tf.mask[s * tr:(s + 1) * tr], "_shard", k5)
    # K6: a shard's slice of the first round, its estimate and finalists.
    corr = rsh.feature_correspondences_sharded(
        type(sf)(sub[2], sub[1]), tf, mesh).long()
    p, q = sub[0], tp.points[corr]
    count = int(sub[1].sum())
    feat, pq = ransac.build_scoring_factors(p, q, sub[1])
    table = ransac.build_rotation_table(torch.cat([p, q], 1), sub[1], count)
    iters = cfg.ransac_max_iterations
    hyp_l = -(-ransac.hypothesis_chunk(iters) // n_sh)
    draw = ransac.torch_draws(cfg.ransac_seed)
    w16t, tn, _, _, _ = ransac.solve_rotation_chunk(
        lambda e: draw(s, e), hyp_l, 0, table, count, iters)
    feat_e, pq_e = ransac.build_scoring_factors(
        *(ransac.strided_rows(x, 2048) for x in (p, q, sub[1])))
    thr2 = float((np.float32(voxel) * np.float32(1.5)) ** 2)
    score_phase(torch, ransac_score, (feat_e, pq_e, w16t, tn, thr2),
                "_shard", k6)
    score_phase(torch, ransac_score,
                (feat, pq, w16t[:, :32].contiguous(), tn[:32], thr2),
                "_shard_finalists", k6)
    # K8: ICP's first correspondence pass on shard 1 of the target.
    thr = float(np.float32(voxel * cfg.icp_distance_factor))
    wt = nn_walk.build_walk_target(tp.points[s * tr:(s + 1) * tr],
                                   tp.mask[s * tr:(s + 1) * tr], thr)
    P = sd.points @ coarse.transformation[:3, :3].T \
        + coarse.transformation[:3, 3]
    q4, wlo, wln, _ = nn_walk.walk_operands(wt, P, sd.mask, thr, 128, 10)
    walk_phase(torch, nn_walk, q4, wt.packed, wlo, wln,
               float(np.float32(thr) * np.float32(thr)), 128, 256,
               "_shard", k8)
    return {"shard": s, "of": n_sh, "halo": halo, "shard_rows": sr,
            "layout_blocks": int(lo.shape[0]), "hypotheses": hyp_l}


def sharded_bin_frame(torch, np, counters):
    """8d: ``Pipeline.run()`` on the bin frame with ``parallel: {mode: on,
    devices: 4}`` and the card seen 4 times."""
    import tempfile

    import cv2

    from tpu3d_torch.config import PipelineConfig
    from tpu3d_torch.models.fixtures import bin_frame
    from tpu3d_torch.models.ply import save_ply
    from tpu3d_torch.ops import deproject, depth
    from tpu3d_torch.parallel import mesh as pm
    from tpu3d_torch.pipeline import pipeline as pl

    frame, K = bin_frame()
    height, width = frame.shape
    with tempfile.TemporaryDirectory() as tmp:
        cfg = PipelineConfig()
        cfg.use_camera = cfg.use_robot = False
        cfg.visualization = "none"
        cfg.camera.width, cfg.camera.height = width, height
        cfg.depth.scale_to_meters = 10000.0
        cfg.depth.bilateral_filter = True
        cfg.registration.voxel_size = 0.002
        cfg.parallel.mode, cfg.parallel.devices = "on", 4
        cfg.camera_extrinsics = np.eye(4, dtype=np.float32)
        cfg.dummy_depth_path = os.path.join(tmp, "bin_depth.png")
        cfg.dummy_rgb_path = os.path.join(tmp, "bin_rgb.png")
        cfg.segmentation.masks_input_dir = os.path.join(tmp, "bin_masks")
        cfg.reference_model_path = os.path.join(tmp, "bin_frame.ply")
        check(cv2.imwrite(cfg.dummy_depth_path, frame)
              and cv2.imwrite(cfg.dummy_rgb_path,
                              np.full((height, width, 3), 90, np.uint8)),
              "could not write the frame's PNGs")
        os.makedirs(cfg.segmentation.masks_input_dir, exist_ok=True)
        masks = bin_masks(np, width, height)
        for i, m in enumerate(masks):
            cv2.imwrite(os.path.join(cfg.segmentation.masks_input_dir,
                                     f"mask_{i}.png"), m)
        pm.see_first_device(4, "cuda")
        try:
            with contextlib.redirect_stdout(sys.stderr):
                pipe = pl.Pipeline(cfg, sleep_fn=lambda s: None)
            check(pipe._mesh is not None and pipe._mesh.devices.size == 4,
                  f"the parallel block gave no 4-shard mesh: {pipe._mesh}")
            d_m = depth.depth_preprocess(
                torch.from_numpy(frame.astype(np.float32)).to(pipe.device),
                None, cfg.depth.scale_to_meters)
            cloud = deproject.deproject(d_m, None, torch.from_numpy(K),
                                        cfg.depth.clipping_max)
            save_ply(cfg.reference_model_path,
                     cloud.points[cloud.mask].cpu().numpy())
            probe = RunProbe(torch, pl, pipe)
            reset_counts(counters)
            waypoints, first_ms, _ = probe.run()
            launches = launch_counts(counters)
            poses = probe.poses
            check(len(poses) == len(masks)
                  and all(p is not None for p in poses),
                  "8d: an instance has no pose")
            check(pipe._sharded_registrations == len(masks),
                  f"8d: {pipe._sharded_registrations} sharded "
                  f"registrations for {len(masks)} instances")
            check(pipe._degraded == 0, f"8d: {pipe._degraded} errors")
            errs = []
            for T in poses:
                rot = float(np.abs(T[:3, :3] - np.eye(3)).max())
                trn = float(np.abs(T[:3, 3]).max())
                errs.append((rot, trn))
                check(np.isfinite(T).all() and rot < 0.02 and trn < 0.005,
                      f"8d: quality gate failed: {rot}, {trn}")
            pipe._sharded_registrations = 0
            warm = probe.run()[1]
        finally:
            pm.see_first_device(0, "cuda")
    results = sorted(pipe.instance_results, key=lambda r: r["instance_id"])
    log(f"8d: launches {launches}, pose errors {errs}, cold {first_ms:.1f} "
        f"ms, warm {warm:.1f} ms")
    return {"route": "pipeline, bin frame, parallel: {mode: on, devices: 4}"
                     " (cuda:0 seen 4 times)",
            "sharded_registrations": len(masks), "launches": launches,
            "pose_errors": errs,
            "fitness": [r["fitness"] for r in results],
            "pipeline_ms_cold": first_ms, "pipeline_ms_warm": warm}


def sharded_phase(torch, np, dev, args, entries, counters):
    """Phase 8 (8a-8e, see the module docstring). ``entries``: the kernels
    line's K2, K3, K4, K5, K6 and K8 entries; ``counters`` their
    wrappers by name."""
    from tpu3d_torch.parallel import dryrun

    t0 = time.perf_counter()
    pair_route, launches, pieces = sharded_pair_route(
        torch, np, dev, args.points, args.voxel, counters)
    for e, name in zip(entries, counters):
        e["launches_sharded"] = launches[name]
    pair_route["shard_kernels"] = sharded_kernels(torch, np, pieces, entries)
    nn_route = sharded_scene_nn(torch, np, dev, args.scene_points)
    frame_route = sharded_bin_frame(
        torch, np, {k: f for k, f in counters.items()})
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        facts = dryrun.dryrun_multichip(4, device_type="cuda",
                                        devices=[dev] * 4)
    dry = {"route": "dryrun_multichip(4) on cuda:0 seen 4 times",
           "facts": facts, "ms": (time.perf_counter() - t1) * 1e3}
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s")
    return [pair_route, nn_route, frame_route, dry]


def examples_phase(torch, np, dev, counters):
    """Phase 9: the two examples through their ``main`` (9a), one pair
    timed by the port's timing helpers (9b), and phase 3's point-to-point
    and brute ICP on the card against the plain versions (9c)."""
    import tpu3d_torch
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.ops import icp, ransac
    from tpu3d_torch.registration import downsample_bucketed, prepare_features
    from tpu3d_torch.utils import StageTimer, device_timeit, roundtrip_ms

    t_phase = time.perf_counter()
    sys.path.insert(0, os.path.join(REPO, "examples"))
    import torch_register_pair
    import torch_register_pair_multichip

    routes = []
    for label, module, argv, expect in (
            ("example", torch_register_pair, [],
             ("K2", "K3", "K4", "K5", "K6", "K7")),
            ("example multichip, 4 virtual shards",
             torch_register_pair_multichip, ["--virtual", "4"],
             ("K2", "K3", "K4", "K5", "K6"))):
        reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            r_err, t_err, fitness = module.main(argv)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts(counters)
        log(printed.getvalue().rstrip())
        log(f"9a {label}: {ms:.1f} ms (first run), launches {launches}")
        check(r_err < 0.02 and t_err < 0.005,
              f"{label}: quality gate failed: rotation {r_err}, "
              f"translation {t_err}")
        check(all(launches[k] > 0 for k in expect),
              f"{label}: a kernel did not launch: {launches}")
        routes.append({"route": label, "main_path": module.__file__[
            len(REPO) + 1:], "ms_first": ms, "rot_err": r_err,
            "trans_err": t_err, "fitness": fitness, "launches": launches})

    src_np, tgt_np, R_true, t_true = make_pair(N_POINTS, voxel=VOXEL)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL)
    src = tpu3d_torch.PointCloud.from_numpy(src_np, device=dev)
    tgt = tpu3d_torch.PointCloud.from_numpy(tgt_np, device=dev)

    def pair():
        return tpu3d_torch.register_pair(src, tgt, cfg)

    timed = device_timeit(pair, iters=5, warmup=1)
    stages = StageTimer()
    for i in range(3):
        stages.time(f"register_pair_{i}", pair)
    host = host_ms(torch, pair, warm=1, reps=3)[0]
    rt = roundtrip_ms(n=8, device=dev)
    timing = {"route": "timing helpers, bucket 8,192 pair",
              "main_path": "tpu3d_torch.register_pair",
              "fixture": f"make_pair({N_POINTS}, voxel={VOXEL})",
              "device_timeit": timed, "stage_timer_ms": stages.stages,
              "host_ms": host, "roundtrip_ms": rt}
    log(f"9b: {timing}")
    check(0.0 < timed["best_ms"] <= timed["mean_ms"] and rt > 0.0,
          f"timing helpers: {timed}, roundtrip {rt}")
    routes.append(timing)

    sd = downsample_bucketed(src, cfg)
    td = downsample_bucketed(tgt, cfg)
    sd, sf = prepare_features(sd, cfg)
    td, tf = prepare_features(td, cfg)
    co = ransac.ransac_registration(
        sd, td, sf, tf, VOXEL, max_iterations=cfg.ransac_max_iterations,
        confidence=cfg.ransac_confidence, seed=cfg.ransac_seed)
    T0 = co.transformation
    thr = VOXEL * cfg.icp_distance_factor

    def on_cpu(c):
        return c._replace(**{k: getattr(c, k).cpu() for k in (
            "points", "mask", "normals") if getattr(c, k) is not None})

    icp_route = {"route": "ICP on the card against the plain versions, "
                          "bucket 8,192, from the RANSAC pose"}
    for label, kw in (("point_to_point", dict(point_to_plane=False)),
                      ("brute", dict(nn_mode="brute"))):
        reset_counts(counters)
        card = icp.icp_refine(sd, td, T0, thr,
                              max_iterations=cfg.icp_max_iterations, **kw)
        torch.cuda.synchronize()
        launches = launch_counts(counters)
        plain = icp.icp_refine(on_cpu(sd), on_cpu(td), T0.cpu(), thr,
                               max_iterations=cfg.icp_max_iterations, **kw)
        Tk = card.transformation.cpu().numpy()
        Tp = plain.transformation.numpy()
        diff = float(np.abs(Tk - Tp).max())
        log(f"9c {label} ICP: kernel pose {Tk.tolist()}, plain pose "
            f"{Tp.tolist()}, max |dT| {diff:.3e}, fitness "
            f"{float(card.fitness):.6f} / {float(plain.fitness):.6f}, "
            f"launches {launches}")
        gate(np, card, R_true, t_true)
        gate(np, plain, R_true, t_true)
        kernel = "K7m" if label == "point_to_point" else "K5"
        check(launches[kernel] > 0, f"9c {label}: {kernel} did not launch")
        check(diff < 1e-3, f"9c {label}: kernel and plain poses {diff} apart")
        icp_route[label] = {
            "kernel_pose": Tk.tolist(), "plain_pose": Tp.tolist(),
            "max_abs_dT": diff, "fitness": float(card.fitness),
            "fitness_plain": float(plain.fitness), "launches": launches}
    routes.append(icp_route)
    log(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    return routes


# --------------------------------------------------------------------------
# Phase 10: RANSAC's chunk as one CUDA graph replay
# --------------------------------------------------------------------------

API_LAUNCHES = ("Launch", "Memcpy", "Memset")


def api_launches(torch, fn):
    """{CUDA API call: count} of the launches, copies and sets that one
    call of ``fn`` makes (torch.profiler's runtime rows: a graph replay is
    one cudaGraphLaunch)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.key.startswith("cu")
            and any(w in ev.key for w in API_LAUNCHES)}


class ChunkRecorder:
    """A draw stream that records the chunks it was asked for (either
    sampler's; the one-shot draw is chunk None)."""

    def __init__(self, ransac, seed):
        self.inner = ransac.torch_draws(seed)
        self.chunks = set()

    def __call__(self, c, e):
        self.chunks.add(c)
        return self.inner(c, e)

    def triples(self, c, h, count):
        if c is not None:
            self.chunks.add(c)
        return self.inner.triples(c, h, count)

    def rows(self, n, count):
        return self.inner.rows(n, count)


def graph_against_eager(torch, ransac, rs, h, prefix, out):
    """RANSAC through ``rs(graph, **kw)`` (its result and chunks run) with
    the chunks replayed as one CUDA graph against the same chunks run
    eagerly: the same winner and pose bit for bit, the CUDA API launches
    a chunk either way, host ms in turns (eager, graph, graph, eager) and
    device busy, into ``out`` under ``prefix``."""
    (res_e, ch_e), (res_g, ch_g) = rs(False), rs(True)
    same = (torch.equal(res_e.transformation, res_g.transformation)
            and float(res_e.fitness) == float(res_g.fitness)
            and ch_e == ch_g)
    log(f"RANSAC {prefix}graph vs eager: {ch_g} chunks, fitness "
        f"{float(res_g.fitness):.5f} / {float(res_e.fitness):.5f}, pose bit "
        f"for bit {same}")
    check(same, f"the graph-replayed {prefix}chunks disagree with the eager "
          "ones")
    out[prefix + "chunks"] = ch_g
    out[prefix + "fitness"] = float(res_g.fitness)
    # Launches a chunk: calls that run every chunk of the budget
    # (confidence 1.0), against calls of the fewest chunks the chunked
    # route runs (a budget of one chunk and one hypothesis).
    few_kw = dict(confidence=1.0, max_iterations=h + 1, hyp_chunk=h)
    for graph in (False, True):
        name = "graph" if graph else "eager"
        # Warm: the graph of this shape is captured outside the count.
        c_many = rs(graph, confidence=1.0)[1]
        c_few = rs(graph, **few_kw)[1]
        many = api_launches(torch, lambda: rs(graph, confidence=1.0))
        few = api_launches(torch, lambda: rs(graph, **few_kw))
        per = (sum(many.values()) - sum(few.values())) / max(
            c_many - c_few, 1)
        out[f"{prefix}api_launches_{name}"] = many
        out[f"{prefix}api_launches_per_chunk_{name}"] = per
        out[f"{prefix}chunks_all_budget_{name}"] = c_many
        log(f"RANSAC {prefix}{name}: {sum(many.values())} API launches over "
            f"{c_many} chunks, {sum(few.values())} over {c_few}: {per:.1f} "
            f"a chunk; {many}")
    times = {"eager": [], "graph": []}
    for graph in (False, True, True, False):
        times["graph" if graph else "eager"] += host_ms(
            torch, lambda: rs(graph), warm=1, reps=3)[0]
    for name, t in times.items():
        out[f"{prefix}ransac_ms_{name}"] = t
        out[f"{prefix}ransac_ms_{name}_median"] = statistics.median(t)
        out[f"{prefix}device_busy_ms_{name}"] = device_busy_ms(
            torch, lambda: rs(name == "graph"))
    log(f"RANSAC {prefix}call: eager median "
        f"{out[prefix + 'ransac_ms_eager_median']:.2f} ms, graph median "
        f"{out[prefix + 'ransac_ms_graph_median']:.2f} ms; device busy "
        f"{out[prefix + 'device_busy_ms_eager']:.3f} / "
        f"{out[prefix + 'device_busy_ms_graph']:.3f} ms")


def chunk_graph_phase(torch, np, dev, args):
    """Phase 10: on phase 4's pair, RANSAC on the sparse subset (as the
    main path calls it, the rotation sampler) with its chunks replayed as
    one CUDA graph against the same chunks run eagerly
    (``graph_against_eager``), then ``register_pair`` either way, the
    same pose, through the gate; and the gather sampler's chunks
    (``sampling='gather'``) at bucket 8,192 the same way (``gather_``
    keys), K11 launched once a chunk either way. A tree without K11 or
    the gather graph runs those chunks eagerly both ways."""
    import tpu3d_torch
    from tpu3d_torch import registration as reg
    from tpu3d_torch.models.fixtures import make_pair
    from tpu3d_torch.ops import fused_features, ransac

    t_phase = time.perf_counter()
    src_np, tgt_np, R_true, t_true = make_pair(args.points)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=args.voxel)
    src = tpu3d_torch.PointCloud.from_numpy(src_np, device=dev)
    tgt = tpu3d_torch.PointCloud.from_numpy(tgt_np, device=dev)
    sd = reg.downsample_bucketed(src, cfg)
    td = reg.downsample_bucketed(tgt, cfg)
    radius = float(np.float32(args.voxel * 5.0))
    tdp, tf = reg.prepare_features(td, cfg, "fused")
    tf = ransac.with_target_operand(tf)
    sub_c, sub_f, _ = fused_features.fused_prepare_sparse(sd, radius)
    iters = cfg.ransac_max_iterations
    h = ransac.hypothesis_chunk(iters)

    def runner(s_c, t_c, s_f, t_f, voxel, **fixed):
        def rs(graph, **kw):
            rec = ChunkRecorder(ransac, cfg.ransac_seed)
            ransac.CHUNK_GRAPH = graph
            try:
                res = ransac.ransac_registration(
                    s_c, t_c, s_f, t_f, voxel, seed=cfg.ransac_seed,
                    corr_mode="exact", draws=rec, **dict(
                        dict(max_iterations=iters,
                             confidence=cfg.ransac_confidence, **fixed),
                        **kw))
                torch.cuda.synchronize()
            finally:
                ransac.CHUNK_GRAPH = True
            return res, len(rec.chunks)
        return rs

    out = {"route": "RANSAC chunks: CUDA graph against eager",
           "fixture": f"make_pair({args.points}), voxel {args.voxel}, the "
                      "sparse subset; gather_: make_pair(8192), voxel "
                      f"{VOXEL}, sampling 'gather'", "hyp_chunk": h}
    graph_against_eager(torch, ransac, runner(sub_c, tdp, sub_f, tf,
                                              args.voxel), h, "", out)
    # The whole pair either way.
    poses, pair_ms = {}, {}
    for graph in (False, True):
        ransac.CHUNK_GRAPH = graph
        try:
            t, (refined, _) = host_ms(
                torch, lambda: tpu3d_torch.register_pair(src, tgt, cfg),
                warm=1, reps=3)
        finally:
            ransac.CHUNK_GRAPH = True
        name = "graph" if graph else "eager"
        rot_err, trn_err = gate(np, refined, R_true, t_true)
        poses[name] = refined.transformation
        pair_ms[name] = t
        out[f"pair_ms_{name}"] = t
        out[f"pair_errors_{name}"] = [rot_err, trn_err]
    check(torch.equal(poses["eager"], poses["graph"]),
          "register_pair's pose differs between graph and eager chunks")
    log(f"register_pair: eager {pair_ms['eager']} ms, graph "
        f"{pair_ms['graph']} ms, poses bit for bit")

    # The gather sampler's chunks at bucket 8,192.
    g_src, g_tgt, _, _ = make_pair(N_POINTS, voxel=VOXEL)
    g_cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL)
    g_s, g_sf = reg.prepare_features(reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(g_src, device=dev), g_cfg), g_cfg,
        "fused")
    g_t, g_tf = reg.prepare_features(reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(g_tgt, device=dev), g_cfg), g_cfg,
        "fused")
    g_tf = ransac.with_target_operand(g_tf)
    k11 = getattr(ransac, "gather_hypotheses", None)
    rs_g = runner(g_s, g_t, g_sf, g_tf, VOXEL, sampling="gather")
    for graph in (False, True):
        rs_g(graph)  # warm: the graph is captured outside the count
        before = k11.launches if k11 else 0
        chunks = rs_g(graph)[1]
        launched = (k11.launches - before) if k11 else None
        out[f"gather_k11_launches_{'graph' if graph else 'eager'}"] = launched
        check(k11 is None or launched == chunks,
              f"K11 launched {launched} times over {chunks} gather chunks")
    graph_against_eager(torch, ransac, rs_g, h, "gather_", out)
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return out


def run(args):
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from tpu3d_torch import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):  # the compiler's report
        build.build(verbose=True)
    build.library()
    build_s = time.perf_counter() - t0
    log(report.getvalue())
    log(f"kernels built in {build_s:.1f} s")
    resources = kernel_resources(report.getvalue())
    from tpu3d_torch import native

    t0 = time.perf_counter()
    check(native.available(), "the host runtime did not build")
    host_build_s = time.perf_counter() - t0
    log(f"host runtime built in {host_build_s:.1f} s")

    card_states = {"phase 3": card_state()}
    k5, k6, k7, k7m, k12, ref_route = reference_route(torch, np, dev)
    k12.update({"name": "knn_select (K12)", "route": "cuda",
                "source": "tpu3d_torch/csrc/knn_select.cu",
                "replaces": "lax.top_k in tpu3d/ops/neighbors.py knn "
                            "(XLA-compiled, no pallas_call)"})
    k5.update({"name": "nn_top1 (K5)", "route": "cuda",
               "source": "tpu3d_torch/csrc/nn.cu",
               "replaces": "tpu3d/ops/nn_pallas.py:111"})
    k6.update({"name": "ransac_score (K6)", "route": "cuda",
               "source": "tpu3d_torch/csrc/ransac_score.cu",
               "replaces": "tpu3d/ops/ransac_pallas.py:51"})
    k7.update({"name": "icp_p2plane_stats (K7, with the one-window K1 walk)",
               "route": "cuda", "source": "tpu3d_torch/csrc/icp_stats.cu",
               "replaces": "tpu3d/ops/icp_pallas.py:141"})
    k7m.update({"name": "icp_matches (K7's match-only epilogue, "
                        "point-to-point ICP)",
                "route": "cuda", "source": "tpu3d_torch/csrc/icp_stats.cu",
                "replaces": "tpu3d/ops/icp_pallas.py:141"})
    k10 = {"name": "ransac_hyp (K10)", "route": "cuda",
           "source": "tpu3d_torch/csrc/ransac_hyp.cu",
           "replaces": "tpu3d/ops/ransac.py:173 (XLA-compiled, no "
                       "pallas_call)"}
    k11 = {"name": "gather_hyp (K11)", "route": "cuda",
           "source": "tpu3d_torch/csrc/ransac_hyp.cu",
           "replaces": "tpu3d/ops/ransac.py:414 (XLA-compiled, no "
                       "pallas_call)"}
    card_states["phase 4"] = card_state()
    sweeps, scale_route = at_scale_route(torch, np, dev, args.points,
                                         args.voxel, k5, k6, k7, k7m, k10,
                                         k11)
    scale_route["build_s"] = build_s

    from tpu3d_torch.ops import (
        depth,
        features,
        icp_stats,
        nn,
        ransac_score,
    )

    k9 = {"name": "bilateral_filter (K9)", "route": "cuda",
          "source": "tpu3d_torch/csrc/depth.cu",
          "replaces": "tpu3d/ops/depth.py:88"}
    counters = {"K2": features.moments_sweep, "K3": features.spfh_sweep,
                "K4": features.fpfh_sweep, "K5": nn.nearest_neighbor,
                "K6": ransac_score.score_hypotheses,
                "K7": icp_stats.icp_p2plane_stats,
                "K9": depth.bilateral_filter}
    card_states["phase 5"] = card_state()
    cli, bin_route, host = pipeline_phase(torch, np, counters, k9,
                                          sweeps + [k7])
    host["build_s"] = host_build_s
    k9["launches"] = bin_route["launches"]["K9"]
    kernels = sweeps + [k5, k6, k7, k9]
    for entry, name in zip(kernels, counters):
        entry["launches_pipeline"] = bin_route["launches"][name]
        entry["launches_cli"] = cli["launches"][name]
    card_states["phase 6"] = card_state()
    k8, probe_entries, scene_routes = scene_phase(
        torch, np, dev, args, sweeps + [k5, k6, k7],
        {k: f for k, f in counters.items() if k != "K9"})
    k8["card"] = smi
    card_states["phase 7"] = card_state()
    entry_routes = entry_points_phase(
        torch, np, dev, args, {k: f for k, f in counters.items()
                               if k != "K9"})
    for entry, name in zip(sweeps + [k5, k6, k7], counters):
        entry["launches_multiscale"] = entry_routes[0]["launches"][name]
    card_states["phase 8"] = card_state()
    from tpu3d_torch.ops import nn_walk

    sharded_counters = {k: counters[k] for k in ("K2", "K3", "K4", "K5",
                                                 "K6")}
    sharded_counters["K8"] = nn_walk.top1_walk
    sharded_routes = sharded_phase(torch, np, dev, args,
                                   sweeps + [k5, k6, k8], sharded_counters)
    k7m["launches_pipeline_knobs"] = bin_route["knobs"]["launches"]["K7"]
    k10["launches_pipeline"] = bin_route["k10_launches"]
    # K11's main path is the pipeline's: the bin frame's small instance.
    k11["launches"] = bin_route["k11_launches"]
    k11["launches_pipeline_knobs"] = bin_route["knobs"]["k11_launches"]
    k11["launches_two_stage_pair"] = (
        scale_route["two_stage"]["k11_launches_per_pair"])
    k11["launches_batch"] = scene_routes[2]["k11_launches"]
    k11["launches_cli"] = cli["hyp_launches"]["K11"]
    kernels = kernels + [k7m, k10, k11, k12]
    card_states["phase 9"] = card_state()
    example_counters = {k: f for k, f in counters.items() if k != "K9"}
    example_counters.update({"K7m": icp_stats.icp_matches,
                             "K8": nn_walk.top1_walk})
    example_routes = examples_phase(torch, np, dev, example_counters)
    card_states["phase 10"] = card_state()
    graph_route = chunk_graph_phase(torch, np, dev, args)
    for entry, name in zip(sweeps + [k5, k6, k7, k7m, k8],
                           ("K2", "K3", "K4", "K5", "K6", "K7", "K7m", "K8")):
        entry["launches_example"] = example_routes[0]["launches"][name]
        entry["launches_example_multichip"] = (
            example_routes[1]["launches"][name])
    for e in kernels + [k8] + probe_entries:
        # The tensor-core bound and the split count exist for K5's
        # descriptor route and K6 only.
        e.setdefault("bound_tc_ms", None)
        e.setdefault("splits", None)
        funcs = KERNEL_FUNCTIONS.get(e["name"].split(" (")[0].replace(
            "probe ", ""), [])
        e["registers"] = {f: resources[f]["registers"] for f in funcs
                          if f in resources}
        e["spill_bytes"] = {f: resources[f]["spill_bytes"] for f in funcs
                            if f in resources}

    print(json.dumps({"kernels": kernels + [k8] + probe_entries}),
          flush=True)
    card_states["end"] = card_state()
    log(f"card state by phase: {card_states}")
    scene_routes[-1]["card_states"] = card_states
    for route in ([ref_route, scale_route, cli, bin_route, host]
                  + scene_routes + entry_routes + sharded_routes
                  + example_routes + [graph_route]):
        print(json.dumps(route), flush=True)
    return {
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": 1},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=100352,
                    help="points of the at-scale pair (make_pair)")
    ap.add_argument("--voxel", type=float, default=0.002,
                    help="voxel size of the at-scale pair")
    ap.add_argument("--scene-points", type=int, default=1 << 20,
                    help="points of the 1M scene (phase 6a and 6b)")
    ap.add_argument("--instances", type=int, default=64,
                    help="instances of the batch (phase 6c)")
    args = ap.parse_args()
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
        result = run(args)
    except Exception:  # every phase is fatal: report and exit non-zero
        traceback.print_exc()
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
