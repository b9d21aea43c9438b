#!/usr/bin/env python3
"""RANSAC's chunk loop and the 100k pair on the card, for one checkout of
``tpu3d_torch``.

  python3 scripts/ransac_chunk_launches.py [--root DIR] [--points N]
                                           [--voxel V]

First times ``register_pair`` on ``make_pair(points)`` at ``voxel`` (the
sparse arm, every other RegistrationConfig field at its default, as
``chip_smoke.py``'s phase 4), 10 warm pairs after two warm-up pairs, each
ending in a device sync, with ``two_stage`` 'auto' (the rotation
sampler's chunks) and 'on' (the gather sampler's one shot): host ms and
the main thread's CPU ms of each pair (``pair_ms_two_stage_*``,
``pair_cpu_ms_two_stage_*``). Then runs ``chip_smoke.py``'s phase 10 (``chunk_graph_phase``: RANSAC on the
100k pair's sparse subset, the rotation sampler, with its chunks replayed
as a CUDA graph and run eagerly, the same poses, the CUDA API launches a
chunk, host and device ms in turns, then ``register_pair`` either way;
and the gather sampler's chunks at bucket 8,192 the same way, its
``gather_`` keys) on the ``tpu3d_torch`` package found under ``--root``
(default: this checkout), so that two trees are measured in one call on
one card. A tree without a chunk graph for a sampler runs those chunks
eagerly both ways. Prints the whole as one JSON line with the card's name
and power limit; exits 2 without a CUDA device. Run it on two trees in
turns (parent, change, change, parent) to compare them.
"""

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pair_times(torch, tpu3d_torch, dev, args, reps=10, warm=2):
    """{key: value} of warm ``register_pair`` host and main-thread CPU ms
    on the 100k pair, ``two_stage`` 'auto' and then 'on'."""
    from tpu3d_torch.models.fixtures import make_pair

    src_np, tgt_np, _, _ = make_pair(args.points)
    src = tpu3d_torch.PointCloud.from_numpy(src_np, device=dev)
    tgt = tpu3d_torch.PointCloud.from_numpy(tgt_np, device=dev)
    out = {}
    for two_stage in ("auto", "on"):
        cfg = tpu3d_torch.RegistrationConfig(voxel_size=args.voxel,
                                             two_stage=two_stage)
        wall, cpu = [], []
        for i in range(warm + reps):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.thread_time()
            refined, _ = tpu3d_torch.register_pair(src, tgt, cfg)
            torch.cuda.synchronize()
            if i >= warm:
                wall.append((time.perf_counter() - t0) * 1e3)
                cpu.append((time.thread_time() - c0) * 1e3)
        out[f"pair_ms_two_stage_{two_stage}"] = wall
        out[f"pair_ms_two_stage_{two_stage}_median"] = statistics.median(
            wall)
        out[f"pair_cpu_ms_two_stage_{two_stage}"] = cpu
        out[f"pair_cpu_ms_two_stage_{two_stage}_median"] = (
            statistics.median(cpu))
        out[f"pair_fitness_two_stage_{two_stage}"] = float(refined.fitness)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="directory that holds the tpu3d_torch to measure")
    ap.add_argument("--points", type=int, default=100352)
    ap.add_argument("--voxel", type=float, default=0.002)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import tpu3d_torch

    package = os.path.dirname(os.path.abspath(tpu3d_torch.__file__))
    smoke.log(f"measuring {package}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    pairs = pair_times(torch, tpu3d_torch, dev, args)
    route = smoke.chunk_graph_phase(torch, np, dev, args)
    route.update(pairs, package=os.path.relpath(package, HERE), card=card)
    print(json.dumps(route), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
