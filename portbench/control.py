"""Readings the comparison's limits are set from (not part of a run).

    python3 portbench/control.py --workload <name> --seeds 1 2 3 ...

For each seed: the cell's set-up and warm-up, then as many requests as a
run checks, captured; then the comparison's numbers twice, for the
program and for the control (the reference computed in TF32 in the
program's place, ``reference/geometry.Precision('tf32')``). One JSON line
a seed on standard output: {"seed", "program": {...}, "control": {...},
"quantiles": {"program": {...}, "control": {...}}}, the last the per-row
gaps at several quantiles (``reference/judge.DIAG``).
The lower reading of a number is the largest the program gives over the
seeds, the upper the smallest the control gives (``PERF.md``).
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(cell, seed: int, device: str = "cuda",
             with_control: bool = True) -> dict:
    from portbench.harness.capture import Capture, patched
    from portbench.harness.runner import judge_records
    from portbench.reference.geometry import Precision

    seed = int(seed) % (1 << 63)
    items = cell.generator().generate(cell.traffic, cell.config, seed)
    drv = cell.driver().Driver(cell.config, items, device)
    pool = drv.pool
    for i in range(pool):
        drv.request(i)
    capture = Capture()
    gate_miss = 0
    n = min(int(cell.workload["checked_requests"]), pool)
    with patched(drv.patch_points(), capture.wrap):
        for k in range(n):
            capture.current = k
            gate_miss += drv.request(k)["gate_miss"]
        capture.current = None
    fit = cell.config["registration"]["min_fitness"]
    program, _, program_q = judge_records(capture.records, drv, pool, fit)
    program["gate_miss"] = gate_miss / n
    control = control_q = None
    if with_control:
        control, _, control_q = judge_records(capture.records, drv, pool,
                                              fit, Precision("tf32"))
    drv.close()
    return {"seed": seed, "program": program, "control": control,
            "quantiles": {"program": program_q, "control": control_q}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=None,
                   help="run the control on the first N seeds only")
    args = p.parse_args(argv)
    out_fd = os.dup(1)
    os.dup2(2, 1)
    from portbench.harness import spec

    cell = spec.cell(args.workload)
    for i, seed in enumerate(args.seeds):
        line = readings(cell, seed, with_control=args.control is None
                        or i < args.control)
        os.write(out_fd, (json.dumps(line) + "\n").encode())
    return 0


if __name__ == "__main__":
    sys.exit(main())
