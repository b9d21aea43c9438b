"""Run one cell of the benchmark of ``tpu3d_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number of the comparison with its
limit, which also close standard error. Everything the program prints
goes to standard error. Without a CUDA device (or with fewer than the cell
asks for), or with JAX or the JAX package loaded after the window, the
run exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Caches live at fixed paths inside the checkout, so that only a cell's
# first run in a checkout compiles. The program builds its kernels into
# tpu3d_torch/_build/ on its own.
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def finite(obj):
    """The result with every non-finite number as null (strict JSON)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    return obj


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # The program prints its stages: standard output carries only the
    # result, so everything else goes to standard error, C code included.
    out_fd = os.dup(1)
    os.dup2(2, 1)
    from portbench.harness import runner, spec

    cell = spec.cell(args.workload)
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        runner.log(f"needs {chips} CUDA device(s); found "
                   f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        T_START)
    found = runner.forbidden_modules()
    if found:
        runner.log(f"forbidden modules loaded: {', '.join(found)}")
        return 4
    for name, c in result["checks"].items():
        runner.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    sys.stdout.flush()
    os.write(out_fd, (json.dumps(finite(result), allow_nan=False)
                      + "\n").encode())
    return 0


if __name__ == "__main__":
    sys.exit(main())
