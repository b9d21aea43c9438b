#!/usr/bin/env python3
"""RANSAC's chunk loop on the card, for one checkout of ``tpu3d_torch``.

  python3 scripts/ransac_chunk_launches.py [--root DIR] [--points N]
                                           [--voxel V]

Runs ``chip_smoke.py``'s phase 10 (``chunk_graph_phase``: RANSAC on the
100k pair's sparse subset with its chunks replayed as a CUDA graph and run
eagerly, the same poses, the CUDA API launches a chunk, host and device
ms in turns, then ``register_pair`` either way) on the ``tpu3d_torch``
package found under ``--root`` (default: this checkout), so that two trees
are measured in one call on one card. A tree without the chunk graph runs
its chunks eagerly both ways. Prints the route as one JSON line; exits 2
without a CUDA device.
"""

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    route = smoke.chunk_graph_phase(torch, np, torch.device("cuda", 0),
                                    args)
    route["package"] = os.path.relpath(package, HERE)
    print(json.dumps(route), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
