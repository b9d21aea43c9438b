"""Registration over a device mesh with the PyTorch/CUDA port.

    python examples/torch_register_pair_multichip.py              # every card
    python examples/torch_register_pair_multichip.py --virtual 4  # 4 shards
    python examples/torch_register_pair_multichip.py --device cpu --virtual 4

The workload of ``examples/register_pair_multichip.py``: every stage
(halo-exchange prepare sweeps, feature NN, RANSAC hypotheses, ICP
correspondence search) runs sharded over a 1-D 'shard' mesh of the
visible devices (``tpu3d_torch/parallel/register_sharded.py``); with one
device it runs on that device alone. ``--virtual N`` makes the first
device seen N times (``see_first_device``), the counterpart of the JAX
example's forced host device count: the shards then run one after
another on it. ``main`` also returns (rotation error, translation error,
refined fitness).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu3d_torch import (  # noqa: E402
    PointCloud,
    RegistrationConfig,
    register_pair,
)
from tpu3d_torch.parallel import make_mesh  # noqa: E402
from tpu3d_torch.parallel.mesh import (  # noqa: E402
    see_first_device,
    visible_devices,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_register_pair import axis_angle_matrix  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the type of the mesh's devices")
    ap.add_argument("--virtual", type=int, default=0,
                    help="see the first device this many times (0: the "
                         "real devices)")
    ap.add_argument("--points", type=int, default=20000,
                    help="points of the surface")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    n = args.points
    voxel = 0.004
    r5 = 5.0 * voxel
    xy = rng.uniform(-0.2, 0.2, size=(n, 2)).astype(np.float32)
    # Curvature at the descriptor-radius scale keeps FPFH discriminative.
    w1, w2 = 1.2 / r5, 0.45 / r5
    z = (
        0.7
        + 2.5 * voxel * np.sin(w1 * xy[:, 0]) * np.cos(0.8 * w1 * xy[:, 1])
        + 6.0 * voxel * np.cos(w2 * xy[:, 0]) * np.cos(1.1 * w2 * xy[:, 1])
    )
    target = np.column_stack([xy, z]).astype(np.float32)

    R = axis_angle_matrix([0.1, -0.05, 0.15])
    t = np.array([0.02, -0.01, 0.03], np.float32)
    source = ((target - t) @ R).astype(np.float32)

    see_first_device(args.virtual, args.device)
    try:
        devices = visible_devices(args.device)
        mesh = (make_mesh(("shard",), devices=devices)
                if len(devices) >= 2 else None)
        print(f"devices: {len(devices)} → "
              f"{'mesh ' + str(mesh.shape) if mesh else 'single-device'}")
        cfg = RegistrationConfig(voxel_size=voxel,
                                 ransac_max_iterations=20000)
        refined, coarse = register_pair(
            PointCloud.from_numpy(source, device=devices[0]),
            PointCloud.from_numpy(target, device=devices[0]),
            cfg,
            mesh=mesh,
        )
    finally:
        see_first_device(0, args.device)
    T = refined.transformation.cpu().numpy()
    r_err = float(np.abs(T[:3, :3] - R).max())
    t_err = float(np.abs(T[:3, 3] - t).max())
    print(f"coarse fitness {float(coarse.fitness):.3f}; "
          f"refined fitness {float(refined.fitness):.3f} "
          f"rmse {float(refined.rmse):.6f}")
    print(f"rotation error  {r_err:.2e}")
    print(f"translation err {t_err:.2e}")
    return r_err, t_err, float(refined.fitness)


if __name__ == "__main__":
    main()
