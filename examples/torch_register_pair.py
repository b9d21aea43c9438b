"""Minimal example of the PyTorch/CUDA port: register a synthetic cloud
pair end to end.

    python examples/torch_register_pair.py                 # on the card
    python examples/torch_register_pair.py --device cpu    # plain PyTorch

The workload of ``examples/register_pair.py``: a bumpy surface, rigidly
perturbed, through ``tpu3d_torch.register_pair`` (downsample → normals →
FPFH → RANSAC → ICP), and the recovered pose against ground truth.
``main`` also returns (rotation error, translation error, refined
fitness), the largest absolute differences of R and t.
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


def axis_angle_matrix(aa) -> np.ndarray:
    """Rodrigues' rotation of the axis-angle vector ``aa`` (float32)."""
    aa = np.asarray(aa, np.float64)
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(
        np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the clouds and the registration live")
    ap.add_argument("--points", type=int, default=20000,
                    help="points of the surface")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    n = args.points
    xy = rng.uniform(-0.2, 0.2, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.03 * np.sin(40 * xy[:, 0]) * np.cos(35 * xy[:, 1])
    target = np.column_stack([xy, z]).astype(np.float32)

    R = axis_angle_matrix([0.1, -0.05, 0.15])
    t = np.array([0.03, -0.02, 0.01], np.float32)
    source = ((target - t) @ R).astype(np.float32)

    cfg = RegistrationConfig(voxel_size=0.004, ransac_max_iterations=20000)
    refined, coarse = register_pair(
        PointCloud.from_numpy(source, device=args.device),
        PointCloud.from_numpy(target, device=args.device),
        cfg,
    )

    T = refined.transformation.cpu().numpy()
    r_err = float(np.abs(T[:3, :3] - R).max())
    t_err = float(np.abs(T[:3, 3] - t).max())
    print(f"coarse fitness: {float(coarse.fitness):.3f}")
    print(f"refined fitness: {float(refined.fitness):.3f}, "
          f"rmse: {float(refined.rmse):.2e}")
    print(f"rotation error:    {r_err:.2e}")
    print(f"translation error: {t_err:.2e} m")
    return r_err, t_err, float(refined.fitness)


if __name__ == "__main__":
    main()
