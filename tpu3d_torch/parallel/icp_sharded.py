"""ICP with the target rows sharded over a device mesh.

Counterpart of ``tpu3d/parallel/icp_sharded.py``: only the
correspondence search is distributed (per-shard top-1 and the global
argmin); the loop is the single-device ``icp_loop`` over
``gathered_stats_fn``. The matched target rows and normals are gathered
from the full target on the lead device, as JAX's logically global arrays
give them.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3d_torch.ops.icp import gathered_stats_fn, icp_loop
from tpu3d_torch.ops.transforms import transform_points
from tpu3d_torch.parallel.mesh import Mesh
from tpu3d_torch.parallel.sharded_nn import (
    build_slab_sharded,
    build_walk_sharded,
    nearest_neighbor_sharded,
    slab2_top1_sharded,
    slab_top1_sharded,
)
from tpu3d_torch.types import PointCloud, RegistrationResult


def icp_refine_sharded(
    source: PointCloud,
    target: PointCloud,
    initial_transform: torch.Tensor,
    distance_threshold,
    mesh: Mesh,
    axis: str = "shard",
    max_iterations: int = 200,
    point_to_plane: bool = True,
    nn_mode: str = "slab2",
    slice_cap: int = 4096,
) -> RegistrationResult:
    """:func:`~tpu3d_torch.ops.icp.icp_refine`'s semantics with the target
    rows sharded over ``axis`` (rows divisible by the axis size: pad with
    masked rows).

    ``nn_mode``: 'slab2' per-shard slab2 windows walked by K8 (radius-exact
    for any occupancy, the default); 'slab' the legacy per-shard x-sorted
    slices of ``slice_cap`` rows, with the source x-sorted at the initial
    pose; 'brute' K5 over each shard."""
    thr = float(np.float32(distance_threshold))
    use_p2l = point_to_plane and target.normals is not None
    n_valid = max(float(source.mask.sum()), 1.0)
    src_pts = source.points.to(torch.float32)
    smask = source.mask

    if nn_mode == "slab2":
        sw = build_walk_sharded(target.points, target.mask, thr, mesh, axis)

        def corr_fn(P):
            return slab2_top1_sharded(sw, P, smask, thr, mesh, axis=axis)

    elif nn_mode == "slab":
        sslab = build_slab_sharded(target.points, target.mask, mesh, axis)
        # Query blocks stay coherent with the source x-sorted at the
        # initial pose; every loop reduction ignores the row order.
        x0 = transform_points(initial_transform.to(torch.float32).to(
            src_pts.device), src_pts)[:, 0]
        _, order = torch.sort(torch.where(smask, x0, 3e4), stable=True)
        src_pts, smask = src_pts[order], smask[order]

        def corr_fn(P):
            return slab_top1_sharded(sslab, P, thr, mesh, axis=axis,
                                     slice_cap=slice_cap)

    elif nn_mode == "brute":

        def corr_fn(P):
            return nearest_neighbor_sharded(P, target.points, target.mask,
                                            mesh, axis=axis)

    else:
        raise ValueError(f"unknown nn_mode {nn_mode!r}")

    stats = gathered_stats_fn(
        corr_fn, src_pts, smask, target.points,
        target.normals if use_p2l else None, thr, use_p2l)
    return icp_loop(stats, n_valid, initial_transform, max_iterations,
                    use_p2l)
