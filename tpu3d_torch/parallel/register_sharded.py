"""Distributed registration behind the public surface.

Counterpart of ``tpu3d/parallel/register_sharded.py``: the halo-exchange
prepare (``prepare_sharded``), the sharded descriptor NN and RANSAC
(``ransac_sharded``) and the sharded ICP (``icp_sharded``) composed as
``register_pair(..., mesh=mesh)`` and the pipeline's ``parallel:`` block
use them. When the prepare's exactness flag comes back False, the prepare
of that cloud runs once more on the lead device (the JAX package's loud
fallback, on the same partitioned rows and still through K2-K4); RANSAC
and ICP stay sharded either way.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu3d_torch.config import ParallelConfig, RegistrationConfig
from tpu3d_torch.ops.fused_features import fused_prepare_features
from tpu3d_torch.ops.ransac import Draws
from tpu3d_torch.parallel.icp_sharded import icp_refine_sharded
from tpu3d_torch.parallel.mesh import Mesh, make_mesh, visible_devices
from tpu3d_torch.parallel.prepare_sharded import (
    fused_prepare_sharded,
    x_partition,
)
from tpu3d_torch.parallel.ransac_sharded import ransac_registration_sharded
from tpu3d_torch.types import FPFHFeatures, PointCloud, RegistrationResult


def parallel_mesh(par: Optional[ParallelConfig],
                  device_type: str = "cuda") -> Optional[Mesh]:
    """A ``parallel:`` block → a 1-D ('shard',) mesh over the visible
    ``device_type`` devices (the first ``par.devices`` when positive), or
    None: mode 'off', or fewer than 2 devices ('on' then says so)."""
    if par is None or par.mode == "off":
        return None
    devices = visible_devices(device_type)
    n = len(devices) if par.devices <= 0 else min(par.devices, len(devices))
    if n < 2:
        if par.mode == "on":
            print("parallel.mode=on but only one device is visible — "
                  "running single-device")
        return None
    return make_mesh(("shard",), devices=devices[:n])


def _pad_rows(a: torch.Tensor, rows: int, value=0):
    pad = rows - a.shape[0]
    if pad <= 0:
        return a
    fill = torch.full((pad,) + tuple(a.shape[1:]), value, dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, fill])


def pad_cloud_to_multiple(
    cloud: PointCloud, features: Optional[FPFHFeatures], n_shards: int
) -> tuple[PointCloud, Optional[FPFHFeatures]]:
    """Pad a cloud (and its features) with masked rows, points at 3e4, so
    the row count divides the mesh axis."""
    m = cloud.capacity
    rows = n_shards * (-(-m // n_shards))
    if rows == m:
        return cloud, features
    cloud = PointCloud(
        points=_pad_rows(cloud.points, rows, 3e4),
        mask=_pad_rows(cloud.mask, rows, False),
        normals=None if cloud.normals is None
        else _pad_rows(cloud.normals, rows),
        colors=None if cloud.colors is None
        else _pad_rows(cloud.colors, rows),
    )
    if features is not None:
        features = FPFHFeatures(
            descriptors=_pad_rows(features.descriptors, rows),
            mask=_pad_rows(features.mask, rows, False),
        )
    return cloud, features


def default_halo(down: PointCloud, voxel_size: float) -> Optional[int]:
    """The radius-aware halo: rows per unit of x over the valid extent
    times 3·radius, with 1.6x room for density changes, at least 1,024
    (None for an empty cloud)."""
    xs = down.points[:, 0][down.mask].cpu().numpy()
    if not xs.size:
        return None
    span = max(float(xs.max() - xs.min()), 1e-9)
    need = int(3.0 * float(voxel_size * 5.0) / span * xs.size * 1.6) + 1
    return max(1024, need)


def prepare_features_sharded(
    down: PointCloud,
    config: RegistrationConfig,
    mesh: Mesh,
    axis: str = "shard",
    halo: Optional[int] = None,
) -> tuple[PointCloud, FPFHFeatures, bool]:
    """Distributed normals + FPFH of a downsampled cloud: x-partitioned
    rows (registration ignores row order) through the halo-exchange
    prepare. Returns (cloud, features, distributed); ``distributed`` False
    means the exactness flag failed and the lead device's fused prepare
    produced the result (same partitioned rows)."""
    n_shards = mesh.shape[axis]
    radius = float(np.float32(config.voxel_size * 5.0))
    if halo is None:
        halo = default_halo(down, config.voxel_size)
    pts, msk, _ = x_partition(down.points, down.mask, n_shards)
    cloud, feat, ok = fused_prepare_sharded(pts, msk, radius, mesh=mesh,
                                            axis=axis, halo=halo or None)
    if bool(ok):
        return cloud, feat, True
    print("tpu3d_torch: sharded prepare halo check failed — falling back to "
          "the single-device prepare for this cloud")
    cloud, feat = fused_prepare_features(PointCloud(points=pts, mask=msk),
                                         radius)
    return cloud, feat, False


def register_prepared_sharded(
    source: PointCloud,
    target: PointCloud,
    source_features: Optional[FPFHFeatures],
    target_features: FPFHFeatures,
    config: RegistrationConfig,
    mesh: Mesh,
    axis: str = "shard",
    corr_mode: Optional[str] = None,
    icp_source: Optional[PointCloud] = None,
    draws: Draws | None = None,
) -> tuple[RegistrationResult, RegistrationResult]:
    """Sharded RANSAC + sharded ICP on prepared clouds → (refined, coarse).
    ``icp_source`` (default ``source``) is what ICP refines, for a caller
    that hands RANSAC a sparse subset view with ``corr_mode='exact'``. The
    target is padded to a multiple of the axis."""
    n_shards = mesh.shape[axis]
    target, target_features = pad_cloud_to_multiple(
        target, target_features, n_shards)
    coarse = ransac_registration_sharded(
        source, target, source_features, target_features, config.voxel_size,
        mesh=mesh, axis=axis,
        max_iterations=config.ransac_max_iterations,
        confidence=config.ransac_confidence,
        seed=config.ransac_seed,
        corr_mode=corr_mode if corr_mode is not None else config.corr_mode,
        draws=draws,
    )
    refined = icp_refine_sharded(
        icp_source if icp_source is not None else source,
        target,
        coarse.transformation,
        config.voxel_size * config.icp_distance_factor,
        mesh=mesh,
        axis=axis,
        max_iterations=config.icp_max_iterations,
        point_to_plane=config.use_point_to_plane
        and target.normals is not None,
    )
    return refined, coarse


def register_pair_sharded(
    source: PointCloud,
    target: PointCloud,
    config: Optional[RegistrationConfig] = None,
    mesh: Optional[Mesh] = None,
    axis: str = "shard",
    halo: Optional[int] = None,
    return_info: bool = False,
    draws: Draws | None = None,
):
    """Full distributed registration of two raw clouds: prepare sweeps,
    descriptor NN, RANSAC hypotheses and ICP correspondences all over the
    mesh (default: every visible device of the clouds' type).
    ``return_info`` adds {mode, src_prepare_distributed,
    tgt_prepare_distributed, n_shards}."""
    from tpu3d_torch.registration import (
        downsample_bucketed,
        prepare_features,
        resolve_neighbor_mode,
    )

    if config is None:
        config = RegistrationConfig()
    if mesh is None:
        mesh = make_mesh((axis,),
                         devices=visible_devices(source.points.device.type))
    n_shards = mesh.shape[axis]

    src_down = downsample_bucketed(source, config)
    tgt_down = downsample_bucketed(target, config)
    # One descriptor variant for both clouds; the sharded prepare is of the
    # fused class, so gather-class pairs prepare on one device.
    mode = resolve_neighbor_mode(src_down.capacity, tgt_down.capacity)
    src_dist = tgt_dist = False
    if mode == "fused":
        src_p, sf, src_dist = prepare_features_sharded(
            src_down, config, mesh, axis, halo)
        tgt_p, tf, tgt_dist = prepare_features_sharded(
            tgt_down, config, mesh, axis, halo)
    else:
        src_p, sf = prepare_features(src_down, config, mode)
        tgt_p, tf = prepare_features(tgt_down, config, mode)
    src_p, sf = pad_cloud_to_multiple(src_p, sf, n_shards)
    refined, coarse = register_prepared_sharded(
        src_p, tgt_p, sf, tf, config, mesh, axis, draws=draws)
    if return_info:
        return refined, coarse, {
            "mode": mode,
            "src_prepare_distributed": src_dist,
            "tgt_prepare_distributed": tgt_dist,
            "n_shards": n_shards,
        }
    return refined, coarse
