"""High-level registration API: ``register_pair(source, target, config)``.

Counterpart of ``tpu3d/registration.py`` on its reference-parity route:
voxel downsample → capacity bucket → brute self-kNN (k=100) shared by
k=30 normals and radius-capped FPFH → RANSAC (K5 correspondences, K6
scoring) → point-to-plane ICP (K7, or K5 below 4,096 target rows). The
route holds for pairs whose downsampled clouds stay below
``FUSED_CAPACITY_THRESHOLD``; the routes not ported yet raise
``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpu3d_torch.config import RegistrationConfig
from tpu3d_torch.ops.fpfh import compute_fpfh
from tpu3d_torch.ops.icp import icp_refine
from tpu3d_torch.ops.neighbors import knn
from tpu3d_torch.ops.normals import estimate_normals
from tpu3d_torch.ops.ransac import Draws, ransac_registration
from tpu3d_torch.ops.voxel import compact, voxel_downsample
from tpu3d_torch.types import FPFHFeatures, PointCloud, RegistrationResult

FUSED_CAPACITY_THRESHOLD = 16384


def bucket_capacity(count: int, minimum: int = 256) -> int:
    """Next power-of-two bucket ≥ count (≥ minimum)."""
    cap = minimum
    while cap < count:
        cap *= 2
    return cap


def resolve_neighbor_mode(*capacities: int) -> str:
    """One descriptor route for both clouds of a pair: 'fused' when any is
    at scale, else 'auto' (the gather route)."""
    return "fused" if max(capacities) >= FUSED_CAPACITY_THRESHOLD else "auto"


def downsample_bucketed(
    cloud: PointCloud,
    config: RegistrationConfig,
    capacity: Optional[int] = None,
) -> PointCloud:
    """Voxel downsample, then compact to a power-of-two capacity bucket
    (truncating loudly when an explicit ``capacity`` is too small)."""
    down = voxel_downsample(cloud, config.voxel_size)
    count = down.count()  # host sync at the stage boundary
    if capacity is None:
        capacity = bucket_capacity(max(count, 1))
    elif count > capacity:
        print(
            f"tpu3d_torch: cloud has {count} voxels but capacity={capacity} "
            "— truncating"
        )
    return compact(down, capacity)


def surface_neighbors(cloud: PointCloud, k: int = 100):
    """One exact self-kNN (idx, d2) shared by normals (first 30 columns)
    and FPFH (all k, radius-gated): the reference's brute findKNN."""
    return knn(cloud.points, cloud.points, cloud.mask, k=k)


def prepare_features(
    down: PointCloud,
    config: RegistrationConfig,
    neighbor_mode: str = "auto",
) -> tuple[PointCloud, FPFHFeatures]:
    """Normals + FPFH on a downsampled, compacted cloud (gather route)."""
    if neighbor_mode == "fused" or (
        neighbor_mode == "auto" and down.capacity >= FUSED_CAPACITY_THRESHOLD
    ):
        raise NotImplementedError(
            "the fused prepare route (capacity >= "
            f"{FUSED_CAPACITY_THRESHOLD}, kernels K2-K4) is not ported yet "
            "(ROADMAP.md queue 1, item 4: fused prepare)"
        )
    if neighbor_mode != "auto":
        raise NotImplementedError(
            f"neighbor_mode={neighbor_mode!r} is not ported yet "
            "(ROADMAP.md queue 1, item 10: gather path for small clouds)"
        )
    radius = float(np.float32(config.voxel_size * 5.0))
    nbrs = surface_neighbors(down, k=100)
    down = estimate_normals(down, nbrs, k=30)
    return down, compute_fpfh(down, radius, nbrs)


def register_prepared(
    source: PointCloud,
    target: PointCloud,
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    config: RegistrationConfig,
    draws: Draws | None = None,
) -> tuple[RegistrationResult, RegistrationResult]:
    """RANSAC + ICP on prepared clouds. Returns (refined, coarse).
    ``draws`` replaces the RANSAC draw stream (see ops/ransac.py)."""
    two_stage = {"on": True, "off": False}.get(config.two_stage, "auto")
    coarse = ransac_registration(
        source,
        target,
        source_features,
        target_features,
        config.voxel_size,
        max_iterations=config.ransac_max_iterations,
        confidence=config.ransac_confidence,
        seed=config.ransac_seed,
        corr_mode=config.corr_mode,
        two_stage=two_stage,
        draws=draws,
    )
    refined = icp_refine(
        source,
        target,
        coarse.transformation,
        config.voxel_size * config.icp_distance_factor,
        max_iterations=config.icp_max_iterations,
        point_to_plane=config.use_point_to_plane,
        src_mode=config.src_mode,
    )
    return refined, coarse


def register_pair(
    source: PointCloud,
    target: PointCloud,
    config: Optional[RegistrationConfig] = None,
    mesh=None,
    draws: Draws | None = None,
) -> tuple[RegistrationResult, RegistrationResult]:
    """Full registration of two raw clouds → (refined, coarse), each a
    4×4 pose with fitness and rmse. The clouds' device decides where it
    runs: CUDA tensors launch the port's kernels."""
    if config is None:
        config = RegistrationConfig()
    if mesh is not None:
        raise NotImplementedError(
            "multi-device registration (mesh) is not ported yet "
            "(ROADMAP.md queue 1, item 16: multi-GPU)"
        )
    if config.prepare_mode == "sparse":
        raise NotImplementedError(
            "prepare_mode='sparse' is not ported yet "
            "(ROADMAP.md queue 1, item 4: fused prepare, sparse arm)"
        )
    src_down = downsample_bucketed(source, config)
    tgt_down = downsample_bucketed(target, config)
    mode = resolve_neighbor_mode(src_down.capacity, tgt_down.capacity)
    src_down, src_feat = prepare_features(src_down, config, mode)
    tgt_down, tgt_feat = prepare_features(tgt_down, config, mode)
    return register_prepared(src_down, tgt_down, src_feat, tgt_feat, config,
                             draws=draws)
