"""Reference-shaped API facade.

Counterpart of ``tpu3d/compat.py``: users of the reference know
``Registration``'s static surface (include/registration.hpp:32-60); this
module exposes the same names over the port's functions, so a port is a
one-line import change. The pythonic API in :mod:`tpu3d_torch` is the
primary surface; this is the compatibility skin. Clouds are made where
``PointCloud.from_numpy`` puts them (the card by default).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3d_torch.models.ply import load_ply
from tpu3d_torch.ops.fpfh import compute_fpfh
from tpu3d_torch.ops.icp import icp_refine
from tpu3d_torch.ops.normals import estimate_normals
from tpu3d_torch.ops.ransac import ransac_registration
from tpu3d_torch.ops.voxel import voxel_downsample
from tpu3d_torch.types import FPFHFeatures, PointCloud, RegistrationResult

__all__ = ["Registration", "PointCloud", "FPFHFeatures", "RegistrationResult"]


class Registration:
    """Static facade mirroring the reference class (registration.hpp:32-60)."""

    @staticmethod
    def voxelDownsample(cloud: PointCloud, voxel_size: float) -> PointCloud:
        return voxel_downsample(cloud, voxel_size)

    @staticmethod
    def estimateNormals(cloud: PointCloud, k: int = 30) -> PointCloud:
        return estimate_normals(cloud, k=k, method="exact")

    @staticmethod
    def computeFPFH(cloud: PointCloud, radius: float) -> FPFHFeatures:
        return compute_fpfh(cloud, float(np.float32(radius)), method="exact")

    @staticmethod
    def ransacRegistration(
        source: PointCloud,
        target: PointCloud,
        source_features: FPFHFeatures,
        target_features: FPFHFeatures,
        voxel_size: float,
        max_iterations: int = 100000,
        confidence: float = 0.999,
    ) -> RegistrationResult:
        return ransac_registration(
            source, target, source_features, target_features, voxel_size,
            max_iterations=max_iterations, confidence=confidence,
        )

    @staticmethod
    def icpRefine(
        source: PointCloud,
        target: PointCloud,
        initial_transform,
        distance_threshold: float,
        max_iterations: int = 200,
        point_to_plane: bool = True,
    ) -> RegistrationResult:
        T = torch.as_tensor(initial_transform, dtype=torch.float32,
                            device=source.points.device)
        return icp_refine(
            source, target, T, distance_threshold,
            max_iterations=max_iterations, point_to_plane=point_to_plane,
        )

    @staticmethod
    def loadReferenceModel(path: str, device: str = "cuda") -> PointCloud:
        pts, cols = load_ply(path)
        if len(pts) == 0:
            return PointCloud(
                points=torch.zeros((0, 3), dtype=torch.float32,
                                   device=device),
                mask=torch.zeros((0,), dtype=torch.bool, device=device),
            )
        return PointCloud.from_numpy(np.asarray(pts), colors=cols,
                                     device=device)
