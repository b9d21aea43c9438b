"""Core data types: fixed-capacity masked clouds as tensors.

Counterpart of ``tpu3d/types.py``. A cloud is ``points[N, 3]`` plus a
validity ``mask[N]``; padding rows are masked out. The capacity is a
power-of-two bucket so shapes repeat across frames.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class PointCloud(NamedTuple):
    """Fixed-capacity masked point cloud.

    Attributes:
      points:  f32[N, 3] — xyz; rows with ``mask == False`` are padding.
      mask:    bool[N]   — validity of each row.
      normals: f32[N, 3] or None.
      colors:  f32[N, 3] or None — RGB in [0, 1].
    """

    points: torch.Tensor
    mask: torch.Tensor
    normals: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def device(self) -> torch.device:
        return self.points.device

    def count(self) -> int:
        """Number of valid points (reads one scalar back to the host)."""
        return int(self.mask.sum())

    @staticmethod
    def from_numpy(
        points: np.ndarray,
        normals: Optional[np.ndarray] = None,
        colors: Optional[np.ndarray] = None,
        capacity: Optional[int] = None,
        device: torch.device | str = "cuda",
    ) -> "PointCloud":
        """Pack a dense (n, 3) array into a fixed-capacity cloud on
        ``device`` (the card unless the caller asks for the CPU);
        ``capacity`` defaults to the next multiple of 128, as in the JAX
        package."""
        points = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        n = points.shape[0]
        if capacity is None:
            capacity = max(128, -(-n // 128) * 128)
        if n > capacity:
            raise ValueError(f"{n} points exceed capacity {capacity}")

        def pad(a):
            if a is None:
                return None
            out = np.zeros((capacity, 3), dtype=np.float32)
            out[:n] = np.asarray(a, dtype=np.float32).reshape(-1, 3)
            return torch.from_numpy(out).to(device)

        mask = np.zeros((capacity,), dtype=bool)
        mask[:n] = True
        return PointCloud(
            points=pad(points),
            mask=torch.from_numpy(mask).to(device),
            normals=pad(normals),
            colors=pad(colors),
        )


class FPFHFeatures(NamedTuple):
    """33-bin FPFH descriptors, one row per point (padding rows are zero)."""

    descriptors: torch.Tensor  # f32[N, 33]
    mask: torch.Tensor  # bool[N]
    # K5's packed target operand (ops.nn.descriptor_targets) when these
    # are a registration target on the card: built once, used by every
    # RANSAC against them (ops.ransac.with_target_operand); else None.
    nn_operand: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.descriptors.shape[0]


class RegistrationResult(NamedTuple):
    """Result of a coarse or fine registration (identity / 0 / 0 default)."""

    transformation: torch.Tensor  # f32[4, 4]
    fitness: torch.Tensor  # f32 scalar — inlier/correspondence fraction
    rmse: torch.Tensor  # f32 scalar — inlier RMSE
