"""Pinhole back-projection (depth frame → masked point cloud).

Counterpart of ``tpu3d/ops/deproject.py``: row r of the cloud is pixel
(r // W, r % W), always; a row is valid where 0 < z ≤ ``clipping_max``
(inclusive); colours are BGR → RGB · (1/255). The result is bit-deterministic
and needs no compaction.
"""

from __future__ import annotations

import torch

from tpu3d_torch.types import PointCloud


def deproject(
    depth_m: torch.Tensor,
    rgb_bgr: torch.Tensor | None,
    intrinsics: torch.Tensor,
    clipping_max: float,
) -> PointCloud:
    """Back-project an f32[H, W] depth map in metres (0 = invalid) with the
    f32[3, 3] pinhole ``intrinsics``; ``rgb_bgr`` is u8[H, W, 3] or None.
    Returns a cloud of capacity H·W in row-major pixel order."""
    h, w = depth_m.shape
    dev = depth_m.device
    K = intrinsics.to(device=dev, dtype=torch.float32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    z = depth_m.to(torch.float32)
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    clip = torch.tensor(clipping_max, dtype=torch.float32, device=dev)
    mask = ((z > 0.0) & (z <= clip)).reshape(-1)
    colors = None
    if rgb_bgr is not None:
        # Times the fp32 reciprocal, as XLA rewrites the JAX division.
        colors = (rgb_bgr.flip(-1).to(torch.float32) * (1.0 / 255.0)
                  ).reshape(-1, 3)
    return PointCloud(points=pts, mask=mask, colors=colors)
