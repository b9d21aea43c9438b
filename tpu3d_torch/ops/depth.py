"""Depth-frame preprocessing: scale + mask, and the bilateral filter (K9).

Counterpart of ``tpu3d/ops/depth.py``. ``depth_preprocess`` turns u16 depth
into fp32 metres, zeroed where the instance mask is ≤ 10 (the CPU
reference's binarisation). ``bilateral_filter`` smooths the frame with
Gaussian spatial × range weights over a (2r+1)² window, r = min(int(2σs +
0.5), 5), skipping zero-depth neighbours and keeping zero-depth centres at
0. A CUDA tensor launches the hand-written kernel of ``csrc/depth.cu``
(K9); a CPU tensor takes the plain version, the same unrolled shifted-slice
loop as the JAX package's ``_bilateral_math``.
"""

from __future__ import annotations

import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel, on_device

_BF_MAX_RADIUS = 5


def depth_preprocess(
    depth_raw: torch.Tensor,
    mask: torch.Tensor | None,
    scale_to_meters: float,
    apply_mask: bool = True,
) -> torch.Tensor:
    """u16 depth → f32 metres, zeroed where ``mask`` ≤ 10."""
    d = depth_raw.to(torch.float32) / torch.tensor(
        scale_to_meters, dtype=torch.float32, device=depth_raw.device)
    if apply_mask and mask is not None:
        d = torch.where(mask > 10, d, 0.0)
    return d


def bf_radius(sigma_spatial: float) -> int:
    return min(int(2.0 * sigma_spatial + 0.5), _BF_MAX_RADIUS)


def _weights(sigma_spatial: float, sigma_range: float):
    # Python floats, as the reference computes them: the spatial term of a
    # tap is (dx² + dy²) · inv_s2 in double, rounded to fp32 when it meets
    # the frame.
    return (-0.5 / (sigma_spatial * sigma_spatial),
            -0.5 / (sigma_range * sigma_range))


def bilateral_filter_plain(
    depth: torch.Tensor, sigma_spatial: float = 2.0, sigma_range: float = 0.05
) -> torch.Tensor:
    """The window loop in plain PyTorch: dy outer, dx inner, one rounding
    per operation."""
    h, w = depth.shape
    r = bf_radius(sigma_spatial)
    inv_s2, inv_r2 = _weights(sigma_spatial, sigma_range)
    padded = torch.nn.functional.pad(depth.to(torch.float32), (r, r, r, r))
    center = padded[r:r + h, r:r + w]
    sum_w = torch.zeros((h, w), dtype=torch.float32, device=depth.device)
    sum_v = torch.zeros_like(sum_w)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb = padded[r + dy:r + dy + h, r + dx:r + dx + w]
            rd = nb - center
            wgt = torch.exp((dx * dx + dy * dy) * inv_s2 + rd * rd * inv_r2)
            wgt = torch.where(nb > 0.0, wgt, 0.0)
            sum_w = sum_w + wgt
            sum_v = sum_v + wgt * nb
    out = torch.where(sum_w > 0.0, sum_v / torch.clamp_min(sum_w, 1e-30),
                      center)
    return torch.where(center > 0.0, out, 0.0)


def bilateral_filter(
    depth: torch.Tensor, sigma_spatial: float = 2.0, sigma_range: float = 0.05
) -> torch.Tensor:
    """Edge-preserving smoothing of an f32[H, W] depth frame in metres.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if depth.ndim != 2:
        raise ValueError("depth must be (H, W)")
    if not launches_kernel(depth):
        return bilateral_filter_plain(depth, sigma_spatial, sigma_range)
    if depth.dtype != torch.float32:
        raise TypeError("bilateral_filter kernel takes a float32 frame")
    h, w = depth.shape
    inv_s2, inv_r2 = _weights(sigma_spatial, sigma_range)
    src = depth.contiguous()
    out = torch.empty_like(src)
    with on_device(src.device):
        rc = build.library().tpu3d_bilateral_filter(
            src.data_ptr(), out.data_ptr(), h, w, bf_radius(sigma_spatial),
            inv_s2, inv_r2, torch.cuda.current_stream(src.device).cuda_stream,
        )
    build.check(rc, "tpu3d_bilateral_filter")
    build.count_launch(bilateral_filter)
    return out


bilateral_filter.launches = 0
