"""tpu3d_torch — the PyTorch/CUDA port of :mod:`tpu3d` for NVIDIA Hopper.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find: ``register_pair`` here, the bin-picking
pipeline in ``pipeline/`` and its CLI, ``python -m tpu3d_torch
[config.yaml]``. Plain tensor code is PyTorch; the hot kernels (the fused
prepare sweeps, top-1 nearest neighbour, RANSAC hypothesis scoring, ICP
point-to-plane statistics, the depth bilateral filter) are hand-written
CUDA C++ under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use.
A tensor on the CPU takes each kernel's plain PyTorch version instead.

This package imports neither ``jax`` nor ``tpu3d``.
"""

import torch as _torch

# Geometry runs in true fp32, as the JAX package pins it: matmul-based
# distances, covariances and normal equations lose radius/threshold
# decisions under TF32's 10-bit mantissa.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from tpu3d_torch.config import (  # noqa: E402
    PipelineConfig,
    RegistrationConfig,
    load_config,
)
from tpu3d_torch.registration import (  # noqa: E402
    bucket_capacity,
    prepare_cloud,
    register_pair,
    register_pair_multiscale,
    register_prepared,
)
from tpu3d_torch.types import (  # noqa: E402
    FPFHFeatures,
    PointCloud,
    RegistrationResult,
)

__version__ = "0.1.0"

__all__ = [
    "FPFHFeatures",
    "PipelineConfig",
    "PointCloud",
    "RegistrationConfig",
    "RegistrationResult",
    "bucket_capacity",
    "load_config",
    "prepare_cloud",
    "register_pair",
    "register_pair_multiscale",
    "register_prepared",
    "__version__",
]
