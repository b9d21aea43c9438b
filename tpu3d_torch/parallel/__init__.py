"""Multi-instance registration: the instance batch on one device."""

from tpu3d_torch.parallel.batched import register_batch, stack_clouds

__all__ = ["register_batch", "stack_clouds"]
