"""Carry state across frameworks: the port's tensors ↔ numpy arrays.

The system has no weights; its state is the clouds, their descriptors,
the registration results and the search indexes (``GridIndex``,
``SlabIndex``). Each is a NamedTuple whose fields are arrays or None, so
one pair of functions moves any of them, field by field, between numpy
(what the JAX package and files exchange) and tensors on a device. A
field the port's type lacks (the JAX ``SlabIndex.sorted_points``) is
left behind.
"""

from __future__ import annotations

from typing import NamedTuple, TypeVar

import numpy as np
import torch

from tpu3d_torch.ops.grid import GridIndex
from tpu3d_torch.ops.slab import SlabIndex
from tpu3d_torch.types import FPFHFeatures, PointCloud, RegistrationResult

T = TypeVar("T", PointCloud, FPFHFeatures, RegistrationResult, GridIndex,
            SlabIndex)


def to_numpy(state: NamedTuple) -> dict:
    """Fields of ``state`` as numpy arrays (None stays None)."""
    return {
        k: None if v is None else v.detach().cpu().numpy()
        for k, v in state._asdict().items()
    }


def from_numpy(
    cls: type[T], arrays: dict, device: torch.device | str = "cuda"
) -> T:
    """Build ``cls`` from a dict (or NamedTuple) of numpy-like arrays,
    placing every field on ``device`` (the card unless the caller asks for
    the CPU). Fields missing from ``arrays`` keep the type's default."""
    if hasattr(arrays, "_asdict"):
        arrays = arrays._asdict()
    fields = {}
    for k in cls._fields:
        if k not in arrays:
            continue
        v = arrays[k]
        fields[k] = (
            None
            if v is None
            else torch.from_numpy(np.array(v, copy=True)).to(device)
        )
    return cls(**fields)
