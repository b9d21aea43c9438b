"""Where a kernel runs: replaces ``tpu3d/utils/platform.on_tpu``.

The decision is made from the tensor a wrapper is given, never from what
the machine has: a CUDA tensor launches the hand-written kernel, a CPU
tensor takes the kernel's plain PyTorch version, anything else raises.
"""

from __future__ import annotations

import contextlib
import functools

import torch


def launches_kernel(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every
    tensor lies on the CPU; raises for a mix or another device type."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("tensors lie on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"unsupported device mix {sorted(kinds)}")


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else nothing. Every
    kernel wrapper launches under it: a C entry point launches on the host
    thread's current device, which must be the one its tensors and stream
    lie on (a mesh's shards lie on several)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of the CUDA ``device`` (the launch plans size grids by
    it)."""
    return _sm_count_of(torch.cuda.current_device() if device.index is None
                        else device.index)
