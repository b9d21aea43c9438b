"""Utilities: synchronised timing, profiling helpers."""

from tpu3d_torch.utils.profiling import StageRecorder, annotate, trace
from tpu3d_torch.utils.timing import StageTimer, device_timeit, roundtrip_ms

__all__ = ["StageRecorder", "StageTimer", "annotate", "device_timeit",
           "roundtrip_ms", "trace"]
