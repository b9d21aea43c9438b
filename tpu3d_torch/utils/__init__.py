"""Utilities: profiling helpers."""

from tpu3d_torch.utils.profiling import StageRecorder, annotate, trace

__all__ = ["StageRecorder", "annotate", "trace"]
