"""Structured tracing and profiling.

Counterpart of ``tpu3d/utils/profiling.py`` on ``torch.profiler``:

  - ``trace(logdir)``: a context manager that profiles the enclosed block
    (host and, where there is a card, device activity) and writes a Chrome
    trace into ``logdir`` (viewable in Perfetto or ``chrome://tracing``);
  - ``annotate(name)``: a named host range on the trace timeline
    (``torch.profiler.record_function``);
  - ``StageRecorder``: wall-clock per-stage records with JSON export, the
    structured replacement for the reference's stdout timings.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; on exit write ``trace.json`` (a Chrome
    trace) into ``logdir``, created if missing. Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named host range appearing on the trace timeline."""
    return record_function(name)


class StageRecorder:
    """Per-stage wall-clock records (ms), exportable as JSON."""

    def __init__(self):
        self.records: list[dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append(
                {
                    "stage": name,
                    "ms": (time.perf_counter() - t0) * 1000.0,
                    **meta,
                }
            )

    def summary(self) -> dict:
        return {r["stage"]: r["ms"] for r in self.records}

    def dump(self, path: Optional[str] = None) -> str:
        payload = json.dumps(self.records, indent=2)
        if path:
            with open(path, "w") as f:
                f.write(payload)
        return payload

    def report(self):
        for r in self.records:
            print(f"  {r['stage']}: {r['ms']:.1f} ms")
