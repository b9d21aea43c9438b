"""Structured tracing and profiling.

Counterpart of ``tpu3d/utils/profiling.py`` on ``torch.profiler``, and the
port's own tracer:

  - ``trace(logdir)``: a context manager that profiles the enclosed block
    (host and, where there is a card, device activity) and writes a Chrome
    trace into ``logdir`` (viewable in Perfetto or ``chrome://tracing``),
    with the block's counts beside it in ``counters.json``;
  - ``annotate(name)``: a named host range on the trace timeline
    (``torch.profiler.record_function``);
  - ``span(name)``: a stage of the program, the host range
    ``tpu3d:<name>`` (``@spanned(name)`` for a whole function's call);
    ``count(name, k)`` and ``counters()``: the program's
    counters; ``host_read(site, tensor)``: a blocking device→host read,
    spanned and counted; ``handoff(fn)``: ``fn`` for a pool thread, inside
    the spans open where it was handed off;
  - ``StageRecorder``: wall-clock per-stage records with JSON export, the
    structured replacement for the reference's stdout timings.

Tracing is on exactly while a ``torch.profiler`` profile runs (``trace``,
or a caller's own profile): it adds no flag or setting. A span's range is
the profiler's own, so it shares the clock of the device rows. Each call of
``register_pair`` and of ``Pipeline.run()`` opens a root span, and each root
span is one request: its spans carry its number (``trace`` writes it into
each range's ``args`` as ``request``, beside ``parent``, the name of the
enclosing span on its thread, else of the span open where the work was
handed off). With tracing off, ``span(name)`` is one test of the
profiler's module-level flag and returns the shared null context ``OFF``;
``@spanned(name)`` tests it and calls the function. Where a loop runs a
span each pass (ICP's iterations), the site reads the flag once before the
loop and builds nothing when it is off::

    with Span("icp.iteration") if on else OFF:

Counters are added only while tracing is on, once where their work ends;
the kernel wrappers' launch counts (``build.count_launch``) count always
and ``counters()`` reports them as ``launches.<kernel>``.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import json
import os
import threading
import time
from typing import Optional

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.autograd import profiler
from torch.profiler import ProfilerActivity, profile, record_function

from tpu3d_torch import build

PREFIX = "tpu3d:"
OFF = contextlib.nullcontext()

# The spans open in this context, innermost last: ((name, request), ...).
# A context is a thread's own unless ``handoff`` ran the work in a copy.
_open: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "tpu3d_spans", default=())
_requests = itertools.count(1)
_lock = threading.Lock()
_counts: dict[str, int] = {}
# While ``trace`` runs: (native thread id, name, request, parent) of each
# span opened, in order, to label the ranges of the trace it writes.
_log: Optional[list] = None


class Span:
    """The program's stage ``name`` as the range ``tpu3d:<name>``. A
    ``root`` span starts a new request; any other carries the request of
    the enclosing span (0 outside every request)."""

    __slots__ = ("name", "root", "_range", "_token")

    def __init__(self, name: str, root: bool = False):
        self.name, self.root = name, root

    def __enter__(self):
        stack = _open.get()
        parent = stack[-1] if stack else (None, 0)
        request = next(_requests) if self.root else parent[1]
        log = _log
        if log is not None:
            log.append((threading.get_native_id(), self.name, request,
                        parent[0]))
        self._token = _open.set(stack + ((self.name, request),))
        self._range = record_function(PREFIX + self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        _open.reset(self._token)
        return False


def span(name: str, root: bool = False):
    """The span ``name`` while tracing is on, else ``OFF``."""
    if not profiler._is_profiler_enabled:
        return OFF
    return Span(name, root)


def spanned(name: str, root: bool = False):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with Span(name, root):
                return fn(*args, **kwargs)
        return call
    return wrap


def _add(*names: str, k: int = 1) -> None:
    with _lock:
        for name in names:
            _counts[name] = _counts.get(name, 0) + k


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` while tracing is on."""
    if profiler._is_profiler_enabled:
        _add(name, k=k)


def counters() -> dict:
    """A snapshot of every counter, the launch counts included."""
    with _lock:
        out = dict(_counts)
    for wrapper in build.counted():
        out["launches." + wrapper.__name__] = wrapper.launches
    return out


def host_read(site: str, tensor, read=torch.Tensor.cpu):
    """``read(tensor)``: a blocking device→host read, the one the caller
    makes (``float``, ``int``, ``bool``, ``torch.Tensor.cpu``, ...). With
    tracing on it runs inside the span ``<layer>.read.<what>`` for ``site``
    ``<layer>.<what>`` and counts ``host.reads`` and
    ``host.reads.<site>``."""
    if not profiler._is_profiler_enabled:
        return read(tensor)
    layer, _, what = site.partition(".")
    _add("host.reads", "host.reads." + site)
    with Span(f"{layer}.read.{what}"):
        return read(tensor)


def handoff(fn):
    """``fn`` to run on other threads (a pool's): with tracing on, each call
    runs in its own copy of this context, so its spans carry this request
    and have the span open here as parent."""
    if not profiler._is_profiler_enabled:
        return fn
    context = contextvars.copy_context()

    def run(*args, **kwargs):
        return context.copy().run(fn, *args, **kwargs)
    return run


def _label_spans(path: str, log: list) -> None:
    """Write each span's request and parent into the ``args`` of its range
    in the Chrome trace at ``path``: a thread's ranges in the order they
    opened are its entries of ``log``."""
    with open(path) as f:
        doc = json.load(f)
    ranges: dict = {}
    for e in doc.get("traceEvents", []):
        if (e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith(PREFIX)):
            ranges.setdefault(e.get("tid"), []).append(e)
    opened: dict = {}
    for tid, name, request, parent in log:
        opened.setdefault(tid, []).append((name, request, parent))
    for tid, events in ranges.items():
        events.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))
        entries = opened.get(tid, [])
        if [e["name"] for e in events] != [PREFIX + n for n, _, _ in entries]:
            continue  # not this trace's spans, or some opened outside it
        for e, (_, request, parent) in zip(events, entries):
            e.setdefault("args", {}).update(request=request, parent=parent)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; on exit write ``trace.json`` (a Chrome
    trace, the program's spans labelled with their request) and
    ``counters.json`` (each counter's change over the block, where it
    changed) into ``logdir``, created if missing. Yields the profiler."""
    global _log
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    before = counters()
    log: list = []
    _log = log
    try:
        # Every thread's ranges: the pipeline's prepare pool's too.
        with profile(activities=activities,
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        _log = None
    after = counters()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _label_spans(path, log)
    deltas = {k: v - before.get(k, 0) for k, v in sorted(after.items())
              if v != before.get(k, 0)}
    with open(os.path.join(logdir, "counters.json"), "w") as f:
        json.dump(deltas, f, indent=1)


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
