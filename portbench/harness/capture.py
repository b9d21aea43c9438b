"""Wrappers the harness installs around the program's stage functions.

The program is not changed: a wrapper replaces a module attribute (or an
object's method) for the length of a ``with`` block and restores it after.

* :class:`Capture` keeps, for the requests drawn for the check, each call
  with its arguments, its result and the call it ran inside (its parent):
  what the comparison judges. Other requests pass straight through.
* :class:`Spans` (traced run, measured part) records host-clock spans,
  synchronising the device at each boundary, as ``chip_smoke.RunProbe``
  does.
* :class:`Labels` (traced run, profiled slice) names the host's ranges in
  the profiler's trace (``record_function``), with no synchronisation.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time


class PatchPoint:
    """``owner.attr`` (a module, a class or an object). ``label`` names its
    span (None: the call is captured but not timed)."""

    def __init__(self, owner, attr: str, label: str | None = None):
        self.owner, self.attr, self.label = owner, attr, label


@contextlib.contextmanager
def patched(points, make_wrapper):
    """Replace each point's function by ``make_wrapper(point, fn)``."""
    saved = []
    try:
        for p in points:
            fn = getattr(p.owner, p.attr)
            in_dict = p.attr in getattr(p.owner, "__dict__", {})
            saved.append((p, fn, in_dict))
            setattr(p.owner, p.attr, make_wrapper(p, fn))
        yield
    finally:
        for p, fn, in_dict in reversed(saved):
            if in_dict:
                setattr(p.owner, p.attr, fn)
            else:  # a method the object took from its class
                delattr(p.owner, p.attr)


class Capture:
    """Calls of the drawn requests: ``records[request]`` is a list of
    {'id', 'name', 'args', 'kwargs', 'out', 'parent'} in call order."""

    def __init__(self):
        self.current = None  # the request being captured, or None
        self.records: dict[int, list] = {}
        self._ids = itertools.count()
        self._local = threading.local()

    def wrap(self, point, fn):
        label = point.attr

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            req = self.current
            if req is None:
                return fn(*args, **kwargs)
            stack = getattr(self._local, "stack", None)
            if stack is None:
                stack = self._local.stack = []
            rec = {"id": next(self._ids), "name": label, "args": args,
                   "kwargs": kwargs, "out": None,
                   "parent": stack[-1] if stack else None}
            self.records.setdefault(req, []).append(rec)
            stack.append(rec["id"])
            try:
                rec["out"] = fn(*args, **kwargs)
            finally:
                stack.pop()
            return rec["out"]
        return wrapped


class Spans:
    """Host-clock spans [(request, label, t0, t1)], device synchronised at
    both ends of each."""

    def __init__(self, sync):
        self.sync = sync
        self.current = None
        self.items: list = []
        self._lock = threading.Lock()

    def wrap(self, point, fn):
        label = point.label
        if label is None:
            return fn

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            req = self.current
            if req is None:
                return fn(*args, **kwargs)
            self.sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.sync()
                t1 = time.perf_counter()
                with self._lock:
                    self.items.append((req, label, t0, t1))
        return wrapped


class Labels:
    """``record_function`` ranges named ``pb:<label>``."""

    def wrap(self, point, fn):
        import torch

        if point.label is None:
            return fn
        name = "pb:" + point.label

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapped
