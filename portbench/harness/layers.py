"""The program's stages in a profiled slice: idle and device seconds by the
program's own spans (``tpu3d:`` ranges of ``tpu3d_torch.utils.profiling``).

* Idle: each idle piece of the slice is named by the innermost range open
  on the host over it, on any thread (``profile._idle_by_host``), the
  harness's ``pb:`` labels and the program's spans alike, so a label's
  idle is split among the program's stages inside it. The total is the
  slice's idle time whatever the ranges.
* Device: a device operation belongs to the innermost program span open
  on the thread that launched it, when it launched: its launching runtime
  call is the host event that shares its correlation id (a CUDA graph's
  replay launches its kernels, so they belong to the replay's span).
* A stage's layer is the part of its name before the first dot
  (``ransac.chunk`` → ``ransac``).

Busy time, launches and kernel time come from the device rows alone
(``profile.profiled_slice``); none of this changes them. The profiled
slice does not call these yet: it records only its own thread's ranges.
"""

from __future__ import annotations

import bisect

from portbench.harness.profile import _idle_by_host

PROGRAM = "tpu3d:"
HARNESS = "pb:"


def layer_of(stage: str) -> str:
    return stage.split(".", 1)[0]


def host_ranges(events, prefix: str) -> list:
    """(start, end, name without the prefix, thread) of the host ranges
    whose name starts with ``prefix``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.time_range.start, e.time_range.end, e.name[len(prefix):],
             e.thread)
            for e in events
            if e.device_type != cuda and e.name.startswith(prefix)]


def idle_by_stage(busy: list, t0: float, t1: float, ranges: list) -> dict:
    """Idle seconds of [t0, t1] outside ``busy`` by the innermost range
    (start, end, name, thread) open over them, else 'harness'."""
    return _idle_by_host(busy, t0, t1, [(s, e, n) for s, e, n, _ in ranges])


class _Innermost:
    """The innermost range open at a time on one thread: ranges nest on a
    thread, so it is the latest-starting one that still covers it."""

    def __init__(self, ranges: list):
        self.by_thread: dict = {}
        for r in sorted(ranges):
            self.by_thread.setdefault(r[3], []).append(r)
        self.starts = {t: [r[0] for r in rs]
                       for t, rs in self.by_thread.items()}

    def at(self, thread, t: float):
        rs = self.by_thread.get(thread, [])
        for j in range(bisect.bisect_right(self.starts.get(thread, []), t)
                       - 1, -1, -1):
            if rs[j][1] >= t:
                return rs[j][2]
        return None


def device_by_stage(device_ops: list, launches: dict, ranges: list) -> dict:
    """Device seconds by the program stage that launched each operation.
    ``device_ops``: (correlation id, start, end) of the device rows;
    ``launches``: correlation id → (thread, start) of the launching host
    call; an operation without either counts under 'outside'."""
    inner = _Innermost(ranges)
    out: dict[str, float] = {}
    for cid, s, e in device_ops:
        host = launches.get(cid)
        stage = inner.at(*host) if host is not None else None
        key = stage or "outside"
        out[key] = out.get(key, 0.0) + (e - s) * 1e-6
    return out


def by_layer(seconds: dict) -> dict:
    out: dict[str, float] = {}
    for stage, v in seconds.items():
        out[layer_of(stage)] = out.get(layer_of(stage), 0.0) + v
    return out


def read_events(events, t0: float, t1: float) -> dict:
    """From a profile's events inside [t0, t1]: the device rows (the
    harness's own filter), the launching host calls by correlation id,
    the program's ranges and the harness's labels."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith((HARNESS, PROGRAM))]
    ids = {e.id for e in dev}
    launches = {e.id: (e.thread, e.time_range.start) for e in events
                if e.device_type != cuda and e.id in ids
                and e.name.startswith("cu")}
    ops = [(e.id, max(e.time_range.start, t0), min(e.time_range.end, t1))
           for e in dev]
    return {"device_ops": [o for o in ops if o[2] > o[1]],
            "launches": launches,
            "program": host_ranges(events, PROGRAM),
            "labels": [r for r in host_ranges(events, HARNESS)
                       if r[2] != "slice"]}
