"""The traced run's profiled slice: a fixed count of requests under
``torch.profiler``, read from the device's own rows.

What it yields (:class:`Slice`): the slice's wall time, the union of the
intervals in which a device operation ran (busy), the kernels launched,
device seconds by kernel, the work of K5 and K6 counted from the shapes
their wrappers saw, the device operations that took most time, and the
idle gaps by the host range (a :class:`capture.Labels` name) the host was
in when each began. No trace is written to disk.
"""

from __future__ import annotations

import dataclasses
import functools

from portbench.harness import roofline
from portbench.harness.capture import Labels, PatchPoint, patched


@dataclasses.dataclass
class Slice:
    requests: int
    window_s: float
    busy_s: float
    launches: int
    kernel_s: dict  # kernel → device seconds
    least_s: dict  # kernel → Σ least seconds of its counted launches
    device_ops: list  # [[name, seconds]] top 10
    idle_gaps: list  # [[host range, seconds]] top 10


class Work:
    """Shapes of the K5 and K6 calls the slice makes. Counts of valid rows
    are read after the slice from the tensors kept here, so the wrappers
    never wait for the device."""

    def __init__(self):
        self.k5: list = []  # (src mask, tgt mask, d)
        self.k6: list = []  # (h, pq_norm or a valid-count tensor)

    def points(self, ransac):
        out = []
        if hasattr(ransac, "feature_correspondences"):
            out.append(PatchPoint(ransac, "feature_correspondences", "k5"))
        if hasattr(ransac, "score_hypotheses"):
            out.append(PatchPoint(ransac, "score_hypotheses", "k6"))
        body = getattr(ransac, "_ChunkBody", None)
        if body is not None and hasattr(body, "replay"):
            out.append(PatchPoint(body, "replay", "k6_replay"))
        return out

    def wrap(self, point, fn):
        import torch

        label = point.label
        if label == "k5":
            @functools.wraps(fn)
            def k5(src, tgt, *a, **k):
                self.k5.append((src.mask, tgt.mask, src.descriptors.shape[1]))
                return fn(src, tgt, *a, **k)
            return k5
        if label == "k6":
            @functools.wraps(fn)
            def k6(feat_t, pq_norm, w16t, *a, **k):
                if not (pq_norm.is_cuda
                        and torch.cuda.is_current_stream_capturing()):
                    self.k6.append((w16t.shape[1], pq_norm < 1e29))
                return fn(feat_t, pq_norm, w16t, *a, **k)
            return k6

        @functools.wraps(fn)
        def replay(body, params):
            captured = body.graph is not None
            out = fn(body, params)
            if captured:  # the replay's launches; a capture counts its own
                nv = body.inputs["n_valid"].clone()
                if body.use_est:
                    self.k6.append((body.h, nv[0]))
                    self.k6.append((body.k_fin, nv[1]))
                else:
                    self.k6.append((body.h, nv[1]))
            return out
        return replay

    def least(self) -> dict:
        """kernel → Σ over counted launches of the least seconds."""
        out = {}
        if self.k5:
            out["k5"] = sum(roofline.least_seconds(*roofline.k5_work(
                int(s.sum()), int(t.sum()), d)) for s, t, d in self.k5)
        if self.k6:
            # A mask of valid rows (eager calls) or a valid count (replays).
            out["k6"] = sum(roofline.least_seconds(*roofline.k6_work(
                h, int(round(float(v.sum())))))
                for h, v in self.k6)
        return out


def _short(name: str) -> str:
    """A kernel's name without its arguments, at most 96 characters."""
    return name.replace("(anonymous namespace)::", "").split("(")[0][:96]


def _merge(intervals) -> list:
    """Sorted, disjoint [start, end] covering the intervals."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _idle_by_host(busy: list, t0: float, t1: float, ranges: list) -> dict:
    """Seconds of [t0, t1] outside ``busy`` (merged, sorted), each piece
    named by the shortest host range (start, end, name) over it, else
    'harness': one sweep over the range and busy boundaries."""
    points = sorted({t0, t1} | {t for s, e in busy for t in (s, e)}
                    | {t for s, e, _ in ranges for t in (s, e)})
    points = [t for t in points if t0 <= t <= t1]
    starts = sorted(ranges)
    active: list = []
    out: dict[str, float] = {}
    bi, ri = 0, 0
    for a, b in zip(points, points[1:]):
        while ri < len(starts) and starts[ri][0] <= a:
            active.append(starts[ri])
            ri += 1
        active = [r for r in active if r[1] > a]
        while bi < len(busy) and busy[bi][1] <= a:
            bi += 1
        if bi < len(busy) and busy[bi][0] <= a:
            continue  # the device is busy on [a, b]
        name = min(active, key=lambda r: r[1] - r[0])[2] if active \
            else "harness"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out


def profiled_slice(run_request, n: int, label_points, ransac, sync) -> Slice:
    """Run ``run_request(k)`` for k < n under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    work = Work()
    with patched(label_points, Labels().wrap), \
            patched(work.points(ransac), work.wrap):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("pb:slice"):
                for k in range(n):
                    run_request(k)
                sync()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # The device's own rows: kernels, copies, sets (a record_function range
    # also shows on the device's timeline as a user annotation).
    dev = [e for e in events if e.device_type == cuda
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith("pb:")]
    host = [e for e in events if e.device_type != cuda
            and e.name.startswith("pb:")]
    (sl,) = [e for e in host if e.name == "pb:slice"]
    t0, t1 = sl.time_range.start, sl.time_range.end
    iv = [(max(e.time_range.start, t0), min(e.time_range.end, t1))
          for e in dev]
    merged = _merge((s, e) for s, e in iv if e > s)
    busy_us = sum(e - s for s, e in merged)
    kernels = [e for e in dev
               if not e.name.startswith(("Memcpy", "Memset"))]
    by_name: dict[str, float] = {}
    for e in dev:
        k = _short(e.name)
        by_name[k] = by_name.get(k, 0.0) + (e.time_range.end
                                            - e.time_range.start) * 1e-6
    kernel_s = {}
    for key, names in roofline.KERNELS.items():
        s = sum((e.time_range.end - e.time_range.start) * 1e-6
                for e in kernels if any(n_ in e.name for n_ in names))
        if s > 0:
            kernel_s[key] = s
    # Idle time by the innermost host range open during it (any thread's).
    ranges = [(e.time_range.start, e.time_range.end, e.name[3:])
              for e in host if e.name != "pb:slice"]
    gaps = _idle_by_host(merged, t0, t1, ranges)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Slice(
        requests=n, window_s=(t1 - t0) * 1e-6, busy_s=busy_us * 1e-6,
        launches=len(kernels), kernel_s=kernel_s, least_s=work.least(),
        device_ops=[[k, v] for k, v in top],
        idle_gaps=[[k, v] for k, v in idle],
    )
