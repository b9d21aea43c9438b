"""One run of one cell: set-up, the measured window, the check, the result.

* Set-up: the cell's traffic from the seed, the driver's state (inputs on
  the device or in files), and one request of every pool item, which
  builds the kernels (from the checkout's cache after the first run),
  captures the RANSAC graphs and warms every capacity bucket the traffic
  uses. ``setup_s`` runs from the process's start to the end of this.
* Window: one caller, closed loop: the next request goes out when the
  last has returned, pool items in turn, for ``seconds`` (and at least
  as many requests as the check samples). ``request_ms`` is the
  window over the requests completed in it, ``request_p90_ms`` the 90th
  percentile of their latencies.
* Traced run (``trace``): first a profiled slice of the cell's
  ``profiled_requests`` requests (``profile.py``), then the window with a
  span at each stage boundary; it reports the per-layer metrics.
* Check: the cell's ``checked_requests`` requests are a uniform sample,
  drawn from the seed, of all the window's requests (a reservoir: only
  the sampled ones are kept while the window runs). After the window,
  with the peak memory read, their captured calls are judged
  (``reference/judge.py``); with the share of all requests whose pose
  misses the known truth (``gate_miss``) each number is held to the
  limit of ``workloads/<cell>.json``.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np

from portbench.harness import spec as specs
from portbench.harness.capture import Capture, Spans, patched
from portbench.harness.profile import profiled_slice
from portbench.reference.judge import Judge

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu3d", "bench", "benchmarks")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden (compared whole:
    ``tpu3d_torch`` is the program, ``tpu3d`` is not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(xs, q: float) -> float:
    """Linear interpolation between closest ranks (numpy's default)."""
    s = sorted(xs)
    pos = (len(s) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def judge_records(records: dict, drv, pool: int, min_fitness: float,
                  candidate=None):
    """(worst of each number, {request: its numbers}, worst of each
    recorded quantile) over the captured requests; ``candidate``: judge
    the reference at that precision in the program's place (the
    control)."""
    worst: dict[str, float] = {}
    diag: dict[str, float] = {}
    per_request = {}
    for req in sorted(records):
        judge = Judge(min_fitness, candidate)
        judge.request(records[req], drv.frame_inputs(req % pool))
        per_request[req] = judge.worst
        for acc, got in ((worst, judge.worst), (diag, judge.diag)):
            for name, v in got.items():
                acc[name] = max(acc.get(name, 0.0), v)
    return worst, per_request, diag


class Reservoir:
    """A uniform sample of ``size`` of the requests seen so far, drawn from
    ``rng`` (Algorithm R): ``offer(k)`` says whether request ``k`` joins
    it, and which request it pushes out (or None)."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.kept = size, rng, []

    def offer(self, k: int):
        if len(self.kept) < self.size:
            self.kept.append(k)
            return True, None
        j = int(self.rng.integers(0, k + 1))
        if j >= self.size:
            return False, None
        out, self.kept[j] = self.kept[j], k
        return True, out


def log(msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def run(cell: specs.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda") -> dict:
    """The result line's object of one run (see run.py)."""
    import torch

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    seed = int(seed) % (1 << 63)
    items = cell.generator().generate(cell.traffic, cell.config, seed)
    drv = cell.driver().Driver(cell.config, items, device)
    pool = drv.pool
    for i in range(pool):  # warm-up: every pool item once
        drv.request(i)
    sync()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s, pool {pool}")

    wl = cell.workload
    sample = Reservoir(int(wl["checked_requests"]),
                       np.random.default_rng([seed, 0xc4ec]))
    capture, spans = Capture(), Spans(sync)
    points = drv.patch_points()
    sliced = None
    if trace:
        from tpu3d_torch.ops import ransac

        sliced = profiled_slice(lambda k: drv.request(k % pool),
                                int(wl["profiled_requests"]), points,
                                ransac, sync)
    lat, outcomes = [], []
    with patched(points, capture.wrap), (
            patched(points, spans.wrap) if trace
            else contextlib.nullcontext()):
        k = 0
        t_w0 = time.perf_counter()
        while True:
            keep, out = sample.offer(k)
            capture.records.pop(out, None)
            capture.current = k if keep else None
            spans.current = k if trace else None
            t0 = time.perf_counter()
            outcomes.append(drv.request(k % pool))
            sync()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            k += 1
            if t1 - t_w0 >= seconds and k >= sample.size:
                break
        capture.current = spans.current = None
    window_s = t1 - t_w0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"window {window_s:.3f} s, {k} requests; latency ms min "
        f"{min(lat) * 1e3:.2f} median {percentile(lat, 50) * 1e3:.2f} max "
        f"{max(lat) * 1e3:.2f}")

    # The check, request by request.
    limits = wl["limits"]
    worst, per_request, _ = judge_records(
        capture.records, drv, pool, cell.config["registration"]["min_fitness"])
    rejected = {req for req, nums in per_request.items()
                if any(not v <= limits.get(n, math.inf)
                       for n, v in nums.items())}
    drv.close()
    worst["gate_miss"] = sum(o["gate_miss"] for o in outcomes) / k
    gates = np.array([o["gate"] for o in outcomes])
    log(f"gate: worst rotation {gates[:, 0].max():.6g} rad, translation "
        f"{gates[:, 1].max():.6g} m")
    failed = sum(1 for i, o in enumerate(outcomes)
                 if not o["ok"] or i in rejected)
    checks = {}
    for name, limit in limits.items():
        value = worst.get(name, math.nan)  # nan: nothing was judged
        checks[name] = {"value": value, "limit": limit}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    if trace:
        data = {"spans": spans.items, "requests": k, "slice": sliced}
        for m in cell.per_layer:
            v = specs.reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, "request_ms": window_s / k * 1e3,
               "request_p90_ms": percentile(lat, 90) * 1e3}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    result = {
        "correct": correct, "attempted": k, "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": (torch.cuda.get_device_name(0) if on_card
                     else "cpu"),
            "count": int(cell.entry["chips"]),
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        result["device"]["busy_s"] = sliced.busy_s
        result["device"]["window_s"] = sliced.window_s
        result["breakdown"] = {"device_ops": sliced.device_ops,
                               "idle_gaps": sliced.idle_gaps}
    result["checks"] = checks
    return result
