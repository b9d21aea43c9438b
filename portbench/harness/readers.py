"""What the per-layer readers (``metrics/<name>.py``) share.

A reader gets the traced run's data: ``spans`` [(request, label, t0, t1)]
from the measured part, ``requests`` (their count) and ``slice`` (the
profiled slice, ``profile.Slice``). It returns a number, or None when the
run has nothing for it to read.
"""

from __future__ import annotations


def _by_request(data, keep) -> dict:
    out: dict = {}
    for req, label, t0, t1 in data["spans"]:
        if keep(label):
            out.setdefault(req, []).append((t0, t1))
    return out


def union_ms(data, *prefixes) -> float | None:
    """Mean over requests of the wall time covered by the spans whose label
    starts with a prefix (spans of threads that overlap count once)."""
    reqs = _by_request(data, lambda s: s.startswith(prefixes))
    if not reqs:
        return None
    total = 0.0
    for iv in reqs.values():
        end = None
        for s, e in sorted(iv):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
    return total / len(reqs) * 1e3


def first_to_last_ms(data, label: str) -> float | None:
    """Mean over requests of the first start to the last end of a label."""
    reqs = _by_request(data, lambda s: s == label)
    if not reqs:
        return None
    return sum(max(e for _, e in iv) - min(s for s, _ in iv)
               for iv in reqs.values()) / len(reqs) * 1e3


def roofline_pct(data, kernel: str) -> float | None:
    """Share (%) of the kernel's counted launches' least time in their
    device time, over the profiled slice."""
    sl = data["slice"]
    if kernel not in sl.kernel_s or kernel not in sl.least_s:
        return None
    return 100.0 * sl.least_s[kernel] / sl.kernel_s[kernel]
