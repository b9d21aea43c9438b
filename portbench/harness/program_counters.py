"""The program's own counters (``tpu3d_torch.utils.profiling``) per request
of the profiled slice, for the ``program_counter`` readers.

The program counts only while a ``torch.profiler`` profile runs, and the
profiled slice is a traced run's one profile, so the counts the process
holds when the readers run are the slice's. A program without the tracer
(an older checkout) gives None, as does a base of 0.
"""

from __future__ import annotations


def program_counters() -> dict | None:
    """The program's counters now, or None where it has none."""
    try:
        from tpu3d_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters()


def per_request(data, *names: str) -> float | None:
    """Σ of the named counters over the slice's requests."""
    counts = program_counters()
    requests = data["slice"].requests
    if counts is None or not requests:
        return None
    return sum(counts.get(n, 0) for n in names) / requests


def share_pct(data, part: str, *base: str) -> float | None:
    """100 · ``part`` / Σ ``base``, None where the base is 0."""
    counts = program_counters()
    if counts is None:
        return None
    whole = sum(counts.get(n, 0) for n in base)
    if not whole:
        return None
    return 100.0 * counts.get(part, 0) / whole
