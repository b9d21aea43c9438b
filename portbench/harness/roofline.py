"""The yardstick of the kernel shares: peaks, and each kernel's operations
and bytes counted from the shapes of its calls.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 495 TFLOP/s in
TF32, the highest rate at which a float32-accurate result can be had on
its tensor cores, and 3.35 TB/s of HBM. A share is the least time the
chip could take for the slice's launches (the larger of operations over
the FLOP rate and bytes over the byte rate, summed over launches) over
their measured device time; it counts the algorithm's work, not the
passes or the padding of the kernel that does it.
"""

from __future__ import annotations

PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12

# Device kernel names of each kernel (a kernel and its split reduction).
KERNELS = {
    "k5": ("nn_desc_kernel", "nn_desc_reduce"),
    "k6": ("score_tc_kernel", "score_reduce"),
}


def k5_work(q: int, m: int, d: int) -> tuple[float, float]:
    """Descriptor top-1 of q valid queries over m valid targets in d
    dimensions: 2·q·m·d operations; each descriptor read once, an index
    and a distance written a query."""
    return 2.0 * q * m * d, 4.0 * (q + m) * d + 8.0 * q


def k6_work(h: int, n: int) -> tuple[float, float]:
    """Scoring of h hypotheses on n valid correspondences: per pair the
    transform R·p + t (18 operations) and the distance to q (8); each
    correspondence (p, q) and hypothesis (R, t) read once, a count and an
    error sum written a hypothesis."""
    return 26.0 * h * n, 24.0 * n + 48.0 * h + 8.0 * h


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
