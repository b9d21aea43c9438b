"""Per request of the profiled slice: the RANSAC budget's iterations
consumed (``ransac.hypotheses``: the chunked loop's last id, or every
hypothesis of a one-shot or two-stage draw)."""

from portbench.harness.program_counters import per_request


def read(data):
    return per_request(data, "ransac.hypotheses")
