"""Per request of the profiled slice: ICP iterations (``icp.iterations``,
the loop's stats passes, a polish's included)."""

from portbench.harness.program_counters import per_request


def read(data):
    return per_request(data, "icp.iterations")
