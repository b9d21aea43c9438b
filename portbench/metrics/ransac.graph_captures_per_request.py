"""Per request of the profiled slice: RANSAC chunk graphs captured
(``ransac.graph_captures``). Set-up captures every graph the cell uses,
so any capture here is a rebuild."""

from portbench.harness.program_counters import per_request


def read(data):
    return per_request(data, "ransac.graph_captures")
