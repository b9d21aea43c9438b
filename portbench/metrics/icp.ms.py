"""Per request: the spans of icp_refine as its callers reach it."""

from portbench.harness.readers import union_ms


def read(data):
    return union_ms(data, "icp")
