"""Per request: the spans of ransac_registration as its callers reach it."""

from portbench.harness.readers import union_ms


def read(data):
    return union_ms(data, "ransac")
