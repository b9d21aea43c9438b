"""Per frame: the spans of get_masks and load_ply as pipeline.py calls them
(the frame's masks and the reference model read from files)."""

from portbench.harness.readers import union_ms


def read(data):
    return union_ms(data, "io.")
