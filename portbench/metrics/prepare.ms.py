"""Per request: the downsample and feature-prepare spans
(downsample_bucketed, prepare_features, fused_prepare_sparse),
overlapping threads counted once."""

from portbench.harness.readers import union_ms


def read(data):
    return union_ms(data, "prepare.")
