"""Per frame: the _register_instances span (batched groups and stragglers)."""

from portbench.harness.readers import union_ms


def read(data):
    return union_ms(data, "pipeline.register")
