"""Per frame: first start to last end of the prepare_instance spans (the
host pool's per-instance prepare)."""

from portbench.harness.readers import first_to_last_ms


def read(data):
    return first_to_last_ms(data, "pipeline.prepare_instance")
