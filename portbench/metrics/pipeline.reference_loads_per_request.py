"""Per request of the profiled slice: the reference model read and
downsampled again (``pipeline.reference.loads``). None where the program
keeps no model between requests (neither ``pipeline.reference.loads``
nor ``.hits`` was counted)."""

from portbench.harness.program_counters import per_request, program_counters


def read(data):
    counts = program_counters() or {}
    if not any(n in counts for n in ("pipeline.reference.loads",
                                     "pipeline.reference.hits")):
        return None
    return per_request(data, "pipeline.reference.loads")
