"""Per request of the profiled slice: re-runs of the sparse arm through
the dense prepare (``registration.escalations``)."""

from portbench.harness.program_counters import per_request


def read(data):
    return per_request(data, "registration.escalations")
