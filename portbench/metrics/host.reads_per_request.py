"""Per request of the profiled slice: the program's blocking device→host
reads (``host.reads``, each made through ``host_read``)."""

from portbench.harness.program_counters import per_request


def read(data):
    return per_request(data, "host.reads")
