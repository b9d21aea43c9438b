"""Kernel launches on the profiler's device rows per request of the
profiled slice (a count; it repeats)."""


def read(data):
    sl = data["slice"]
    return sl.launches / sl.requests if sl.launches else None
