"""1 - (union of the device's busy intervals) / (the profiled slice's wall
time), in %."""


def read(data):
    sl = data["slice"]
    if sl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
