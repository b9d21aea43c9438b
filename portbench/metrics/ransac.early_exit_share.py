"""Share (%) of the slice's chunked RANSAC runs that stopped on the
confidence before the budget and the chunk bound (``ransac.early_exits``
over ``ransac.runs.chunked.*``); None without a chunked run."""

from portbench.harness.program_counters import share_pct


def read(data):
    return share_pct(data, "ransac.early_exits",
                     "ransac.runs.chunked.rotation",
                     "ransac.runs.chunked.gather")
