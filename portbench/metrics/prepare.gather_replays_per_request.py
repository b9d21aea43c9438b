"""Per request of the profiled slice: the gather route's CUDA graph
replayed (``prepare.gather.replays``), one a cloud that takes the brute
gather arm on the card. Set-up captures every graph the cell uses, so the
slice only replays. None where the program has no such graph
(``tpu3d_torch.ops.gather_graph`` missing)."""

import importlib.util

from portbench.harness.program_counters import per_request


def read(data):
    if importlib.util.find_spec("tpu3d_torch.ops.gather_graph") is None:
        return None
    return per_request(data, "prepare.gather.replays")
