"""The gather route's brute arm on the card as one CUDA graph per key.

Below ``FUSED_CAPACITY_THRESHOLD`` rows, ``prepare_features`` takes the
gather route (``registration.gather_arm``): one exact self-kNN (chunked
matmul and K12), the normals and the radius-capped FPFH, a few hundred
launches of small tensor operations a cloud and no host read. Their shapes
depend only on the cloud's capacity, so on the card the arm is captured
once per :func:`gather_key` (after one eager warm-up) and replayed: a call
copies its points and mask into the graph's static inputs, replays, and
copies the normals and descriptors out, so no output of one replay is
another's. A replay runs the same kernels on the same values as the arm
run eagerly, so its outputs are the eager route's, bit for bit.

``prepare_features`` takes this module for the brute neighbour mode on a
CUDA cloud; the CPU and the 'slab' and 'grid' modes run the arm eagerly.
"""

from __future__ import annotations

import threading

import torch

from tpu3d_torch import build
from tpu3d_torch.device import on_device
from tpu3d_torch.types import FPFHFeatures, PointCloud
from tpu3d_torch.utils.profiling import count as count_event

# Keys are bounded by the buckets below 16,384 rows times the radii a
# process uses; the least recently used graph goes first.
_GRAPH_CACHE_SIZE = 8
_graphs: dict = {}
_graphs_lock = threading.Lock()
# One capture at a time: a capture synchronises the card and empties the
# allocator's cache first.
_capture_lock = threading.Lock()


def gather_key(cloud: PointCloud, radius: float) -> tuple:
    """What a graph is fixed by: the cloud's device, dtype and capacity and
    the FPFH radius. (Every graph is the brute search's: 'auto' below the
    threshold and 'brute' share one.)"""
    return (cloud.points.device, cloud.points.dtype, cloud.capacity,
            float(radius))


class GatherGraph:
    """``arm`` (the brute gather arm: cloud, radius → (idx, d2), the cloud
    with normals, its features) on static inputs, captured at the first
    :meth:`run` and replayed by every call. ``outputs`` are the graph's own
    (idx, d2, normals, descriptors), overwritten by each replay."""

    def __init__(self, key: tuple, arm):
        device, dtype, capacity, self.radius = key
        self.arm = arm
        self.points = torch.zeros((capacity, 3), dtype=dtype, device=device)
        self.mask = torch.zeros((capacity,), dtype=torch.bool, device=device)
        self.outputs: tuple = ()
        self.graph = None
        self.replay_launches: list = []
        self.lock = threading.Lock()

    def body(self):
        nbrs, cloud, feat = self.arm(
            PointCloud(points=self.points, mask=self.mask), self.radius)
        return nbrs[0], nbrs[1], cloud.normals, feat.descriptors

    def run(self, cloud: PointCloud) -> tuple[PointCloud, FPFHFeatures]:
        """The cloud's normals and descriptors by one replay (a capture
        first, at the first call), copied out of the graph."""
        with self.lock, on_device(self.points.device):
            self.points.copy_(cloud.points)
            self.mask.copy_(cloud.mask)
            if self.graph is None:
                self._capture()
            self.graph.replay()
            for wrapper, k in self.replay_launches:
                build.count_launch(wrapper, k)
            count_event("prepare.gather.replays")
            normals = self.outputs[2].clone()
            descriptors = self.outputs[3].clone()
        return (cloud._replace(normals=normals),
                FPFHFeatures(descriptors=descriptors, mask=cloud.mask))

    def _capture(self):
        count_event("prepare.gather.captures")
        # Other threads may run eager arms meanwhile: their launches are
        # not the capture's.
        with _capture_lock:
            self.graph, self.outputs, self.replay_launches = (
                build.capture_graph(self.body, self.points.device,
                                    capture_error_mode="thread_local"))


def graph_for(key: tuple, arm) -> GatherGraph:
    """The graph of ``key``, made (not yet captured) at first."""
    with _graphs_lock:
        g = _graphs.pop(key, None) or GatherGraph(key, arm)
        _graphs[key] = g  # most recent last
        while len(_graphs) > _GRAPH_CACHE_SIZE:
            _graphs.pop(next(iter(_graphs)))
        return g


def gather_features(cloud: PointCloud, radius: float,
                    arm) -> tuple[PointCloud, FPFHFeatures]:
    """``arm`` on a CUDA cloud by its key's graph: the cloud with normals,
    and its descriptors."""
    return graph_for(gather_key(cloud, radius), arm).run(cloud)
