"""The gather route's row selection and its CUDA graph, on the CPU.

``knn_select``'s plain version (a stable sort and a slice: what K12 is held
to on the card) against ``smallest_k`` and against the JAX package's
``knn``, on planted ties and sentinel rows; ``knn_select``'s routes. Then
``ops/gather_graph``'s bookkeeping with the capture mocked (a replay runs
the arm eagerly into the graph's outputs): each field of the key captures
its own graph, a key captures once and replays after, two clouds replayed
back to back keep their own outputs, equal bit for bit to the eager route,
and ``prepare_features`` takes the graph only where it would launch kernels.
With the CUDA calls faked, ``build.capture_graph`` keeps a capture's
launches apart from another thread's. The capture itself and K12 are held
on the card (``tests/test_torch_kernels_cuda.py``).
"""

import contextlib
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import profile

from tpu3d.ops.neighbors import knn as jax_knn
from tpu3d_torch import build
from tpu3d_torch import registration as reg
from tpu3d_torch.config import RegistrationConfig
from tpu3d_torch.models.fixtures import make_pair
from tpu3d_torch.ops import gather_graph
from tpu3d_torch.ops.neighbors import (
    KNN_SELECT_MAX_K,
    knn,
    knn_select,
    knn_select_plain,
    smallest_k,
)
from tpu3d_torch.types import PointCloud
from tpu3d_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

VOXEL = 0.005


def _tied_rows(seed, q=64, m=300):
    """Squared distances on a coarse lattice (many exact ties), +0.0
    included, with whole sentinel columns and a few sentinel-heavy rows."""
    rng = np.random.default_rng(seed)
    d2 = (rng.integers(0, 12, (q, m)) * 0.125).astype(np.float32)
    d2[:, rng.random(m) < 0.3] += np.float32(1e30)
    d2[: q // 4, rng.random(m) < 0.9] = np.float32(1e30)
    return torch.from_numpy(d2)


@pytest.mark.parametrize("k", [1, 30, 100, 128])
def test_knn_select_plain_ties_as_smallest_k(k):
    d2 = _tied_rows(k)
    v, i = knn_select_plain(d2, k)
    ev, ei = smallest_k(d2, k)
    assert i.dtype == torch.int32
    assert torch.equal(i.long(), ei)
    assert torch.equal(v.view(torch.int32), ev.view(torch.int32))
    # Within equal values the columns ascend.
    same = v[:, 1:] == v[:, :-1]
    assert bool((i[:, 1:][same] > i[:, :-1][same]).all())


def _lattice_cloud(seed, n=200, valid=None):
    """Integer points with duplicates: the matmul expansion is exact, so
    JAX's d² and the port's are the same numbers."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 6, (n, 3)).astype(np.float32)
    pts[n // 2:] = pts[: n - n // 2]  # every point twice or more
    mask = np.ones(n, bool)
    if valid is not None:
        mask[valid:] = False
    return pts, mask


@pytest.mark.parametrize("n,valid,k", [(200, None, 30), (200, 40, 100),
                                       (64, 20, 100)])
def test_knn_ties_and_sentinels_as_jax(n, valid, k):
    """Duplicated points tie at the lower index first, invalid targets sit
    at 1e30 in index order, and with fewer than k targets (n 64, k 100)
    the extra slots are index 0 at 1e30: as JAX's ``knn``."""
    pts, mask = _lattice_cloud(n + k, n, valid)
    t = torch.from_numpy(pts)
    idx, d2 = knn(t, t, torch.from_numpy(mask), k=k, chunk=48)
    jidx, jd2 = jax_knn(jnp.asarray(pts), jnp.asarray(pts),
                        jnp.asarray(mask), k=k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    big = float(np.float32(1e30))
    if valid is not None:  # the invalid targets follow, in index order
        assert bool((d2[:, valid:min(n, k)] == big).all())
        assert torch.equal(idx[0, valid:min(n, k)],
                           torch.arange(valid, min(n, k), dtype=torch.int32))
    if n < k:
        assert bool((idx[:, n:] == 0).all()) and bool((d2[:, n:] == big).all())


def test_knn_select_routes():
    d2 = _tied_rows(0, q=8, m=200)
    assert knn_select.launches == 0  # CPU tensors never launch K12
    v, i = knn_select(d2, 100)
    pv, pi = knn_select_plain(d2, 100)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    v, i = knn_select(d2, KNN_SELECT_MAX_K + 1)  # the sort, by k
    assert v.shape == (8, KNN_SELECT_MAX_K + 1)
    v, i = knn_select(d2, 0)  # no targets, no columns: the sort too
    assert v.shape == i.shape == (8, 0)
    assert knn_select.launches == 0
    for bad in (-1, 201):
        with pytest.raises(ValueError):
            knn_select(d2, bad)


@pytest.fixture
def fresh_graphs(monkeypatch):
    """An empty graph cache and a capture that records its key and makes a
    replay run the arm eagerly into the graph's outputs."""
    monkeypatch.setattr(gather_graph, "_graphs", {})
    captured = []

    def fake_capture(self):
        captured.append((self.points.shape[0], self.radius))
        self.outputs = self.body()

        def replay():
            for out, new in zip(self.outputs, self.body()):
                out.copy_(new)
        self.graph = types.SimpleNamespace(replay=replay)

    monkeypatch.setattr(gather_graph.GatherGraph, "_capture", fake_capture)
    return captured


def _downs(n_points=700, seed=5):
    src, tgt, _, _ = make_pair(n_points, seed=seed, voxel=VOXEL)
    cfg = RegistrationConfig(voxel_size=VOXEL)
    return [reg.downsample_bucketed(PointCloud.from_numpy(c, device="cpu"),
                                    cfg) for c in (src, tgt)], cfg


def test_each_key_field_captures_its_own_graph(fresh_graphs):
    (src, _), _ = _downs()
    r = 0.025
    for radius in (r, r, 0.02):
        gather_graph.gather_features(src, radius, reg.gather_arm)
    cap = src.capacity
    bigger = PointCloud(  # the same points in a bucket twice the size
        points=torch.cat([src.points, torch.zeros(cap, 3)]),
        mask=torch.cat([src.mask, torch.zeros(cap, dtype=torch.bool)]))
    gather_graph.gather_features(bigger, r, reg.gather_arm)
    # The first key again: a replay.
    gather_graph.gather_features(src, r, reg.gather_arm)
    assert fresh_graphs == [(cap, r), (cap, 0.02), (2 * cap, r)]
    # The device and the dtype are fields of the key too.
    base = gather_graph.gather_key(src, r)
    meta = src._replace(points=torch.zeros(src.points.shape, device="meta"))
    keys = {base, gather_graph.gather_key(meta, r),
            gather_graph.gather_key(src._replace(points=src.points.double()),
                                    r)}
    assert len(keys) == 3


def test_graph_cache_is_bounded(fresh_graphs):
    keys = [(torch.device("cpu"), torch.float32, 256, 0.01 * i)
            for i in range(gather_graph._GRAPH_CACHE_SIZE + 3)]
    graphs = [gather_graph.graph_for(k, reg.gather_arm) for k in keys]
    assert len(gather_graph._graphs) == gather_graph._GRAPH_CACHE_SIZE
    assert gather_graph.graph_for(keys[-1], reg.gather_arm) is graphs[-1]
    assert keys[0] not in gather_graph._graphs


@pytest.fixture
def fake_cuda_capture(monkeypatch):
    """``torch.cuda``'s streams and graphs as no-ops: a "capture" runs its
    body on the CPU, and the fake graph's replay does nothing."""
    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())


def test_capture_counts_only_its_own_launches(fake_cuda_capture,
                                              monkeypatch):
    """A second thread launches K12 eagerly while a graph is captured: its
    launch counts as it runs, and the graph's replay counts only the
    graph's own launches (8 chunks of K12 here)."""
    monkeypatch.setattr(gather_graph, "_graphs", {})
    monkeypatch.setattr(knn_select, "launches", 0)

    def eager_launch():
        build.count_launch(knn_select)

    def arm(cloud, radius):
        other = threading.Thread(target=eager_launch)
        other.start()
        other.join()
        for _ in range(8):
            build.count_launch(knn_select)
        n = cloud.capacity
        return ((torch.zeros(n, 100, dtype=torch.int32), torch.zeros(n, 100)),
                cloud._replace(normals=torch.zeros(n, 3)),
                types.SimpleNamespace(descriptors=torch.zeros(n, 33)))

    (src, _), _ = _downs()
    g = gather_graph.graph_for(gather_graph.gather_key(src, 0.025), arm)
    g.run(src)
    # The warm-up's 8 and the other thread's 1, twice (warm-up, capture);
    # then the replay's 8.
    assert g.replay_launches == [(knn_select, 8)]
    assert knn_select.launches == 8 + 2 + 8
    g.run(src)
    assert knn_select.launches == 8 + 2 + 8 + 8
    assert build._CAPTURING.counts is None


def test_replays_back_to_back_equal_the_eager_route(fresh_graphs,
                                                    monkeypatch):
    """Source and target at one key, replayed in turn: each keeps its own
    normals and descriptors, the eager route's bit for bit."""
    (src, tgt), cfg = _downs()
    assert src.capacity == tgt.capacity
    eager = [reg.prepare_features(c, cfg) for c in (src, tgt)]
    assert gather_graph._graphs == {}  # the CPU runs the arm eagerly
    monkeypatch.setattr(reg, "launches_kernel", lambda *t: True)
    before = profiling.counters().get("prepare.gather.replays", 0)
    with profile():
        replayed = [reg.prepare_features(c, cfg) for c in (src, tgt)]
        counts = profiling.counters()
    assert len(fresh_graphs) == 1
    assert counts.get("prepare.gather.replays") == before + 2
    for (ec, ef), (gc, gf) in zip(eager, replayed):
        assert torch.equal(gc.normals, ec.normals)
        assert torch.equal(gf.descriptors, ef.descriptors)
        assert gc.points is ec.points and gf.mask is ef.mask
    g = next(iter(gather_graph._graphs.values()))
    assert replayed[0][1].descriptors.data_ptr() != g.outputs[3].data_ptr()
    idx, d2 = knn(tgt.points, tgt.points, tgt.mask, k=100, method="exact")
    assert torch.equal(g.outputs[0], idx) and torch.equal(g.outputs[1], d2)


@pytest.mark.parametrize("mode", ["auto", "brute", "slab", "grid"])
def test_cpu_prepare_takes_the_eager_route(fresh_graphs, mode):
    """On the CPU every mode runs the arm eagerly: no graph, no capture or
    replay counted, the eager spans opened."""
    (src, _), cfg = _downs()
    before = profiling.counters()
    with profile() as prof:
        reg.prepare_features(src, cfg, mode)
        counts = profiling.counters()
    names = {e.name for e in prof.events()}
    assert fresh_graphs == [] and gather_graph._graphs == {}
    assert all(counts[n] == before.get(n) for n in counts
               if n.startswith("prepare.gather"))
    assert "tpu3d:prepare.neighbors" in names
    assert "tpu3d:prepare.gather" not in names
