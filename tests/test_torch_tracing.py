"""The port's tracer (``tpu3d_torch.utils.profiling``): spans, counters and
host reads inside ``register_pair`` and ``Pipeline.run()``, on the CPU.

Outside a profiler nothing is recorded or counted; under one the spans
nest by stage and carry their request, the pool's prepares that of the
run which handed them off, and the counters agree with what the loops
did. The poses are the same bit for bit either way."""

import json
import os

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tpu3d_torch
from tpu3d_torch.config import PipelineConfig
from tpu3d_torch.models.fixtures import make_pair
from tpu3d_torch.models.ply import save_ply
from tpu3d_torch.models.procedural import (
    generate_box_mask,
    generate_reference_grid,
)
from tpu3d_torch.ops import icp as icp_mod
from tpu3d_torch.ops import ransac as ransac_mod
from tpu3d_torch.pipeline import Pipeline
from tpu3d_torch.types import FPFHFeatures, PointCloud
from tpu3d_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

VOXEL = 0.005

# Where each span may open: the stage lists of the tracer's design.
PARENTS = {
    "pipeline.run": {None},
    "register_pair": {None},
    "io.read_frame": {"pipeline.run"},
    "io.get_masks": {"pipeline.run"},
    "io.load_ply": {"pipeline.reference"},
    "pipeline.reference": {"pipeline.run"},
    "pipeline.prepare_instance": {"pipeline.run"},
    "pipeline.register": {"pipeline.run"},
    "pipeline.instance": {"pipeline.register"},
    "pipeline.dedup": {"pipeline.run"},
    "registration.escalate": {"register_pair", "pipeline.instance", None},
    "prepare.downsample": {"register_pair", "pipeline.reference",
                           "pipeline.prepare_instance"},
    "prepare.features": {"register_pair", "pipeline.reference",
                         "pipeline.prepare_instance",
                         "registration.escalate", None},
    "prepare.sparse": {"register_pair", "pipeline.instance", None},
    # Under prepare.gather in the card's capture of the gather arm.
    "prepare.neighbors": {"prepare.features", "prepare.gather"},
    "prepare.normals": {"prepare.features", "prepare.gather"},
    "prepare.fpfh": {"prepare.features", "prepare.gather"},
    "prepare.gather": {"prepare.features"},
    "prepare.fused": {"prepare.features", "prepare.sparse",
                      "registration.escalate"},
    "ransac": {"register_pair", "pipeline.instance",
               "registration.escalate", None},
    "ransac.correspondences": {"ransac"},
    "ransac.sampler": {"ransac"},
    "ransac.chunk": {"ransac"},
    "ransac.one_shot": {"ransac"},
    "ransac.two_stage": {"ransac"},
    "ransac.rescore": {"ransac"},
    "icp": {"register_pair", "pipeline.instance", "registration.escalate",
            None},
    "icp.target": {"icp"},
    "icp.iteration": {"icp"},
    "icp.stats": {"icp.iteration"},
    "icp.solve": {"icp.iteration"},
    "prepare.read.count": {"prepare.downsample"},
    "pipeline.read.depth_count": {"pipeline.prepare_instance"},
    "pipeline.read.count": {"pipeline.prepare_instance"},
    "pipeline.read.fitness": {"pipeline.instance"},
    "pipeline.read.rmse": {"pipeline.instance"},
    "pipeline.read.pose": {"pipeline.instance"},
    "ransac.read.n_valid": {"ransac"},
    "ransac.read.exit_flag": {"ransac.chunk"},
    "icp.read.n_valid": {"icp"},
    "icp.read.initial_pose": {"icp"},
    "icp.read.stats": {"icp.stats"},
    "icp.read.pose": {"icp"},
    "icp.read.fitness": {"icp"},
    "registration.read.fitness": {"register_pair", "registration.escalate",
                                  None},
}


def _pair(n=2048):
    src, tgt, _, _ = make_pair(n, voxel=VOXEL)
    return (PointCloud.from_numpy(src, device="cpu"),
            PointCloud.from_numpy(tgt, device="cpu"))


def _spans(logdir):
    """The labelled ``tpu3d:`` ranges of ``trace.json``: [(name, tid,
    request, parent)] in the order they opened."""
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    out = [e for e in events if e.get("cat") == "user_annotation"
           and e["name"].startswith(profiling.PREFIX)]
    out.sort(key=lambda e: (e["ts"], -e["dur"]))
    return [(e["name"][len(profiling.PREFIX):], e["tid"],
             e["args"]["request"], e["args"]["parent"]) for e in out]


def _check_nesting(spans):
    for name, _, _, parent in spans:
        assert name in PARENTS, name
        assert parent in PARENTS[name], (name, parent)


def _no_tracing(monkeypatch):
    """Fail on any range a span would open; return the counters now."""
    def refuse(*a, **k):
        raise AssertionError("a span opened outside a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    return profiling.counters()


def _pipeline_config(tmp_path, n_masks):
    """The 320 x 240 demo scene with ``n_masks`` copies of its box mask in
    a mask directory, so that the host pool prepares each."""
    cfg = PipelineConfig()
    cfg.use_camera = cfg.use_robot = False
    cfg.use_gpu = False
    cfg.visualization = "none"
    cfg.camera.width, cfg.camera.height = 320, 240
    cfg.registration.voxel_size = VOXEL
    cfg.registration.ransac_max_iterations = 500
    cfg.registration.icp_max_iterations = 10
    cfg.camera_extrinsics = np.eye(4, dtype=np.float32)
    cfg.num_threads = 2
    masks = tmp_path / "masks"
    masks.mkdir()
    for i in range(n_masks):
        cv2.imwrite(str(masks / f"mask_{i:03d}.png"),
                    generate_box_mask(320, 240))
    cfg.segmentation.masks_input_dir = str(masks)
    return cfg


def test_register_pair_records_nothing_outside_a_profiler(monkeypatch):
    before = _no_tracing(monkeypatch)
    s, t = _pair()
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL,
                                         ransac_max_iterations=30000)
    tpu3d_torch.register_pair(s, t, cfg)
    assert profiling.counters() == before


def test_pipeline_run_records_nothing_outside_a_profiler(monkeypatch,
                                                         tmp_path):
    before = _no_tracing(monkeypatch)
    pipe = Pipeline(_pipeline_config(tmp_path, 2), sleep_fn=lambda s: None)
    assert len(pipe.run()) >= 1
    assert profiling.counters() == before


def test_register_pair_spans_nest_and_poses_match(tmp_path):
    """One request: every span carries it and opens where the design
    puts it; the pose is the untraced one bit for bit; counters.json
    holds the block's counts."""
    s, t = _pair()
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL,
                                         ransac_max_iterations=30000)
    off, off_c = tpu3d_torch.register_pair(s, t, cfg)
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        on, on_c = tpu3d_torch.register_pair(s, t, cfg)
    assert torch.equal(off.transformation, on.transformation)
    assert torch.equal(off_c.transformation, on_c.transformation)
    assert torch.equal(off.fitness, on.fitness)

    spans = _spans(logdir)
    _check_nesting(spans)
    assert spans[0][0] == "register_pair" and spans[0][3] is None
    assert {r for _, _, r, _ in spans} == {spans[0][2]} and spans[0][2] > 0
    names = {n for n, _, _, _ in spans}
    assert names >= {"prepare.downsample", "prepare.features",
                     "prepare.neighbors", "prepare.normals", "prepare.fpfh",
                     "ransac", "ransac.correspondences", "ransac.sampler",
                     "ransac.chunk", "ransac.rescore", "icp", "icp.target",
                     "icp.iteration", "icp.stats", "icp.solve",
                     "icp.read.stats", "ransac.read.exit_flag"}

    with open(os.path.join(logdir, "counters.json")) as f:
        counts = json.load(f)
    n_iter = sum(n == "icp.iteration" for n, _, _, _ in spans)
    n_chunk = sum(n == "ransac.chunk" for n, _, _, _ in spans)
    assert counts["icp.iterations"] == n_iter and counts["icp.runs"] == 1
    assert counts["ransac.chunks"] == n_chunk
    reads = [n for n, _, _, _ in spans if ".read." in n]
    assert counts["host.reads"] == len(reads)
    for site in set(reads):
        layer, what = site.split(".read.")
        assert counts[f"host.reads.{layer}.{what}"] == reads.count(site)


def test_pipeline_pool_spans_carry_their_run(tmp_path):
    """Two runs: the prepares on the pool's threads carry the id of the
    run that handed them off, with that run as their parent."""
    cfg = _pipeline_config(tmp_path, 2)
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    off = pipe.run()
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        runs = [pipe.run(), pipe.run()]
    for on in runs:
        assert len(on) == len(off)
        for a, b in zip(on, off):
            np.testing.assert_array_equal(a, b)

    spans = _spans(logdir)
    _check_nesting(spans)
    roots = [(r, tid) for n, tid, r, _ in spans if n == "pipeline.run"]
    assert len(roots) == 2 and roots[0][0] != roots[1][0]
    for request, main in roots:
        mine = [(n, tid, p) for n, tid, r, p in spans if r == request]
        prep = [(tid, p) for n, tid, p in mine
                if n == "pipeline.prepare_instance"]
        assert len(prep) == 2
        assert all(p == "pipeline.run" for _, p in prep)
        assert any(tid != main for tid, _ in prep)  # on the pool's threads
        assert {n for n, _, _ in mine} >= {
            "io.read_frame", "io.get_masks", "pipeline.reference",
            "pipeline.register", "pipeline.instance", "pipeline.dedup",
            "prepare.downsample", "ransac", "icp"}
    assert all(r in {q for q, _ in roots} for _, _, r, _ in spans)


def test_pipeline_reference_kept_counts_hits(tmp_path):
    """After an untraced run, two traced runs on one Pipeline reuse the
    model read from its file: two hits, no load, and each run opens
    ``pipeline.reference`` but not ``io.load_ply``."""
    cfg = _pipeline_config(tmp_path, 1)
    cfg.reference_model_path = str(tmp_path / "model.ply")
    save_ply(cfg.reference_model_path, generate_reference_grid()[0])
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    off = pipe.run()
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        runs = [pipe.run(), pipe.run()]
    for on in runs:
        assert len(on) == len(off) >= 1
        for a, b in zip(on, off):
            np.testing.assert_array_equal(a, b)
    with open(os.path.join(logdir, "counters.json")) as f:
        counts = json.load(f)
    assert counts["pipeline.reference.hits"] == 2
    assert counts.get("pipeline.reference.loads", 0) == 0

    spans = _spans(logdir)
    _check_nesting(spans)
    roots = [r for n, _, r, _ in spans if n == "pipeline.run"]
    assert len(roots) == 2
    for request in roots:
        names = [n for n, _, r, _ in spans if r == request]
        assert names.count("pipeline.reference") == 1
        assert "io.load_ply" not in names


def test_pipeline_reference_first_run_counts_a_load(tmp_path):
    """A Pipeline's first run reads its model inside
    ``pipeline.reference`` and counts one load and no hit."""
    cfg = _pipeline_config(tmp_path, 1)
    cfg.reference_model_path = str(tmp_path / "model.ply")
    save_ply(cfg.reference_model_path, generate_reference_grid()[0])
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        assert len(Pipeline(cfg, sleep_fn=lambda s: None).run()) >= 1
    with open(os.path.join(logdir, "counters.json")) as f:
        counts = json.load(f)
    assert counts["pipeline.reference.loads"] == 1
    assert counts.get("pipeline.reference.hits", 0) == 0
    spans = _spans(logdir)
    _check_nesting(spans)
    assert [p for n, _, _, p in spans if n == "io.load_ply"] == [
        "pipeline.reference"]


def _icp_problem():
    """A small point-to-plane ICP at a perturbed start, through the
    gathered stats."""
    s, t = _pair(1024)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL)
    reg = tpu3d_torch.registration
    src = reg.downsample_bucketed(s, cfg)
    tgt, _ = reg.prepare_features(reg.downsample_bucketed(t, cfg), cfg)
    T0 = torch.eye(4)
    T0[:3, 3] = torch.tensor([0.004, -0.003, 0.002])
    return src, tgt, T0


@pytest.mark.parametrize("case", ["converged", "max_iterations", "few_corr",
                                  "nonfinite", "no_budget"])
def test_icp_counts_iterations_and_stop(case):
    src, tgt, T0 = _icp_problem()
    thr = 1e-9 if case == "few_corr" else 0.01
    stats = icp_mod.gathered_stats_fn(
        lambda P: icp_mod.nearest_neighbor(P, tgt.points, tgt.mask),
        src.points, src.mask, tgt.points, tgt.normals, thr)
    calls = []

    def counted(T):
        calls.append(1)
        out = stats(T)
        if case == "nonfinite":
            vec = torch.full_like(out.vec, float("nan"))
            vec[-2] = 100.0
            return icp_mod.IcpStats(vec)
        return out

    iters = {"max_iterations": 2, "no_budget": 0}.get(case, 200)
    with profile(activities=[ProfilerActivity.CPU]):
        before = profiling.counters()
        icp_mod.icp_loop(counted, float(src.mask.sum()), T0, iters)
        after = profiling.counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    reason = "max_iterations" if case == "no_budget" else case
    assert delta.pop("icp.iterations", 0) == len(calls)
    expected = {"few_corr": 1, "nonfinite": 1, "max_iterations": 2,
                "no_budget": 0}
    if case in expected:
        assert len(calls) == expected[case]
    else:
        assert 2 < len(calls) < iters
    assert delta.pop("icp.runs") == 1
    assert delta.pop("icp.stop." + reason) == 1
    assert not [k for k in delta if k.startswith("icp.stop.")]


class _Replay:
    """A replayed draw stream that records the chunks it was asked for."""

    def __init__(self, seed=5):
        self.inner = ransac_mod.TorchDraws(seed)
        self.chunks = set()

    def __call__(self, chunk, epoch):
        self.chunks.add(chunk)
        return self.inner(chunk, epoch)

    def triples(self, chunk, h, count):
        self.chunks.add(chunk)
        return self.inner.triples(chunk, h, count)

    def rows(self, n, count):
        return self.inner.rows(n, count)


def _ransac_inputs(n=2048):
    g = torch.Generator().manual_seed(11)
    p = torch.rand((n, 3), generator=g)
    mask = torch.ones(n, dtype=torch.bool)
    mask[-5:] = False
    desc = torch.rand((n, 33), generator=g)
    cloud = PointCloud(points=p, mask=mask)
    feats = FPFHFeatures(descriptors=desc, mask=mask)
    return cloud, feats, int(mask.sum())


@pytest.mark.parametrize("route,max_iterations,confidence", [
    ("rotation", 40000, 1.0),
    ("gather", 40000, 1.0),
    ("rotation", 40000, 0.0),
    ("one_shot", 10000, 1.0),
])
def test_ransac_counts_chunks_and_hypotheses(route, max_iterations,
                                             confidence):
    cloud, feats, count = _ransac_inputs()
    n = cloud.points.shape[0]
    draws = _Replay()
    hyp = ransac_mod.hypothesis_chunk(max_iterations)
    with profile(activities=[ProfilerActivity.CPU]):
        before = profiling.counters()
        ransac_mod.ransac_registration(
            cloud, cloud, feats, feats, VOXEL, max_iterations=max_iterations,
            confidence=confidence, draws=draws, two_stage=False,
            sampling="gather" if route == "gather" else "auto")
        after = profiling.counters()
    delta = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    if route == "one_shot":
        assert delta["ransac.runs.one_shot"] == 1
        assert delta["ransac.hypotheses"] == -(-max_iterations // 512) * 512
        assert "ransac.chunks" not in delta
        return
    per_chunk = ((hyp // n) * count + min(hyp % n, count)
                 if route == "rotation" else hyp)
    bound = -(-max_iterations // per_chunk)
    chunks = 1 if confidence == 0.0 else bound
    assert delta[f"ransac.runs.chunked.{route}"] == 1
    assert delta["ransac.chunks"] == len(draws.chunks) == chunks
    assert delta["ransac.hypotheses"] == chunks * per_chunk
    assert delta.get("ransac.early_exits", 0) == (confidence == 0.0)
    assert delta["host.reads.ransac.exit_flag"] == chunks


def test_forced_escalation_counts_one(tmp_path, monkeypatch):
    """``escalate_below`` above any fitness re-runs the dense arm once,
    inside its span. The fused prepares' plain versions are slow on the
    CPU, so the gather route's prepare stands in for both."""
    s, t = _pair()
    reg = tpu3d_torch.registration
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL)
    src = reg.downsample_bucketed(s, cfg)
    tgt, tf = reg.prepare_features(reg.downsample_bucketed(t, cfg), cfg)

    def dense(cloud, radius):
        return reg.prepare_features(cloud, cfg)

    def sparse(cloud, radius, corr_cap):
        return dense(cloud, radius) + (None,)

    monkeypatch.setattr(reg, "fused_prepare_features", dense)
    monkeypatch.setattr(reg, "fused_prepare_sparse", sparse)
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        _, _, escalated = reg.sparse_register_escalated(
            src, tgt, tf, voxel=VOXEL, radius=np.float32(VOXEL * 5),
            max_iterations=30000, icp_max_iterations=30,
            escalate_below=2.0)
    with open(os.path.join(logdir, "counters.json")) as f:
        counts = json.load(f)
    assert counts["registration.escalations"] == 1 and escalated is False
    spans = _spans(logdir)
    _check_nesting(spans)
    inside = [n for n, _, _, p in spans
              if p == "registration.escalate" and ".read." not in n]
    assert inside == ["prepare.features", "ransac", "icp"]
    assert [n for n, _, _, p in spans if p is None] == [
        "prepare.features", "ransac", "icp", "registration.read.fitness",
        "registration.escalate"]


def test_trace_writes_the_blocks_counters(tmp_path):
    """counters.json: each counter's change over the block, launches
    included; counts outside a profiler are dropped."""
    profiling.count("test.outside", 5)
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        profiling.count("test.inside", 2)
        profiling.count("test.inside")
        assert profiling.host_read("test.site", torch.ones(3).sum(),
                                   float) == 3.0
    with open(os.path.join(logdir, "counters.json")) as f:
        counts = json.load(f)
    assert counts == {"host.reads": 1, "host.reads.test.site": 1,
                      "test.inside": 3}
    assert "test.outside" not in profiling.counters()
