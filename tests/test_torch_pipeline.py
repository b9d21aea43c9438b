"""The port's ``Pipeline`` and CLI against the JAX package's, on the small
fixtures of ``tests/test_pipeline.py`` (JAX on the CPU, the port with
``use_gpu: false`` so every kernel takes its plain version).

The port replays JAX's RANSAC draw stream (``Pipeline._draws``); waypoints
must agree within 1e-5 and refined fitness within one inlier. The planar
demo scene is degenerate (descriptor ties pick different correspondences in
the two frameworks, and a plane does not fix the in-plane pose), so there
only the orchestration contract is compared, as JAX's own test does.
"""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from test_pipeline import _bumpy_frame
from test_torch_ransac import JaxDraws
from torch_threads import one_torch_thread  # noqa: F401
from tpu3d import oracle
from tpu3d.config import PipelineConfig as JaxConfig
from tpu3d.config import load_config as jax_load_config
from tpu3d.models.ply import load_ply as jax_load_ply
from tpu3d.pipeline.dedup import filter_duplicates as jax_dedup
from tpu3d.pipeline.pipeline import Pipeline as JaxPipeline
from tpu3d_torch.__main__ import main
from tpu3d_torch.config import PipelineConfig, load_config
from tpu3d_torch.models.ply import load_ply, save_ply
from tpu3d_torch.pipeline import Pipeline, filter_duplicates
from tpu3d_torch.types import RegistrationResult

SCALE = 10000.0  # 0.1 mm depth units, as the JAX tests use


def _demo(cfg):
    cfg.use_camera = False
    cfg.use_robot = False
    cfg.visualization = "none"
    cfg.camera.width, cfg.camera.height = 320, 240
    cfg.registration.voxel_size = 0.005
    cfg.registration.ransac_max_iterations = 500
    cfg.registration.icp_max_iterations = 10
    cfg.camera_extrinsics = np.eye(4, dtype=np.float32)
    return cfg


def _port_config(setup):
    cfg = setup(_demo(PipelineConfig()))
    cfg.use_gpu = False
    return cfg


def _run_both(setup, K=None):
    """Run JAX's and the port's pipeline on ``setup(demo config)``; returns
    (jax pipeline, its waypoints, port pipeline, its waypoints, the port's
    valid rows per instance)."""
    jp = JaxPipeline(setup(_demo(JaxConfig())), sleep_fn=lambda s: None)
    tp = Pipeline(_port_config(setup), sleep_fn=lambda s: None)
    tp._draws = JaxDraws(tp.config.registration.ransac_seed)
    jp._forced_K = tp._forced_K = K
    rows = {}
    prepare = tp.prepare_instance

    def recorded(mask, depth_raw, rgb, K, i):
        out = prepare(mask, depth_raw, rgb, K, i)
        rows[i] = out[0].count()
        return out

    tp.prepare_instance = recorded
    return jp, jp.run(), tp, tp.run(), rows


def _assert_same(jp, jw, tp, tw, rows):
    assert len(tw) == len(jw) >= 1
    for a, b in zip(jw, tw):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    ja = sorted(jp.instance_results, key=lambda r: r["instance_id"])
    tb = sorted(tp.instance_results, key=lambda r: r["instance_id"])
    assert [r["instance_id"] for r in tb] == [r["instance_id"] for r in ja]
    for a, b in zip(ja, tb):
        n = rows[b["instance_id"]]
        assert abs(b["fitness"] - a["fitness"]) * n <= 1.0 + 1e-3
        np.testing.assert_allclose(b["T_world_object"], a["T_world_object"],
                                   rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def bumpy(tmp_path_factory):
    """The bumpy frame as dummy-data PNGs, three instance masks, and the
    reference model (the deprojected quantised frame) written by the
    port's ``save_ply``."""
    tmp = tmp_path_factory.mktemp("bumpy")
    z, K = _bumpy_frame()
    depth_u16 = (z * SCALE).astype(np.uint16)
    h, w = depth_u16.shape
    pts, _ = oracle.deproject(depth_u16.astype(np.float32) / SCALE, None,
                              K[0, 0], K[1, 1], K[0, 2], K[1, 2],
                              clipping_max=1.5)
    ply = str(tmp / "ref.ply")
    save_ply(ply, pts)
    cv2.imwrite(str(tmp / "rgb.png"), np.zeros((h, w, 3), np.uint8) + 90)
    cv2.imwrite(str(tmp / "depth.png"), depth_u16)
    masks = tmp / "masks"
    masks.mkdir()
    for j, (x0, x1) in enumerate([(10, 110), (120, 220), (10, 110)]):
        m = np.zeros((h, w), np.uint8)
        y0 = 20 + 40 * (j == 2)
        m[y0:y0 + 100, x0:x1] = 255
        cv2.imwrite(str(masks / f"mask_{j}.png"), m)
    return {"K": K, "ply": ply, "pts": pts, "rgb": str(tmp / "rgb.png"),
            "depth": str(tmp / "depth.png"), "masks": str(masks)}


def _bumpy_setup(fx, bilateral=False, **registration):
    """The JAX ground-truth test's config, with ``registration`` fields
    overridden."""

    def setup(cfg):
        cfg.camera.width, cfg.camera.height = 240, 180
        cfg.depth.scale_to_meters = SCALE
        cfg.depth.bilateral_filter = bilateral
        cfg.reference_model_path = fx["ply"]
        cfg.registration.voxel_size = 0.008
        cfg.registration.ransac_max_iterations = 4000
        cfg.registration.icp_max_iterations = 40
        for k, v in registration.items():
            setattr(cfg.registration, k, v)
        cfg.dummy_rgb_path, cfg.dummy_depth_path = fx["rgb"], fx["depth"]
        cfg.segmentation.apply_mask = False
        return cfg

    return setup


@pytest.mark.parametrize("bilateral", [False, True])
def test_ply_ground_truth_matches_jax(bumpy, bilateral):
    """Reference model = the scene itself: the waypoint is the identity, on
    both sides, with and without the bilateral filter (K9's plain
    version)."""
    jp, jw, tp, tw, rows = _run_both(
        _bumpy_setup(bumpy, bilateral), bumpy["K"])
    _assert_same(jp, jw, tp, tw, rows)
    res = tp.instance_results[0]
    assert res["fitness"] > 0.8, res
    np.testing.assert_allclose(tw[0][:3, :3], np.eye(3), atol=0.02)
    np.testing.assert_allclose(tw[0][:3, 3], 0.0, atol=0.01)


@pytest.mark.parametrize("knob", [{"two_stage": "on"},
                                  {"use_point_to_plane": False}])
def test_registration_knobs_match_jax(bumpy, knob):
    """``two_stage: on`` (two-stage RANSAC scoring) and
    ``use_point_to_plane: false`` (point-to-point ICP): every instance
    posed, at JAX's pose."""
    jp, jw, tp, tw, rows = _run_both(_bumpy_setup(bumpy, **knob), bumpy["K"])
    assert tp._degraded == 0
    assert len(tp.instance_results) == 1
    _assert_same(jp, jw, tp, tw, rows)
    assert tp.instance_results[0]["fitness"] > 0.8
    np.testing.assert_allclose(tw[0][:3, :3], np.eye(3), atol=0.02)
    np.testing.assert_allclose(tw[0][:3, 3], 0.0, atol=0.01)


def test_package_exports_match_jax():
    """The package exports the JAX package's names (register_pair_multiscale
    included), and its ops package those of tpu3d.ops that the port has:
    the version, the pipeline config and its loader, and prepare_cloud:
    the downsample and
    the normals of JAX's, and FPFH as the port's own downsample and
    prepare_features give it (the descriptors' parity with JAX's is
    tests/test_torch_prepare.py's)."""
    import tpu3d
    import tpu3d_torch
    from bench import make_pair
    from tpu3d.types import PointCloud as JaxCloud

    assert tpu3d_torch.__version__ == tpu3d.__version__ == "0.1.0"
    import tpu3d.ops
    import tpu3d_torch.ops

    assert set(tpu3d.__all__) == set(tpu3d_torch.__all__)
    # Not in the port: the TPU's NN entry points (K5 is
    # ops.nn.nearest_neighbor), and deproject, whose name would hide its
    # module.
    assert set(tpu3d.ops.__all__) - set(tpu3d_torch.ops.__all__) == {
        "nearest_neighbor_pallas", "nearest_neighbor_xla", "deproject"}
    import tpu3d.parallel
    import tpu3d_torch.parallel

    assert tpu3d_torch.parallel.__all__ == tpu3d.parallel.__all__
    _configs_equal(tpu3d_torch.PipelineConfig(), tpu3d.PipelineConfig())
    _configs_equal(tpu3d_torch.load_config("config/pipeline_config.yaml"),
                   tpu3d.load_config("config/pipeline_config.yaml"))
    pts, _, _, _ = make_pair(1200, seed=3, voxel=0.005)
    c, f = tpu3d_torch.prepare_cloud(
        tpu3d_torch.PointCloud.from_numpy(pts, device="cpu"),
        tpu3d_torch.RegistrationConfig(voxel_size=0.005))
    jc, jf = tpu3d.prepare_cloud(JaxCloud.from_numpy(pts),
                                 tpu3d.RegistrationConfig(voxel_size=0.005))
    np.testing.assert_array_equal(c.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_allclose(c.points.numpy(), np.asarray(jc.points),
                               atol=1e-6)
    m = c.mask.numpy()
    assert int(m.sum()) > 100
    cos = np.abs((c.normals.numpy() * np.asarray(jc.normals)).sum(1))[m]
    assert cos.min() >= 0.9999
    reg = tpu3d_torch.registration
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=0.005)
    _, f2 = reg.prepare_features(reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(pts, device="cpu"), cfg), cfg)
    assert torch.equal(f.descriptors, f2.descriptors)
    assert jf.descriptors.shape == f.descriptors.shape


def test_batched_masks_match_jax(bumpy):
    """Three masks in one capacity bucket register as one batch, each at
    JAX's pose (a crop of the reference: the identity)."""

    def setup(cfg):
        cfg = _bumpy_setup(bumpy, ransac_max_iterations=2000,
                           icp_max_iterations=30, max_points=8192)(cfg)
        cfg.segmentation.apply_mask = True
        cfg.segmentation.masks_input_dir = bumpy["masks"]
        return cfg

    jp, jw, tp, tw, rows = _run_both(setup, bumpy["K"])
    assert tp._batched_groups == 1 and len(tp.instance_results) == 3
    assert tp._degraded == 0
    _assert_same(jp, jw, tp, tw, rows)
    for res in tp.instance_results:
        assert res["fitness"] > 0.7, res
        np.testing.assert_allclose(res["T_world_object"][:3, :3], np.eye(3),
                                   atol=0.05)


def test_ply_round_trip(bumpy):
    pts, cols = load_ply(bumpy["ply"])
    ref_pts, ref_cols = jax_load_ply(bumpy["ply"])
    np.testing.assert_array_equal(pts, ref_pts)
    assert cols is None and ref_cols is None
    np.testing.assert_allclose(pts, bumpy["pts"], rtol=1e-6)


def _configs_equal(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    np.testing.assert_array_equal(da.pop("camera_extrinsics"),
                                  db.pop("camera_extrinsics"))
    assert da == db


YAMLS = {
    "every section": (
        "camera:\n  width: 640\n  height: 480\n  ip: '10.0.0.2'\n"
        "depth:\n  scale_to_meters: 4000\n  clipping_max: 2.5\n"
        "  bilateral_filter: true\n  bilateral_sigma_spatial: 3.0\n"
        "registration:\n  voxel_size: 0.004\n  ransac_seed: 7\n"
        "  two_stage: off\n  prepare_mode: sparse\n"
        "  sparse_escalate_fitness: 0.5\n"
        "parallel:\n  mode: on\n  devices: 2\n"
        "robot:\n  ip: 1.2.3.4\n  approach_offset_z: -0.2\n"
        "segmentation:\n  masks_input_dir: /m\n  apply_mask: false\n"
        "dummy_data:\n  rgb_path: a.png\n  depth_path: b.png\n"
        "use_camera: false\nuse_robot: false\nnum_threads: 3\n"
        "use_gpu: false\nvisualization: none\n"
        "camera_extrinsics: [1, 0, 0, 0.5, 0, 1, 0, 0, 0, 0, 1, 0,"
        " 0, 0, 0, 1]\n"
    ),
    "empty": "",
    "malformed": "camera: [1, 2\n",
    "bad value": "registration:\n  voxel_size: fine\n",
}


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_load_config_matches_jax(tmp_path, name):
    path = tmp_path / "cfg.yaml"
    path.write_text(YAMLS[name])
    _configs_equal(load_config(str(path)), jax_load_config(str(path)))


def test_load_config_of_the_repository_matches_jax():
    cfg = load_config("config/pipeline_config.yaml")
    _configs_equal(cfg, jax_load_config("config/pipeline_config.yaml"))
    # The loader never reads sparse_escalate_fitness, as in the JAX
    # package: a file that sets it keeps the default.
    assert cfg.registration.sparse_escalate_fitness == "auto"
    _configs_equal(load_config(None), jax_load_config(None))
    _configs_equal(load_config("no/such/file.yaml"),
                   jax_load_config("no/such/file.yaml"))


def test_cli_main(tmp_path, capsys):
    """``python -m tpu3d_torch <config>``: the argv contract and return
    code of ``python -m tpu3d`` (main.cpp:80-94), on the CPU."""
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(
        "camera:\n  width: 320\n  height: 240\n"
        "registration:\n  voxel_size: 0.005\n  ransac_max_iterations: 500\n"
        "  icp_max_iterations: 10\n"
        "use_camera: false\nuse_robot: false\nvisualization: \"none\"\n"
        "use_gpu: false\n"
    )
    assert main([str(cfg_path)]) == 0
    out = capsys.readouterr().out
    assert "Config loaded from" in out and "accelerator=off" in out
    assert "Computed 1 pick poses." in out and "Pipeline complete" in out


def test_demo_contract_save_load_and_host_retry(tmp_path, monkeypatch):
    """The planar demo: one waypoint; its results saved and loaded back;
    and, with the state on the CPU, an ICP that raises is retried there
    with the same result."""
    pipe = Pipeline(_port_config(lambda c: c), sleep_fn=lambda s: None)
    waypoints = pipe.run()
    assert len(waypoints) == 1 and waypoints[0].shape == (4, 4)
    res = pipe.instance_results[0]
    assert 0.0 <= res["fitness"] <= 1.0 and np.isfinite(res["rmse"])
    path = str(tmp_path / "run.npz")
    pipe.save_results(path)
    out = Pipeline.load_results(path)
    assert out["waypoints"].shape == (1, 4, 4) and out["fitness"].shape == (1,)
    np.testing.assert_allclose(out["waypoints"][0], waypoints[0])

    retry = Pipeline(_port_config(lambda c: c), sleep_fn=lambda s: None)
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("injected accelerator fault")

    monkeypatch.setattr(retry, "_icp_accel", boom)
    again = retry.run()
    assert calls and retry._host_icp_retries == 1 and retry._degraded == 0
    np.testing.assert_array_equal(again[0], waypoints[0])


def test_card_icp_fault_degrades(monkeypatch):
    """With the state on the card a failed ICP is not retried on the plain
    versions: the instance takes the degrade branch."""
    pipe = Pipeline(_demo(PipelineConfig()), sleep_fn=lambda s: None)
    assert pipe.device.type == "cuda"
    coarse = RegistrationResult(torch.eye(4), torch.tensor(0.5),
                                torch.tensor(0.01))
    monkeypatch.setattr(pipe, "_ransac", lambda *a: coarse)

    def boom(*a, **k):
        raise RuntimeError("injected kernel fault")

    monkeypatch.setattr(pipe, "_icp_accel", boom)
    monkeypatch.setattr(pipe, "_icp", boom)
    assert pipe._register_instance_inner(None, object(), None, None, 0,
                                         0.0) is None
    assert pipe._host_icp_retries == 0 and pipe._degraded == 1
    assert pipe.instance_results == []


def test_dedup_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        poses = []
        for _ in range(rng.integers(0, 8)):
            T = np.eye(4, dtype=np.float32)
            T[:3, 3] = rng.uniform(-0.2, 0.2, 3)
            poses.append(T)
        got, ref = filter_duplicates(poses, 0.1), jax_dedup(poses, 0.1)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_device_follows_use_gpu(capsys):
    """State goes on the card unless the config says ``use_gpu: false``;
    a ``parallel:`` block builds its mesh over the devices of that type
    (one CPU device: single-device, as JAX's 'on' with one device)."""
    cfg = _demo(PipelineConfig())
    assert Pipeline(cfg).device.type == "cuda"
    cfg.use_gpu = False
    assert Pipeline(cfg).device.type == "cpu"
    cfg.parallel.mode = "on"
    pipe = Pipeline(cfg)
    assert pipe._mesh is None
    assert "only one device is visible" in capsys.readouterr().out


# ------------------------------------------- the reference model between runs

def _write_model(path, pts):
    """The model as an ASCII PLY of fixed-width rows, so that a rewrite with
    as many points keeps the file's size."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        f.write(("%+.6f %+.6f %+.6f\n" * len(pts))
                % tuple(pts.astype(np.float64).ravel().tolist()))


def _counted_loads(monkeypatch):
    """The paths ``Pipeline.run()`` reads a model from, one per call."""
    from tpu3d_torch.pipeline import pipeline as pl

    paths = []
    load = pl.load_ply

    def counted(path):
        paths.append(path)
        return load(path)

    monkeypatch.setattr(pl, "load_ply", counted)
    return paths


def _run(pipe, K):
    """(waypoints, instance_results) of one ``run()``."""
    pipe._forced_K = K
    return pipe.run(), pipe.instance_results


def _fresh(cfg, K):
    return _run(Pipeline(cfg, sleep_fn=lambda s: None), K)


def _assert_bitwise(a, b):
    (wa, ra), (wb, rb) = a, b
    assert len(wa) == len(wb) >= 1 and len(ra) == len(rb) >= 1
    for x, y in zip(wa, wb):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def _model_config(fx, tmp_path):
    """The bumpy frame with one 100 px instance and the model at
    ``tmp_path/ref.ply``, written from the frame's points."""
    cfg = _port_config(_bumpy_setup(fx))
    cfg.reference_model_path = str(tmp_path / "ref.ply")
    _write_model(cfg.reference_model_path, fx["pts"])
    masks = tmp_path / "masks"
    masks.mkdir()
    m = np.zeros(cv2.imread(fx["depth"], cv2.IMREAD_UNCHANGED).shape,
                 np.uint8)
    m[20:120, 10:110] = 255
    cv2.imwrite(str(masks / "mask_0.png"), m)
    cfg.segmentation.masks_input_dir = str(masks)
    cfg.segmentation.apply_mask = True
    return cfg


def test_reference_model_kept_between_runs(bumpy, tmp_path, monkeypatch):
    """A second run on one Pipeline reuses the downsampled model: one read
    of the file, the model's normals and FPFH prepared from the kept cloud
    on both runs, and both runs bit for bit equal to a fresh Pipeline's."""
    from tpu3d_torch.pipeline import pipeline as pl

    loads = _counted_loads(monkeypatch)
    prepared = []
    prepare = pl.prepare_features

    def counted(down, *a, **k):
        prepared.append(down)
        return prepare(down, *a, **k)

    monkeypatch.setattr(pl, "prepare_features", counted)
    cfg = _model_config(bumpy, tmp_path)
    ply = cfg.reference_model_path
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    first = _run(pipe, bumpy["K"])
    second = _run(pipe, bumpy["K"])
    assert loads == [ply]
    assert sum(down is pipe._reference[1] for down in prepared) == 2
    assert pipe._degraded == 0 and first[1][0]["fitness"] > 0.8
    _assert_bitwise(first, second)
    _assert_bitwise(second, _fresh(cfg, bumpy["K"]))


SHIFT = np.array([0.016, -0.008, 0.0], np.float32)  # whole voxels


@pytest.mark.parametrize("change", ["other_size", "same_size", "voxel_size"])
def test_changed_model_or_setting_reloads(bumpy, tmp_path, monkeypatch,
                                          change):
    """A rewritten model file (new content of another size; the same size
    with its mtime moved) or a changed registration setting reloads the
    model, and the run equals a fresh Pipeline's on the new file or
    setting."""
    loads = _counted_loads(monkeypatch)
    cfg = _model_config(bumpy, tmp_path)
    ply = cfg.reference_model_path
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    before = _run(pipe, bumpy["K"])
    st = os.stat(ply)
    if change == "voxel_size":
        cfg.registration.voxel_size = 0.01
    else:
        pts = bumpy["pts"] + SHIFT
        if change == "other_size":
            pts = pts[:-500]
        _write_model(ply, pts)
        assert (os.stat(ply).st_size == st.st_size) == (change == "same_size")
        if change == "same_size":
            os.utime(ply, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    after = _run(pipe, bumpy["K"])
    assert loads == [ply] * 2
    assert pipe._degraded == 0
    _assert_bitwise(after, _fresh(cfg, bumpy["K"]))
    if change != "voxel_size":  # the pose follows the moved model
        np.testing.assert_allclose(after[0][0][:3, 3],
                                   before[0][0][:3, 3] - SHIFT, atol=0.002)


def test_procedural_model_builds_every_run(monkeypatch):
    """With no model file the procedural grid is built on every run, as
    before, and nothing is kept."""
    from tpu3d_torch.pipeline import pipeline as pl

    loads = _counted_loads(monkeypatch)
    grids = []
    grid = pl.generate_reference_grid

    def counted(*a, **k):
        grids.append(1)
        return grid(*a, **k)

    monkeypatch.setattr(pl, "generate_reference_grid", counted)
    pipe = Pipeline(_port_config(lambda c: c), sleep_fn=lambda s: None)
    first = _run(pipe, None)
    second = _run(pipe, None)
    assert len(grids) == 2 and loads == [] and pipe._reference is None
    _assert_bitwise(first, second)
