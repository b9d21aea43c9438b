"""The port's multi-device routing (``test_register_sharded.py``'s cases)
on 8-shard CPU meshes: mesh resolution, padding, the YAML block,
``register_pair(mesh=)``, the pipeline from a ``parallel:`` block with
its counter, and the sharded sparse-arm escalation; and
``icp_refine_sharded`` against the JAX package's on its 8 virtual host
devices for each ``nn_mode``: poses within 1e-6 for the walk and the
slab, whose d² is the plain difference; 1e-5 for 'brute', as the
single-device ICP tests hold it, whose K5 d² is the norm expansion (its
~5e-8 rounding differs between XLA and PyTorch and moves the loop's
|Δrmse| < 1e-6 stop by an iteration)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.ops.normals import estimate_normals as jax_normals
from tpu3d.parallel import make_mesh as jax_make_mesh
from tpu3d.parallel.icp_sharded import icp_refine_sharded as jax_icp
from tpu3d.types import PointCloud as JaxCloud
from tpu3d_torch.config import (
    ParallelConfig,
    PipelineConfig,
    RegistrationConfig,
)
from tpu3d_torch.parallel import make_mesh
from tpu3d_torch.parallel.icp_sharded import icp_refine_sharded
from tpu3d_torch.parallel.mesh import see_first_device
from tpu3d_torch.parallel.register_sharded import (
    pad_cloud_to_multiple,
    parallel_mesh,
    register_pair_sharded,
)
from tpu3d_torch.registration import register_pair
from tpu3d_torch.types import PointCloud
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def cpu8():
    """``visible_devices('cpu')`` sees the CPU 8 times."""
    see_first_device(8, "cpu")
    yield make_mesh(devices=["cpu"] * 8)
    see_first_device(0, "cpu")


def _pair(n, seed=0, voxel=0.004):
    """``test_register_sharded.py``'s bumpy pair with a known pose."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.15, 0.15, size=(n, 2)).astype(np.float32)
    r5 = 5.0 * voxel
    w1, w2 = 1.2 / r5, 0.45 / r5
    z = (0.7
         + 2.5 * voxel * np.sin(w1 * xy[:, 0]) * np.cos(0.8 * w1 * xy[:, 1])
         + 6.0 * voxel * np.cos(w2 * xy[:, 0]) * np.cos(1.1 * w2 * xy[:, 1]))
    tgt = np.column_stack([xy, z]).astype(np.float32)
    aa = np.array([0.12, -0.08, 0.15])
    th = np.linalg.norm(aa)
    k = aa / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(
        np.float32)
    t = np.array([0.02, -0.01, 0.015], np.float32)
    return ((tgt - t) @ R).astype(np.float32), tgt, R, t


def _cloud(pts, **kw):
    return PointCloud.from_numpy(pts, device="cpu", **kw)


def test_parallel_mesh_resolution(cpu8, capsys):
    assert parallel_mesh(None, "cpu") is None
    assert parallel_mesh(ParallelConfig(mode="off"), "cpu") is None
    m = parallel_mesh(ParallelConfig(mode="on"), "cpu")
    assert m is not None and m.devices.size == 8
    m4 = parallel_mesh(ParallelConfig(mode="on", devices=4), "cpu")
    assert m4.devices.size == 4
    assert parallel_mesh(ParallelConfig(mode="auto"), "cpu") is not None
    see_first_device(0, "cpu")  # one CPU device: single-device
    assert parallel_mesh(ParallelConfig(mode="auto"), "cpu") is None
    assert parallel_mesh(ParallelConfig(mode="on"), "cpu") is None
    assert "only one device is visible" in capsys.readouterr().out


def test_pad_cloud_to_multiple():
    c = _cloud(np.random.default_rng(1).random((100, 3)).astype(np.float32))
    assert c.capacity == 128
    padded, _ = pad_cloud_to_multiple(c, None, 3)
    assert padded.capacity % 3 == 0 and padded.count() == 100
    assert (padded.points[128:] == 3e4).all()
    same, _ = pad_cloud_to_multiple(c, None, 8)
    assert same.capacity == 128 and same.points is c.points


def test_register_pair_mesh_matches_single_device(cpu8):
    """``register_pair(mesh=)`` recovers the single-device pose (RANSAC
    streams differ, so the gate is the ICP-converged pose); a 1-device
    mesh takes the single-device path."""
    src_np, tgt_np, R, t = _pair(3000)
    src, tgt = _cloud(src_np), _cloud(tgt_np)
    cfg = RegistrationConfig(voxel_size=0.004, ransac_max_iterations=4000,
                             icp_max_iterations=40)
    ref1, _ = register_pair(src, tgt, cfg)
    refN, coarseN = register_pair(src, tgt, cfg, mesh=cpu8)
    T1 = ref1.transformation.numpy()
    TN = refN.transformation.numpy()
    np.testing.assert_allclose(TN[:3, :3], R, atol=5e-3)
    np.testing.assert_allclose(TN[:3, 3], t, atol=2e-3)
    np.testing.assert_allclose(TN, T1, atol=5e-3)
    assert float(refN.fitness) > 0.9 and float(coarseN.fitness) > 0.25
    one, _ = register_pair(src, tgt, cfg, mesh=make_mesh(devices=["cpu"]))
    assert torch.equal(one.transformation, ref1.transformation)


def test_register_pair_sharded_defaults_build_mesh(cpu8):
    src_np, tgt_np, R, t = _pair(1500, seed=3)
    cfg = RegistrationConfig(voxel_size=0.005, ransac_max_iterations=2000,
                             icp_max_iterations=30)
    refined, _, info = register_pair_sharded(_cloud(src_np), _cloud(tgt_np),
                                             cfg, return_info=True)
    assert info["n_shards"] == 8 and info["mode"] == "auto"
    np.testing.assert_allclose(refined.transformation.numpy()[:3, 3], t,
                               atol=3e-3)


def _pipeline_cfg():
    cfg = PipelineConfig()
    cfg.use_camera = False
    cfg.use_robot = False
    cfg.use_gpu = False
    cfg.visualization = "none"
    cfg.parallel.mode = "on"
    return cfg


def test_pipeline_parallel_from_config(cpu8):
    from tpu3d_torch.pipeline.pipeline import Pipeline

    cfg = _pipeline_cfg()
    cfg.camera.width = 320
    cfg.camera.height = 240
    cfg.registration.voxel_size = 0.005
    cfg.registration.ransac_max_iterations = 2000
    cfg.registration.icp_max_iterations = 30
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    assert pipe._mesh is not None and pipe._mesh.devices.size == 8
    waypoints = pipe.run()
    assert len(waypoints) == 1
    assert pipe._sharded_registrations == 1
    assert 0.0 <= pipe.instance_results[0]["fitness"] <= 1.0


def test_pipeline_parallel_keeps_the_model(cpu8, tmp_path, monkeypatch):
    """With a mesh, a second run reuses the model read from its file (one
    read) and poses it bit for bit as a fresh Pipeline does."""
    from tpu3d_torch.models.ply import save_ply
    from tpu3d_torch.models.procedural import generate_reference_grid
    from tpu3d_torch.pipeline import pipeline as pl

    loads = []
    load = pl.load_ply
    monkeypatch.setattr(pl, "load_ply",
                        lambda path: loads.append(path) or load(path))
    cfg = _pipeline_cfg()
    cfg.camera.width = 320
    cfg.camera.height = 240
    cfg.registration.voxel_size = 0.005
    cfg.registration.ransac_max_iterations = 2000
    cfg.registration.icp_max_iterations = 30
    cfg.reference_model_path = str(tmp_path / "model.ply")
    save_ply(cfg.reference_model_path, generate_reference_grid()[0])
    pipe = pl.Pipeline(cfg, sleep_fn=lambda s: None)
    runs = [pipe.run(), pipe.run(),
            pl.Pipeline(cfg, sleep_fn=lambda s: None).run()]
    assert pipe._mesh is not None and pipe._sharded_registrations == 2
    assert len(loads) == 2  # the first Pipeline's run and the fresh one's
    for later in runs[1:]:
        assert len(later) == len(runs[0]) == 1
        np.testing.assert_array_equal(later[0], runs[0][0])


def test_pipeline_sharded_sparse_escalation(cpu8, capsys):
    import time

    from tpu3d_torch.pipeline.pipeline import Pipeline
    from tpu3d_torch.registration import downsample_bucketed, prepare_features

    rng = np.random.default_rng(7)
    xy = rng.uniform(-0.1, 0.1, size=(4000, 2)).astype(np.float32)
    z = 0.01 * np.sin(40 * xy[:, :1]) * np.cos(40 * xy[:, 1:2])
    pts = np.concatenate([xy, z], axis=1).astype(np.float32)
    cfg = _pipeline_cfg()
    cfg.registration.voxel_size = 0.004
    cfg.registration.prepare_mode = "sparse"
    cfg.registration.sparse_escalate_fitness = 2.0  # always escalate
    cfg.registration.ransac_max_iterations = 2000
    cfg.registration.icp_max_iterations = 20
    pipe = Pipeline(cfg, sleep_fn=lambda s: None)
    assert pipe._mesh is not None
    pipe._neighbor_mode = "fused"
    down = downsample_bucketed(_cloud(pts), cfg.registration)
    ref_cloud, ref_features = prepare_features(down, cfg.registration,
                                               "fused")
    pose = pipe._register_instance_inner(down, None, ref_cloud, ref_features,
                                         0, time.perf_counter())
    assert pose is not None and np.all(np.isfinite(pose))
    assert "sparse sharded fitness" in capsys.readouterr().out
    assert pipe._sharded_registrations == 1
    T = pipe.instance_results[-1]["T_world_object"]
    np.testing.assert_allclose(T[:3, :3], np.eye(3), atol=0.05)


def test_parallel_yaml_block(tmp_path):
    from tpu3d_torch.config import load_config

    p = tmp_path / "cfg.yaml"
    p.write_text("parallel:\n  mode: auto\n  devices: 4\n  halo: 512\n"
                 "use_camera: false\n")
    cfg = load_config(str(p))
    assert (cfg.parallel.mode, cfg.parallel.devices,
            cfg.parallel.halo) == ("auto", 4, 512)
    assert PipelineConfig().parallel.mode == "off"


@pytest.mark.parametrize("nn_mode", ["slab2", "slab", "brute"])
@pytest.mark.parametrize("point_to_plane", [False, True])
def test_icp_sharded_matches_jax(nn_mode, point_to_plane):
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (conftest default)")
    rng = np.random.default_rng(42)
    xy = rng.uniform(-0.15, 0.15, size=(512, 2)).astype(np.float32)
    z = 0.7 + 0.1 * np.sin(9 * xy[:, 0]) * np.cos(7 * xy[:, 1])
    tgt_pts = np.column_stack([xy, z]).astype(np.float32)
    # Shifted and jittered: the loop converges to a residual well above
    # rounding, so both stop at the same iteration.
    src_pts = (tgt_pts + np.float32([0.004, -0.003, 0.005])
               + rng.normal(scale=5e-4, size=(512, 3))).astype(np.float32)
    jsrc = JaxCloud.from_numpy(src_pts, capacity=512)
    jtgt = jax_normals(JaxCloud.from_numpy(tgt_pts, capacity=512), k=15)
    ref = jax_icp(jsrc, jtgt, jnp.eye(4), 0.03, mesh=jax_make_mesh(),
                  max_iterations=15, point_to_plane=point_to_plane,
                  nn_mode=nn_mode)
    src = PointCloud(points=torch.from_numpy(src_pts),
                     mask=torch.ones(512, dtype=torch.bool))
    tgt = PointCloud(points=torch.from_numpy(tgt_pts),
                     mask=torch.ones(512, dtype=torch.bool),
                     normals=torch.from_numpy(np.array(jtgt.normals)))
    got = icp_refine_sharded(src, tgt, torch.eye(4), 0.03,
                             make_mesh(devices=["cpu"] * 8),
                             max_iterations=15,
                             point_to_plane=point_to_plane, nn_mode=nn_mode)
    brute = nn_mode == "brute"
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation),
                               atol=1e-5 if brute else 1e-6)
    np.testing.assert_allclose(float(got.fitness), float(ref.fitness),
                               atol=1e-6)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse),
                               rtol=1e-3 if brute else 1e-5)
    assert float(got.fitness) > 0.9
