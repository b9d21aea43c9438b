"""End-to-end port parity: ``tpu3d_torch.register_pair`` against the JAX
``register_pair`` on the bench fixture, with the JAX draw stream replayed,
on the reference-parity route and on the sparse arm (with its escalation),
and the ``mesh`` argument's routing."""

import numpy as np
import pytest
import torch

import tpu3d
import tpu3d_torch
from bench import make_pair
from test_torch_ransac import JaxDraws
from torch_threads import one_torch_thread  # noqa: F401

VOXEL = 0.005


def _gate(T, R, t):
    """bench.py's quality gate."""
    return (np.abs(T[:3, :3] - R).max() < 0.02
            and np.abs(T[:3, 3] - t).max() < 0.005)


@pytest.mark.parametrize("n,capacity", [(4096, 4096), (2048, 2048)])
def test_register_pair_matches_jax(n, capacity):
    src, tgt, R, t = make_pair(n, voxel=VOXEL)
    iters = 30000
    ref, ref_coarse = tpu3d.register_pair(
        tpu3d.PointCloud.from_numpy(src), tpu3d.PointCloud.from_numpy(tgt),
        tpu3d.RegistrationConfig(voxel_size=VOXEL,
                                 ransac_max_iterations=iters),
    )
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL,
                                         ransac_max_iterations=iters)
    s = tpu3d_torch.PointCloud.from_numpy(src, device="cpu")
    d = tpu3d_torch.registration.downsample_bucketed(s, cfg)
    assert d.capacity == capacity
    got, coarse = tpu3d_torch.register_pair(
        s, tpu3d_torch.PointCloud.from_numpy(tgt, device="cpu"), cfg,
        draws=JaxDraws(cfg.ransac_seed),
    )
    T = got.transformation.numpy()
    T_ref = np.asarray(ref.transformation)
    assert np.isfinite(T).all() and T.shape == (4, 4)
    np.testing.assert_allclose(T, T_ref, atol=1e-4)
    assert abs(float(got.fitness) - float(ref.fitness)) <= 0.005
    # Descriptors agree to ~1e-6, which reorders a few near-tied
    # correspondences, so the coarse winner may differ; ICP converges to
    # the same pose from either.
    assert float(coarse.fitness) > 0.3 and float(ref_coarse.fitness) > 0.3
    assert _gate(T, R, t) and _gate(T_ref, R, t)


def test_register_pair_sparse_arm_matches_jax():
    """prepare_mode='sparse': dense fused target, sparse source subset,
    RANSAC on the subset view, ICP from the downsampled source."""
    src, tgt, R, t = make_pair(4096, voxel=VOXEL)
    iters = 30000
    ref, _ = tpu3d.register_pair(
        tpu3d.PointCloud.from_numpy(src), tpu3d.PointCloud.from_numpy(tgt),
        tpu3d.RegistrationConfig(voxel_size=VOXEL, prepare_mode="sparse",
                                 ransac_max_iterations=iters),
    )
    cfg = tpu3d_torch.RegistrationConfig(
        voxel_size=VOXEL, prepare_mode="sparse", ransac_max_iterations=iters)
    got, coarse = tpu3d_torch.register_pair(
        tpu3d_torch.PointCloud.from_numpy(src, device="cpu"),
        tpu3d_torch.PointCloud.from_numpy(tgt, device="cpu"), cfg,
        draws=JaxDraws(cfg.ransac_seed),
    )
    T = got.transformation.numpy()
    T_ref = np.asarray(ref.transformation)
    np.testing.assert_allclose(T, T_ref, atol=1e-4)
    assert abs(float(got.fitness) - float(ref.fitness)) <= 0.005
    assert float(coarse.fitness) > 0.3
    assert _gate(T, R, t) and _gate(T_ref, R, t)


@pytest.fixture(scope="module")
def sparse_inputs():
    """Downsampled pair, the target's dense fused prepare in both
    packages."""
    from tpu3d.ops.fused_features import fused_prepare_features as jax_dense
    from tpu3d.registration import downsample_bucketed as jax_down

    src, tgt, R, t = make_pair(4096, voxel=VOXEL)
    jcfg = tpu3d.RegistrationConfig(voxel_size=VOXEL)
    js = jax_down(tpu3d.PointCloud.from_numpy(src), jcfg)
    jt, jtf = jax_dense(jax_down(tpu3d.PointCloud.from_numpy(tgt), jcfg),
                        np.float32(VOXEL * 5), engine="pallas",
                        interpret=True)
    reg = tpu3d_torch.registration
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL)
    ts = reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(src, device="cpu"), cfg)
    tt, ttf = reg.prepare_features(reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(tgt, device="cpu"), cfg), cfg,
        "fused")
    return (js, jt, jtf), (ts, tt, ttf), R, t


@pytest.mark.parametrize("escalate_below", [0.0, 2.0])
def test_sparse_register_escalated_matches_jax(sparse_inputs, escalate_below,
                                               monkeypatch):
    """0.0 never escalates; 2.0 always re-runs the dense arm, whose result
    is kept only when its fitness is higher (here it is not, in either
    package)."""
    from tpu3d.registration import sparse_register_escalated as jax_arm

    reg = tpu3d_torch.registration
    dense_calls = []

    def counted(*a, **k):
        dense_calls.append(1)
        return fused_prepare_features(*a, **k)

    fused_prepare_features = reg.fused_prepare_features
    monkeypatch.setattr(reg, "fused_prepare_features", counted)
    (js, jt, jtf), (ts, tt, ttf), R, t = sparse_inputs
    common = dict(voxel=VOXEL, radius=np.float32(VOXEL * 5),
                  max_iterations=30000, icp_max_iterations=30, seed=3,
                  escalate_below=escalate_below)
    ref, _, ref_esc = jax_arm(js, jt, jtf, interpret=True, **common)
    got, _, esc = reg.sparse_register_escalated(ts, tt, ttf,
                                                draws=JaxDraws(3), **common)
    assert len(dense_calls) == (escalate_below > 0)
    assert esc == ref_esc is False
    T = got.transformation.numpy()
    np.testing.assert_allclose(T, np.asarray(ref.transformation), atol=1e-4)
    assert abs(float(got.fitness) - float(ref.fitness)) <= 0.005
    assert _gate(T, R, t) and float(got.fitness) > 0.8


def test_unported_routes_raise():
    src, tgt, _, _ = make_pair(600, voxel=VOXEL)
    s = tpu3d_torch.PointCloud.from_numpy(src, device="cpu")
    g = tpu3d_torch.PointCloud.from_numpy(tgt, device="cpu")
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL)
    # Every route is ported: a mesh of one device is the single-device
    # path, one of two the sharded stack (tests/test_torch_parallel_*.py).
    from tpu3d_torch.parallel import make_mesh

    one, _ = tpu3d_torch.register_pair(s, g, cfg,
                                       mesh=make_mesh(devices=["cpu"]))
    ref, _ = tpu3d_torch.register_pair(s, g, cfg)
    assert torch.equal(one.transformation, ref.transformation)
    two, _ = tpu3d_torch.register_pair(s, g, cfg,
                                       mesh=make_mesh(devices=["cpu"] * 2))
    assert torch.isfinite(two.transformation).all()
    # An explicit neighbour mode of the gather route is ported: it returns
    # normals and descriptors for every row.
    down = tpu3d_torch.registration.downsample_bucketed(s, cfg)
    pd, feats = tpu3d_torch.registration.prepare_features(down, cfg, "slab")
    assert pd.normals.shape == (down.capacity, 3)
    assert feats.descriptors.shape == (down.capacity, 33)
    # The sparse arm is automatic only where the source lies on a card.
    big = tpu3d_torch.PointCloud(points=s.points.repeat(64, 1),
                                 mask=s.mask.repeat(64))
    assert big.capacity >= 2 * 8192
    reg = tpu3d_torch.registration
    assert not reg.sparse_prepare_active(cfg, "fused", big)
    assert reg.sparse_prepare_active(
        tpu3d_torch.RegistrationConfig(prepare_mode="sparse"), "auto", s)


@pytest.mark.parametrize("n,seed,voxel", [(600, 0, 0.005), (5000, 3, 0.002)])
def test_fixture_copy_equals_bench(n, seed, voxel):
    """The port's own ``make_pair`` (used by ``chip_smoke.py``) is the bench
    fixture, value for value."""
    from tpu3d_torch.models.fixtures import make_pair as port_make_pair

    for a, b in zip(port_make_pair(n, seed, voxel), make_pair(n, seed, voxel)):
        np.testing.assert_array_equal(a, b)
