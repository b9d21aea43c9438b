"""``register_pair_multiscale`` parity: the port against the JAX package on
the bench fixture (``make_pair(4096, voxel=0.005)``), with the JAX draw
stream replayed, at 1, 2 and 3 levels, point-to-plane and point-to-point.

Below 16,384 rows every level's descriptors and ICP-target normals come
from the brute self-kNN, whose d² is the matmul expansion: XLA and PyTorch
round its cancellation residue differently, and FPFH's self-pair gate
turns that into different descriptors (test_torch_neighbor_modes.py). The
parity test therefore hands the port JAX's neighbour search (held on its
own there) and holds what this function composes: the coarse prepare,
RANSAC (the same winner: pose within 1e-6, identical inlier count) and the
ICP levels (the refined pose within 1e-6, ROADMAP's rule). The port's own
search is held end to end by the quality gate and the JAX pose within
1e-4, as test_torch_register_pair.py holds register_pair."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu3d
import tpu3d_torch
from bench import make_pair
from test_torch_ransac import JaxDraws
from tpu3d.registration import surface_neighbors as jax_surface_neighbors
from torch_threads import one_torch_thread  # noqa: F401

VOXEL = 0.005


@pytest.fixture(scope="module")
def pair():
    return make_pair(4096, voxel=VOXEL)


def _jax_search(cloud, radius, k=100, mode="auto"):
    jc = tpu3d.PointCloud(points=jnp.asarray(cloud.points.numpy()),
                          mask=jnp.asarray(cloud.mask.numpy()))
    idx, d2 = jax_surface_neighbors(jc, np.float32(radius), k=k, mode=mode)
    return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(d2))


def _run(src, tgt, levels, point_to_plane):
    kw = dict(voxel_size=VOXEL, ransac_max_iterations=4096,
              icp_max_iterations=30, use_point_to_plane=point_to_plane)
    ref = tpu3d.register_pair_multiscale(
        tpu3d.PointCloud.from_numpy(src), tpu3d.PointCloud.from_numpy(tgt),
        tpu3d.RegistrationConfig(**kw), levels=levels)
    cfg = tpu3d_torch.RegistrationConfig(**kw)
    got = tpu3d_torch.register_pair_multiscale(
        tpu3d_torch.PointCloud.from_numpy(src, device="cpu"),
        tpu3d_torch.PointCloud.from_numpy(tgt, device="cpu"), cfg,
        levels=levels, draws=JaxDraws(cfg.ransac_seed))
    return ref, got


def _gate(T, R, t):
    """bench.py's quality gate."""
    return (np.abs(T[:3, :3] - R).max() < 0.02
            and np.abs(T[:3, 3] - t).max() < 0.005)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("point_to_plane", [True, False])
def test_multiscale_matches_jax(pair, levels, point_to_plane, monkeypatch):
    src, tgt, R, t = pair
    monkeypatch.setattr(tpu3d_torch.registration, "surface_neighbors",
                        _jax_search)
    (ref, ref_c), (got, got_c) = _run(src, tgt, levels, point_to_plane)
    np.testing.assert_allclose(got_c.transformation.numpy(),
                               np.asarray(ref_c.transformation), atol=1e-6)
    assert float(got_c.fitness) == float(ref_c.fitness) > 0.3
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-6)
    assert float(got.fitness) == float(ref.fitness)
    assert _gate(got.transformation.numpy(), R, t)


def test_multiscale_with_the_port_search(pair):
    """The port's own neighbour search end to end at two levels: through
    the quality gate, at JAX's refined pose within 1e-4."""
    src, tgt, R, t = pair
    (ref, _), (got, coarse) = _run(src, tgt, 2, True)
    T = got.transformation.numpy()
    np.testing.assert_allclose(T, np.asarray(ref.transformation), atol=1e-4)
    assert float(coarse.fitness) > 0.3 and _gate(T, R, t)


def test_multiscale_levels_and_targets(pair, monkeypatch):
    """Levels run coarsest first at voxel·step^i; each ICP level gets a
    normals-only target at its voxel (normals only for point-to-plane),
    the coarse ones a threshold of one voxel, the finest
    icp_distance_factor voxels; levels < 1 raise."""
    src, tgt, _, _ = pair
    reg = tpu3d_torch.registration
    seen = []
    real_target, real_icp = reg.prepare_icp_target, reg.icp_refine

    def target(cloud, cfg, with_normals=True):
        seen.append(("target", cfg.voxel_size, with_normals))
        return real_target(cloud, cfg, with_normals)

    def refine(s, tg, T, thr, **kw):
        seen.append(("icp", thr))
        return real_icp(s, tg, T, thr, **kw)

    monkeypatch.setattr(reg, "prepare_icp_target", target)
    monkeypatch.setattr(reg, "icp_refine", refine)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=VOXEL,
                                         ransac_max_iterations=2048,
                                         icp_max_iterations=5,
                                         use_point_to_plane=False)
    s = tpu3d_torch.PointCloud.from_numpy(src, device="cpu")
    g = tpu3d_torch.PointCloud.from_numpy(tgt, device="cpu")
    tpu3d_torch.register_pair_multiscale(s, g, cfg, levels=2,
                                         scale_step=2.0)
    assert seen == [("target", VOXEL * 2.0, False), ("icp", VOXEL * 2.0),
                    ("target", VOXEL, False),
                    ("icp", VOXEL * cfg.icp_distance_factor)]
    with pytest.raises(ValueError, match="levels"):
        tpu3d_torch.register_pair_multiscale(s, g, cfg, levels=0)
