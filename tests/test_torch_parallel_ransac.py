"""Sharded RANSAC parity: ``tpu3d_torch.parallel.ransac_sharded`` on an
8-shard CPU mesh against ``tpu3d.parallel.ransac_sharded`` on JAX's 8
virtual host devices, on the same features (the JAX package's, made from
a seeded numpy scene) with the JAX (round, shard) draw stream replayed:
the same correspondences, the same consumed ids (the round count) and
the same winner (pose within 1e-6, equal fitness), for the rotation and
the gather samplers; and ``test_ransac_sharded_ab.py``'s cost profile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ransac import JaxDraws
from tpu3d.ops.fpfh import compute_fpfh
from tpu3d.ops.normals import estimate_normals
from tpu3d.parallel import make_mesh as jax_make_mesh
from tpu3d.parallel.ransac_sharded import (
    feature_correspondences_sharded as jax_corr_sharded,
    ransac_registration_sharded as jax_ransac_sharded,
)
from tpu3d.types import PointCloud as JaxCloud
from tpu3d_torch.parallel import make_mesh
from tpu3d_torch.parallel.ransac_sharded import (
    feature_correspondences_sharded,
    ransac_registration_sharded,
)
from tpu3d_torch.types import FPFHFeatures, PointCloud
from torch_threads import one_torch_thread  # noqa: F401

VOXEL = 0.004
N = 4096  # rotation sampling and the estimate rescore on both sides


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (conftest default)")
    return jax_make_mesh(("shard",)), make_mesh(devices=["cpu"] * 8)


def _scene(seed, far=False):
    """``test_ransac_sharded_ab.py``'s scene (or an unrelated source),
    prepared by the JAX package."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.15, 0.15, size=(N, 2)).astype(np.float32)
    z = 0.7 + 0.02 * np.sin(55 * xy[:, 0]) * np.cos(45 * xy[:, 1])
    tgt_pts = np.column_stack([xy, z]).astype(np.float32)
    aa = rng.uniform(-0.06, 0.06, size=3)
    th = float(np.linalg.norm(aa))
    k = aa / max(th, 1e-12)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(
        np.float32)
    t = rng.uniform(-0.012, 0.012, size=3).astype(np.float32)
    src_pts = ((tgt_pts - t) @ R).astype(np.float32)
    if far:
        src_pts = np.random.default_rng(99).uniform(
            2.0, 3.0, size=(N, 3)).astype(np.float32)
    tgt = estimate_normals(JaxCloud.from_numpy(tgt_pts, capacity=N), k=15)
    src = estimate_normals(JaxCloud.from_numpy(src_pts, capacity=N), k=15)
    tf = compute_fpfh(tgt, jnp.float32(VOXEL * 5))
    sf = compute_fpfh(src, jnp.float32(VOXEL * 5))
    return src, tgt, sf, tf


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(src, tgt, sf, tf):
    cloud = [PointCloud(points=_t(c.points), mask=_t(c.mask))
             for c in (src, tgt)]
    feat = [FPFHFeatures(descriptors=_t(f.descriptors), mask=_t(f.mask))
            for f in (sf, tf)]
    return cloud + feat


@pytest.fixture(scope="module")
def scene0():
    return _scene(0)


def test_sharded_correspondences_match_jax(scene0, meshes):
    jmesh, tmesh = meshes
    src, tgt, sf, tf = scene0
    _, _, tsf, ttf = _port(*scene0)
    got = feature_correspondences_sharded(tsf, ttf, tmesh)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_corr_sharded(sf, tf, jmesh)))


@pytest.mark.parametrize("sampling,iters,confidence", [
    ("auto", 100000, 0.99),  # rotation table, ends in round 1
    ("auto", 16384, 0.999),  # rotation table, the whole budget
    ("gather", 16384, 0.999),  # gather draws
])
def test_sharded_ransac_replays_jax(scene0, meshes, sampling, iters,
                                    confidence):
    jmesh, tmesh = meshes
    ref, ref_cons = jax_ransac_sharded(
        *scene0, VOXEL, mesh=jmesh, max_iterations=iters,
        confidence=confidence, sampling=sampling, return_consumed=True)
    got, cons = ransac_registration_sharded(
        *_port(*scene0), VOXEL, tmesh, max_iterations=iters,
        confidence=confidence, sampling=sampling, return_consumed=True,
        draws=JaxDraws(42))
    assert cons == int(ref_cons)
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-6)
    assert float(got.fitness) == float(ref.fitness)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-5)
    assert float(got.fitness) > 0.8


def test_sharded_cost_profile(scene0, meshes):
    """``test_ransac_sharded_ab.py``'s gate on the port's own draws: the
    easy scene stops after one round (25,600 ids at a 100k budget), an
    unrelated source spends the whole budget."""
    _, tmesh = meshes
    _, cons = ransac_registration_sharded(
        *_port(*scene0), VOXEL, tmesh, max_iterations=100000,
        confidence=0.99, return_consumed=True)
    assert cons == 25600
    _, cons_far = ransac_registration_sharded(
        *_port(*_scene(0, far=True)), VOXEL, tmesh, max_iterations=100000,
        return_consumed=True)
    assert cons_far == 100000
