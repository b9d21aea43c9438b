"""Sharded NN parity: ``tpu3d_torch.parallel.sharded_nn`` on an 8-shard CPU
mesh against ``tpu3d.parallel.sharded_nn`` on JAX's 8 virtual host devices
and against the port's single-device searches, on the same seeded numpy
inputs (``test_parallel.py``'s cases): brute K5 indices and d² equal to
the single-device ones (ties to the lowest global row, also across a shard
seam); the slab2 walk's in-radius indices and d² equal to the single
device's and JAX's, with degenerate x and at 16k rows; the legacy slab's
overflow flag."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.ops.neighbors import nearest_neighbor_xla
from tpu3d.parallel import make_mesh as jax_make_mesh
from tpu3d.parallel.sharded_nn import build_slab_sharded as jax_build_slab
from tpu3d.parallel.sharded_nn import build_walk_sharded as jax_build_walk
from tpu3d.parallel.sharded_nn import slab2_top1_sharded as jax_slab2
from tpu3d.parallel.sharded_nn import slab_top1_sharded as jax_slab
from tpu3d_torch.ops.nn import nearest_neighbor
from tpu3d_torch.ops.nn_walk import slab2_top1
from tpu3d_torch.ops.slab import build_slab, slab_top1
from tpu3d_torch.parallel import make_mesh
from tpu3d_torch.parallel.mesh import (
    ShardedRows,
    all_gather,
    axis_index,
    for_shards,
    ppermute,
    psum,
    row_sharded,
)
from tpu3d_torch.parallel.sharded_nn import (
    build_slab_sharded,
    build_walk_sharded,
    nearest_neighbor_sharded,
    slab2_top1_sharded,
    slab_top1_sharded,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (conftest default)")
    return jax_make_mesh(("shard",)), make_mesh(devices=["cpu"] * 8)


def _bumpy(rng, n):
    xy = rng.uniform(-0.15, 0.15, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.1 * np.sin(9 * xy[:, 0]) * np.cos(7 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_collectives():
    mesh = make_mesh(devices=["cpu"] * 4)
    x = torch.arange(8.0).reshape(8, 1)
    xs = row_sharded(mesh).put(x)
    assert isinstance(xs, ShardedRows) and xs.offsets == [0, 2, 4, 6]
    assert torch.equal(xs.gather(), x)
    assert for_shards(mesh, "shard", lambda a: (axis_index(), a.shape[0]),
                      xs) == [(s, 2) for s in range(4)]
    parts = [s[:, 0] for s in xs.shards]
    assert torch.equal(all_gather(parts), x.reshape(4, 2))
    assert torch.equal(psum(parts), torch.tensor([12.0, 16.0]))
    fwd = ppermute(parts, [(i, i + 1) for i in range(3)])
    assert torch.equal(fwd[0], torch.zeros(2))  # non-cyclic: zeros
    assert torch.equal(fwd[2], parts[1])
    mesh2 = make_mesh(("inst", "shard"), shape=(2, 2), devices=["cpu"] * 4)
    assert mesh2.shape == {"inst": 2, "shard": 2}
    assert mesh2.take("inst", 1).shape == {"shard": 2}
    with pytest.raises(ValueError, match="not divisible"):
        row_sharded(mesh).put(torch.zeros(6, 1))


def test_sharded_nn_matches_single_device(rng, meshes):
    _, mesh = meshes
    q = rng.normal(size=(100, 3)).astype(np.float32)
    t = rng.normal(size=(8 * 64, 3)).astype(np.float32)
    mask = np.ones(8 * 64, bool)
    mask[500:] = False
    # Duplicate rows across every shard seam: ties go to the lower row.
    for s in range(1, 8):
        t[64 * s] = t[64 * s - 1]
    q[:7] = t[[64 * s for s in range(1, 8)]]
    i1, d1 = nearest_neighbor(_t(q), _t(t), _t(mask))
    i8, d8 = nearest_neighbor_sharded(_t(q), _t(t), _t(mask), mesh)
    np.testing.assert_array_equal(i8.numpy(), i1.numpy())
    np.testing.assert_array_equal(d8.numpy(), d1.numpy())
    np.testing.assert_array_equal(i8.numpy()[:7],
                                  [64 * s - 1 for s in range(1, 8)])
    ix, dx = nearest_neighbor_xla(jnp.asarray(q), jnp.asarray(t),
                                  jnp.asarray(mask))
    assert (i8.numpy() == np.asarray(ix)).mean() > 0.98
    np.testing.assert_allclose(d8.numpy(), np.asarray(dx), rtol=1e-4,
                               atol=1e-6)


def test_slab_top1_sharded_matches_single_device_and_jax(rng, meshes):
    jmesh, mesh = meshes
    q = _bumpy(rng, 96)
    t = _bumpy(rng, 8 * 64)
    mask = np.ones(8 * 64, bool)
    mask[480:] = False
    radius = 0.05
    idx, d2 = slab_top1_sharded(build_slab_sharded(_t(t), _t(mask), mesh),
                                _t(q), radius, mesh)
    ji, jd = jax_slab(jax_build_slab(jnp.asarray(t), jnp.asarray(mask),
                                     jmesh), jnp.asarray(q), radius, jmesh)
    i1, d1, _ = slab_top1(build_slab(_t(t), _t(mask)), _t(q), radius)
    in_r = d1.numpy() < 1e29
    assert in_r.mean() > 0.5
    np.testing.assert_array_equal(idx.numpy()[in_r], i1.numpy()[in_r])
    np.testing.assert_array_equal(d2.numpy()[in_r], d1.numpy()[in_r])
    np.testing.assert_array_equal(idx.numpy()[in_r], np.asarray(ji)[in_r])
    np.testing.assert_allclose(d2.numpy()[in_r], np.asarray(jd)[in_r],
                               rtol=1e-6, atol=1e-9)
    assert (d2.numpy()[~in_r] >= 1e29).all()


@pytest.mark.parametrize("degenerate", [False, True])
def test_slab2_top1_sharded_exact(rng, meshes, degenerate):
    jmesh, mesh = meshes
    q = _bumpy(rng, 96)
    t = _bumpy(rng, 8 * 64)
    if degenerate:
        t[:, 0] = 0.05  # one bucket per shard
        q[:, 0] = 0.05
    mask = np.ones(8 * 64, bool)
    mask[480:] = False
    qmask = np.ones(96, bool)
    radius = 0.05
    _check_slab2(q, t, qmask, mask, radius, meshes)


def test_slab2_sharded_degenerate_x_at_16k(rng, meshes):
    n, nq, radius = 16384, 512, 0.02
    t = rng.uniform(-0.15, 0.15, size=(n, 3)).astype(np.float32)
    t[:, 2] = 0.7 + 0.1 * np.sin(9 * t[:, 0]) * np.cos(7 * t[:, 1])
    t[:, 0] = 0.05
    q = (t[rng.integers(0, n, nq)]
         + rng.normal(scale=0.002, size=(nq, 3)).astype(np.float32))
    q[:, 0] = 0.05
    mask = np.ones(n, bool)
    mask[16000:] = False
    _check_slab2(q, t, np.ones(nq, bool), mask, radius, meshes)


def _check_slab2(q, t, qmask, mask, radius, meshes):
    """In-radius rows: indices equal to the single-device walk's and JAX's
    sharded walk's, d² bit for bit the single device's; the rest ≥ 1e30."""
    jmesh, mesh = meshes
    sw = build_walk_sharded(_t(t), _t(mask), radius, mesh)
    idx, d2 = slab2_top1_sharded(sw, _t(q), _t(qmask), radius, mesh)
    i1, d1 = slab2_top1(_t(q), _t(qmask), _t(t), _t(mask), radius)
    jsw = jax_build_walk(jnp.asarray(t), jnp.asarray(mask), radius, jmesh)
    ji, jd = jax_slab2(jsw, jnp.asarray(q), jnp.asarray(qmask), radius,
                       jmesh)
    in_r = d1.numpy() < 1e29
    assert in_r.mean() > 0.5
    np.testing.assert_array_equal(idx.numpy()[in_r], i1.numpy()[in_r])
    np.testing.assert_array_equal(d2.numpy()[in_r], d1.numpy()[in_r])
    np.testing.assert_array_equal(idx.numpy()[in_r], np.asarray(ji)[in_r])
    # XLA contracts the walk's d² into FMAs on the CPU (2 ulp).
    np.testing.assert_allclose(d2.numpy()[in_r], np.asarray(jd)[in_r],
                               rtol=3e-7, atol=1e-12)
    assert (d2.numpy()[~in_r] >= 1e29).all()
    assert (np.asarray(jd)[~in_r] >= 1e29).all()


def test_slab_top1_sharded_surfaces_overflow(rng, meshes):
    _, mesh = meshes
    t = _bumpy(rng, 8 * 64)
    t[:, 0] = 0.05  # every shard's window holds all its rows
    mask = np.ones(8 * 64, bool)
    q = _bumpy(rng, 96)
    sslab = build_slab_sharded(_t(t), _t(mask), mesh)
    _, _, overflow = slab_top1_sharded(sslab, _t(q), 0.05, mesh,
                                       slice_cap=16, return_overflow=True)
    assert bool(overflow)
    _, _, overflow2 = slab_top1_sharded(sslab, _t(q), 0.05, mesh,
                                        slice_cap=64, return_overflow=True)
    assert not bool(overflow2)
