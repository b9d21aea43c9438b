"""Sharded prepare parity: ``tpu3d_torch.parallel.prepare_sharded`` on an
8-shard CPU mesh against ``tpu3d.parallel.prepare_sharded`` on JAX's 8
virtual host devices and against the port's single-device prepare, on
the same seeded numpy clouds (``test_prepare_sharded.py``'s): the
x-partition equal to JAX's exactly, normals |cos| >= 0.9999 and the
descriptors' correspondence agreement >= 0.91 against both (the ``ok``
flag: ``test_torch_parallel_prepare_flags.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu3d.parallel import make_mesh as jax_make_mesh
from tpu3d.parallel.prepare_sharded import (
    fused_prepare_sharded as jax_prepare_sharded,
)
from tpu3d.parallel.prepare_sharded import x_partition as jax_x_partition
from tpu3d.types import PointCloud as JaxCloud
from tpu3d_torch.ops import nn
from tpu3d_torch.ops.fused_features import fused_prepare_features
from tpu3d_torch.parallel import make_mesh
from tpu3d_torch.parallel.prepare_sharded import (
    fused_prepare_sharded,
    x_partition,
)
from tpu3d_torch.types import PointCloud
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh (conftest default)")
    return jax_make_mesh(("shard",)), make_mesh(devices=["cpu"] * 8)


def _bumpy(rng, n, r):
    xy = rng.uniform(-0.075, 0.075, size=(n, 2)).astype(np.float32)
    w = 1.1 / r
    z = 0.7 + 1.2 * r * np.sin(w * xy[:, 0]) * np.cos(0.8 * w * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


def _jax(pts, cap, r, jmesh, **kw):
    c = JaxCloud.from_numpy(pts, capacity=cap)
    p, m, o = jax_x_partition(c.points, c.mask, jmesh.shape["shard"])
    sh = NamedSharding(jmesh, P("shard"))
    out_c, out_f, ok = jax_prepare_sharded(
        jax.device_put(p, sh), jax.device_put(m, sh), jnp.float32(r),
        mesh=jmesh, **kw)
    return out_c, out_f, bool(ok), np.asarray(o)


def _port(pts, cap, r, mesh, **kw):
    c = PointCloud.from_numpy(pts, capacity=cap, device="cpu")
    p, m, o = x_partition(c.points, c.mask, mesh.shape["shard"])
    out_c, out_f, ok = fused_prepare_sharded(p, m, r, mesh, **kw)
    return out_c, out_f, bool(ok), o.numpy()


def test_x_partition_matches_jax(rng):
    pts = rng.normal(size=(1000, 3)).astype(np.float32)
    pts[100:300, 0] = 0.25  # ties keep their input order
    mask = rng.uniform(size=1000) > 0.2
    for n_shards in (3, 8):
        got = x_partition(torch.from_numpy(pts), torch.from_numpy(mask),
                          n_shards)
        ref = jax_x_partition(jnp.asarray(pts), jnp.asarray(mask), n_shards)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _agreement(a, b):
    idx, _ = nn.nearest_neighbor(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.ones(len(b), dtype=torch.bool))
    return float((idx.numpy() == np.arange(len(b))).mean())


def test_sharded_prepare_matches_jax_and_single_device(rng, meshes):
    jmesh, mesh = meshes
    n, cap, r = 16000, 16384, np.float32(0.004)
    pts = _bumpy(rng, n, r)
    jc, jf, jok, jorig = _jax(pts, cap, r, jmesh, halo=1536)
    tc, tf, tok, torig = _port(pts, cap, r, mesh, halo=1536)
    assert tok and jok
    np.testing.assert_array_equal(torig, jorig)
    v = tc.mask.numpy()
    np.testing.assert_array_equal(v, np.asarray(jc.mask))
    tn, td = tc.normals.numpy()[v], tf.descriptors.numpy()[v]
    cos = np.abs((tn * np.asarray(jc.normals)[v]).sum(1))
    assert cos.min() >= 0.9999, cos.min()
    assert _agreement(td, np.asarray(jf.descriptors)[v]) >= 0.91
    # Against the port's single-device prepare, rows mapped back.
    sc, sf = fused_prepare_features(
        PointCloud.from_numpy(pts, capacity=cap, device="cpu"), r)
    rows = torig[v]
    cos1 = np.abs((tn * sc.normals.numpy()[rows]).sum(1))
    assert cos1.min() >= 0.9999, cos1.min()
    assert _agreement(td, sf.descriptors.numpy()[rows]) >= 0.91
    assert rows.shape[0] == n
