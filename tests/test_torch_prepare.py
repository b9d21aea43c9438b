"""Port parity of the prepare stages: voxel downsample + compact, exact
kNN, normals and FPFH, against the JAX package on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_pair
from tpu3d.config import RegistrationConfig as JaxConfig
from tpu3d.ops.fpfh import compute_fpfh as jax_fpfh
from tpu3d.ops.neighbors import knn as jax_knn
from tpu3d.ops.normals import estimate_normals as jax_normals
from tpu3d.ops.voxel import compact as jax_compact
from tpu3d.ops.voxel import voxel_downsample as jax_voxel
from tpu3d.registration import downsample_bucketed as jax_downsample
from tpu3d.registration import surface_neighbors as jax_surface_neighbors
from tpu3d.types import PointCloud as JaxCloud
from tpu3d_torch.config import RegistrationConfig
from tpu3d_torch.ops.fpfh import compute_fpfh
from tpu3d_torch.ops.neighbors import knn
from tpu3d_torch.ops.normals import estimate_normals
from tpu3d_torch.ops.voxel import compact, voxel_downsample
from tpu3d_torch.registration import downsample_bucketed, surface_neighbors
from tpu3d_torch.types import PointCloud
from torch_threads import one_torch_thread  # noqa: F401

VOXEL = 0.005


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_torch(jc):
    return PointCloud(
        points=_t(jc.points), mask=_t(jc.mask),
        normals=None if jc.normals is None else _t(jc.normals),
    )


@pytest.fixture(scope="module")
def down_pair():
    """A downsampled 1,024-bucket cloud, prepared once by the JAX package."""
    src, _, _, _ = make_pair(1200, seed=3, voxel=VOXEL)
    jc = JaxCloud.from_numpy(src)
    jdown = jax_downsample(jc, JaxConfig(voxel_size=VOXEL))
    radius = jnp.float32(VOXEL * 5.0)
    nbrs = jax_surface_neighbors(jdown, radius, k=100, mode="brute")
    jn = jax_normals(jdown, k=30, neighbors=nbrs)
    jf = jax_fpfh(jn, radius, neighbors=nbrs)
    return jdown, nbrs, jn, jf


@pytest.mark.parametrize("n,voxel", [(3000, 0.005), (5000, 0.02)])
def test_voxel_downsample_and_compact(n, voxel):
    src, _, _, _ = make_pair(n, seed=1, voxel=0.005)
    jc = JaxCloud.from_numpy(src)
    jd = jax_voxel(jc, voxel)
    td = voxel_downsample(PointCloud.from_numpy(src, device="cpu"), voxel)
    assert int(td.mask.sum()) == int(jd.count())
    np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
    np.testing.assert_allclose(td.points.numpy(), np.asarray(jd.points),
                               atol=1e-6)
    cap = 1 << int(np.ceil(np.log2(int(jd.count()))))
    jk = jax_compact(jd, cap)
    tk = compact(td, cap)
    np.testing.assert_array_equal(tk.mask.numpy(), np.asarray(jk.mask))
    np.testing.assert_allclose(tk.points.numpy(), np.asarray(jk.points),
                               atol=1e-6)


def test_downsample_bucketed_matches():
    src, _, _, _ = make_pair(2500, seed=2, voxel=VOXEL)
    jd = jax_downsample(JaxCloud.from_numpy(src), JaxConfig(voxel_size=VOXEL))
    td = downsample_bucketed(PointCloud.from_numpy(src, device="cpu"),
                             RegistrationConfig(voxel_size=VOXEL))
    assert td.capacity == jd.capacity
    np.testing.assert_allclose(td.points.numpy(), np.asarray(jd.points),
                               atol=1e-6)


def test_knn_indices_match_untied(rng):
    q = rng.normal(size=(300, 3)).astype(np.float32)
    t = rng.normal(size=(500, 3)).astype(np.float32)
    mask = np.ones(500, bool)
    mask[450:] = False
    ji, jd = jax_knn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), k=20,
                     chunk=128, method="exact")
    ti, td = knn(_t(q), _t(t), _t(mask), k=20, chunk=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)


def test_surface_neighbors_match(down_pair):
    jdown, nbrs, _, _ = down_pair
    ti, td = surface_neighbors(_to_torch(jdown), float(np.float32(VOXEL * 5)),
                               k=100, mode="brute")
    ji, jd = np.asarray(nbrs[0]), np.asarray(nbrs[1])
    # Rows with an exact float tie inside their first 100 may order it
    # differently after rounding; everything else is identical.
    same = (ti.numpy() == ji).all(axis=1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-4, atol=1e-6)


def test_normals_match(down_pair):
    jdown, nbrs, jn, _ = down_pair
    tn = estimate_normals(_to_torch(jdown), k=30,
                          neighbors=(_t(nbrs[0]), _t(nbrs[1])))
    mask = np.asarray(jdown.mask)
    cos = np.abs(np.sum(tn.normals.numpy() * np.asarray(jn.normals), axis=1))
    assert cos[mask].min() >= 0.9999
    assert np.all(tn.normals.numpy()[~mask] == 0)


def test_fpfh_match(down_pair):
    jdown, nbrs, jn, jf = down_pair
    tf = compute_fpfh(_to_torch(jn), float(np.float32(VOXEL * 5.0)),
                      neighbors=(_t(nbrs[0]), _t(nbrs[1])))
    ok = np.all(
        np.abs(tf.descriptors.numpy() - np.asarray(jf.descriptors)) <= 1e-5,
        axis=1,
    )
    assert ok.mean() >= 0.99
    np.testing.assert_array_equal(tf.mask.numpy(), np.asarray(jf.mask))
