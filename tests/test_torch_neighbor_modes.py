"""Neighbour backends of the gather route against the JAX package:
``radius_capped_neighbors`` and ``knn``'s ``method``, ``surface_neighbors``
in each mode ('slab', 'grid', 'brute', 'auto'), ``prepare_features`` with
each explicit ``neighbor_mode``, and ``prepare_icp_target`` on both sides
of 16,384 rows.

Tolerances: the slab and grid searches compute d² directly, held as in
test_torch_slab.py (``_hold_knn``: gated slots equal, d² within 2 ulp,
a differing index only at a float64 near-tie); the brute search's d² is
the matmul expansion, held as test_torch_prepare.py holds it (≥ 99 % of
rows with identical indices, d² within 1e-4 relative). Normals |cos| ≥
0.9999; descriptors within 1e-5 on ≥ 99 % of rows, as
test_torch_prepare.py holds them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_pair
from test_torch_slab import _hold_knn
from tpu3d.config import RegistrationConfig as JaxConfig
from tpu3d.ops.neighbors import knn as jax_knn
from tpu3d.ops.neighbors import radius_capped_neighbors as jax_rcn
from tpu3d.registration import downsample_bucketed as jax_downsample
from tpu3d.registration import prepare_features as jax_prepare_features
from tpu3d.registration import prepare_icp_target as jax_prepare_icp_target
from tpu3d.registration import surface_neighbors as jax_surface_neighbors
from tpu3d.types import PointCloud as JaxCloud
from tpu3d_torch import registration as reg
from tpu3d_torch.config import RegistrationConfig
from tpu3d_torch.ops import slab as slab_ops
from tpu3d_torch.ops.fpfh import compute_fpfh
from tpu3d_torch.ops.neighbors import knn, radius_capped_neighbors
from tpu3d_torch.ops.normals import estimate_normals
from tpu3d_torch.types import PointCloud
from torch_threads import one_torch_thread  # noqa: F401

VOXEL = 0.005
RADIUS = float(np.float32(VOXEL * 5.0))


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_torch(jc):
    return PointCloud(
        points=_t(jc.points), mask=_t(jc.mask),
        normals=None if jc.normals is None else _t(jc.normals),
    )


@pytest.fixture(scope="module")
def down_1024():
    """A downsampled cloud in the 1,024 bucket (the JAX package's)."""
    src, _, _, _ = make_pair(1200, seed=3, voxel=VOXEL)
    return jax_downsample(JaxCloud.from_numpy(src),
                          JaxConfig(voxel_size=VOXEL))


def _hold_brute(idx, d2, jidx, jd2):
    assert (idx == jidx).all(axis=1).mean() >= 0.99
    np.testing.assert_allclose(d2, jd2, rtol=1e-4, atol=1e-6)


def test_radius_capped_neighbors_matches_jax(down_1024):
    pts, mask = np.asarray(down_1024.points), np.asarray(down_1024.mask)
    jidx, jd2, jvalid = (np.asarray(x) for x in jax_rcn(
        jnp.asarray(pts), jnp.asarray(mask), np.float32(RADIUS), 100,
        method="exact"))
    idx, d2, valid = radius_capped_neighbors(_t(pts), _t(mask), RADIUS, 100)
    _hold_brute(idx.numpy(), d2.numpy(), jidx, jd2)
    # The radius gate on the same d² gives the same set; the expansion's
    # rounding may move a row sitting on the radius.
    assert (valid.numpy() == jvalid).mean() >= 0.999
    np.testing.assert_array_equal(
        valid.numpy(), (d2.numpy() <= np.float32(RADIUS) ** 2)
        & (d2.numpy() < 5e29))


@pytest.mark.parametrize("method", ["auto", "approx"])
def test_knn_method_is_the_exact_search(rng, method):
    """'auto' and 'approx' (the TPU's approx_max_k in JAX) take the exact
    search here: equal to method='exact' and to JAX's exact search."""
    q = rng.normal(size=(200, 3)).astype(np.float32)
    t = rng.normal(size=(400, 3)).astype(np.float32)
    mask = np.arange(400) < 380
    exact = knn(_t(q), _t(t), _t(mask), k=16, method="exact")
    got = knn(_t(q), _t(t), _t(mask), k=16, method=method)
    assert all(torch.equal(a, b) for a, b in zip(got, exact))
    ji, _ = jax_knn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), k=16,
                    method="exact")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ji))


@pytest.mark.parametrize("search", ["knn", "radius_capped_neighbors",
                                    "slab_knn", "estimate_normals",
                                    "compute_fpfh"])
def test_unknown_method_raises(rng, search):
    """Only 'auto', 'exact' and 'approx' are accepted, wherever ``method``
    is taken, precomputed neighbours or not: a misspelt one raises."""
    pts = _t(rng.normal(size=(64, 3)).astype(np.float32))
    mask = torch.ones(64, dtype=torch.bool)
    cloud = PointCloud(pts, mask, normals=torch.nn.functional.normalize(
        pts, dim=1))
    neighbors = knn(pts, pts, mask, k=8)
    calls = {
        "knn": lambda m: knn(pts, pts, mask, k=8, method=m),
        "radius_capped_neighbors": lambda m: radius_capped_neighbors(
            pts, mask, 0.5, 8, method=m),
        "slab_knn": lambda m: slab_ops.slab_knn(
            slab_ops.build_slab(pts, mask), pts, 0.5, 8, method=m),
        "estimate_normals": lambda m: estimate_normals(
            cloud, k=8, method=m, neighbors=neighbors),
        "compute_fpfh": lambda m: compute_fpfh(
            cloud, 0.5, max_nn=8, method=m, neighbors=neighbors),
    }
    calls[search]("exact")
    with pytest.raises(ValueError, match="method"):
        calls[search]("exactt")


@pytest.mark.parametrize("mode", ["slab", "grid", "brute", "auto"])
def test_surface_neighbors_each_mode(down_1024, mode):
    jidx, jd2 = (np.asarray(x) for x in jax_surface_neighbors(
        down_1024, np.float32(RADIUS), k=100, mode=mode))
    idx, d2 = reg.surface_neighbors(_to_torch(down_1024), RADIUS, k=100,
                                    mode=mode)
    assert idx.shape == d2.shape == (down_1024.capacity, 100)
    if mode in ("slab", "grid"):
        pts = np.asarray(down_1024.points)
        matched = _hold_knn(pts, pts, idx.numpy(), d2.numpy(), jidx, jd2)
        assert matched[np.asarray(down_1024.mask)].any(axis=1).all()
    else:
        _hold_brute(idx.numpy(), d2.numpy(), jidx, jd2)


@pytest.fixture(scope="module")
def down_8192():
    """A downsampled cloud in the 8,192 bucket: dense enough that every
    row has a well-conditioned in-radius neighbourhood (on the sparser
    1,024 bucket some rows have two or three neighbours within the radius,
    and their smallest eigenvector is arbitrary in both packages)."""
    src, _, _, _ = make_pair(8192, seed=3, voxel=VOXEL)
    return jax_downsample(JaxCloud.from_numpy(src),
                          JaxConfig(voxel_size=VOXEL))


@pytest.mark.parametrize("mode", ["slab", "grid", "brute"])
def test_prepare_features_each_mode(down_8192, mode, monkeypatch):
    """Normals + FPFH with each explicit neighbor_mode. The brute search's
    self-distances are the expansion's cancellation residue (up to ~1e-7,
    rounded differently by XLA's and PyTorch's products), which FPFH's
    pair gate (distance ≥ 1e-8) and 1/distance weights turn into different
    descriptors in both directions; so for 'brute' the descriptors are held
    on JAX's neighbours (the search itself is held above), and the normals
    on the port's own."""
    cfg = JaxConfig(voxel_size=VOXEL)
    jn, jf = jax_prepare_features(down_8192, cfg, mode)
    tcfg = RegistrationConfig(voxel_size=VOXEL)
    tn, tf = reg.prepare_features(_to_torch(down_8192), tcfg, mode)
    mask = np.asarray(down_8192.mask)
    cos = np.abs(np.sum(tn.normals.numpy() * np.asarray(jn.normals), axis=1))
    assert cos[mask].min() >= 0.9999
    if mode == "brute":
        jnb = jax_surface_neighbors(down_8192, np.float32(RADIUS), k=100,
                                    mode="brute")
        monkeypatch.setattr(reg, "surface_neighbors",
                            lambda *a, **k: (_t(jnb[0]), _t(jnb[1])))
        tn, tf = reg.prepare_features(_to_torch(down_8192), tcfg, mode)
    ok = np.all(np.abs(tf.descriptors.numpy() - np.asarray(jf.descriptors))
                <= 1e-5, axis=1)
    assert ok.mean() >= 0.99
    np.testing.assert_array_equal(tf.mask.numpy(), np.asarray(jf.mask))


@pytest.mark.parametrize("n,capacity", [(8192, 8192), (16384, 16384)])
@pytest.mark.parametrize("with_normals", [True, False])
def test_prepare_icp_target_matches_jax(n, capacity, with_normals):
    """Below 16,384 rows the brute search, from 16,384 the slab one."""
    _, tgt, _, _ = make_pair(n, seed=2, voxel=VOXEL)
    jd = jax_prepare_icp_target(JaxCloud.from_numpy(tgt),
                                JaxConfig(voxel_size=VOXEL), with_normals)
    td = reg.prepare_icp_target(PointCloud.from_numpy(tgt, device="cpu"),
                                RegistrationConfig(voxel_size=VOXEL),
                                with_normals)
    assert td.capacity == jd.capacity == capacity
    np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
    np.testing.assert_allclose(td.points.numpy(), np.asarray(jd.points),
                               atol=1e-6)
    if not with_normals:
        assert td.normals is None and jd.normals is None
        return
    mask = np.asarray(jd.mask)
    cos = np.abs(np.sum(td.normals.numpy() * np.asarray(jd.normals), axis=1))
    assert cos[mask].min() >= 0.9999


def test_prepare_icp_target_takes_the_slab_search_at_scale(monkeypatch):
    """From 16,384 rows the neighbours come from slab_knn at k = 30."""
    calls = []
    real = reg.slab_knn

    def counted(*a, **k):
        calls.append(k["k"])
        return real(*a, **k)

    monkeypatch.setattr(reg, "slab_knn", counted)
    _, tgt, _, _ = make_pair(16384, seed=2, voxel=VOXEL)
    reg.prepare_icp_target(PointCloud.from_numpy(tgt, device="cpu"),
                           RegistrationConfig(voxel_size=VOXEL))
    assert calls == [30]
