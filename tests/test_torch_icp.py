"""ICP port parity: the K7 plain version against the JAX slab stats (XLA
and Pallas interpret), and ``icp_refine`` against the JAX one from the same
start, on the slab and the brute backends."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_pair
from tpu3d.config import RegistrationConfig as JaxConfig
from tpu3d.ops.icp import build_icp_target as jax_build_icp_target
from tpu3d.ops.icp import fused_slab_stats_fn as jax_fused_stats
from tpu3d.ops.icp import icp_refine as jax_icp_refine
from tpu3d.ops.icp_pallas import icp_p2plane_stats_pallas
from tpu3d.ops.slab import _block_slices as jax_block_slices
from tpu3d.ops.transforms import transform_points as jax_transform_points
from tpu3d.registration import downsample_bucketed, prepare_features
from tpu3d.types import PointCloud as JaxCloud
from tpu3d_torch.ops import icp, icp_stats
from tpu3d_torch.ops.slab import block_slices
from tpu3d_torch.types import PointCloud
from torch_threads import one_torch_thread  # noqa: F401

VOXEL = 0.005


def _t(a):
    return torch.from_numpy(np.array(a))


def _make(rng, n=500, cap=640):
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pad = cap - n
    return JaxCloud(
        points=jnp.asarray(np.pad(pts, ((0, pad), (0, 0)))),
        normals=jnp.asarray(np.pad(nrm, ((0, pad), (0, 0)))),
        mask=jnp.asarray(np.arange(cap) < n),
    )


def _to_torch(c):
    return PointCloud(points=_t(c.points), mask=_t(c.mask),
                      normals=None if c.normals is None else _t(c.normals))


@pytest.mark.parametrize("angle", [0.0, 0.05])
def test_k7_plain_matches_jax(angle):
    rng = np.random.default_rng(0)
    tgt, src = _make(rng), _make(rng)
    thr = 0.25
    block = 64
    c, s = np.cos(angle), np.sin(angle)
    T = np.eye(4, dtype=np.float32)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [0.01, -0.02, 0.005]
    order = np.argsort(np.where(np.asarray(src.mask),
                                np.asarray(src.points)[:, 0], 3e4),
                       kind="stable")
    sp, sm = src.points[order], src.mask[order]

    jindex = jax.jit(jax_build_icp_target)(tgt)
    ref = jax_fused_stats(jindex, sp, sm, thr, True, block=block)(
        jnp.asarray(T))

    # The Pallas kernel in interpret mode, driven as tests/test_icp_pallas.py
    # drives it.
    n = sp.shape[0]
    pad = (-n) % block
    smask_p = jnp.pad(sm, (0, pad))
    src_p = jnp.pad(sp, ((0, pad), (0, 0)))
    nb = (n + pad) // block
    slab = jindex.slab
    packed_j = jnp.concatenate(
        [
            jnp.where(slab.valid_sorted[None, :], slab.sorted_points_t, 3e4),
            jnp.where(slab.valid_sorted[None, :], jindex.nrm_sorted_t, 0.0),
        ],
        axis=0,
    )
    P = jax_transform_points(jnp.asarray(T), src_p)
    qx = jnp.where(smask_p, P[:, 0], jnp.float32(2.9e4))
    jlo, jln = jax_block_slices(slab, qx.reshape(nb, block), jnp.float32(thr))
    q8 = jnp.concatenate(
        [P.T, smask_p.astype(jnp.float32)[None, :],
         jnp.zeros((4, n + pad), jnp.float32)], axis=0,
    )
    parts = icp_p2plane_stats_pallas(
        q8, packed_j, jlo[:, None], jln[:, None], thr * thr,
        block=block, sub=128, interpret=True,
    )
    pal = np.asarray(jnp.sum(parts.reshape(-1, 8, 48), axis=0))

    # The port: same index, windows and kernel inputs, built in torch.
    index = icp.build_icp_target(_to_torch(tgt))
    np.testing.assert_array_equal(index.slab.sorted_orig.numpy(),
                                  np.asarray(slab.sorted_orig))
    stats_fn = icp.SlabStats(index, _t(sp), _t(sm), thr,
                                       block=block)
    got = stats_fn(_t(T))
    Pt = _t(P)
    lo, ln = block_slices(index.slab,
                          torch.where(_t(smask_p), Pt[:, 0], 2.9e4)
                          .reshape(nb, block), thr)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jln))

    assert float(got.n_corr) > 100
    for ata, atb, nc, sd in (
        (ref.ata, ref.atb, ref.n_corr, ref.sum_d2),
        (pal[0:6, 0:6], pal[0:6, 6], pal[6, 0], pal[6, 1]),
    ):
        assert float(got.n_corr) == float(nc)
        np.testing.assert_allclose(float(got.sum_d2), float(sd), rtol=1e-5)
        np.testing.assert_allclose(got.ata.numpy(), np.asarray(ata),
                                   rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(got.atb.numpy(), np.asarray(atb),
                                   rtol=2e-5, atol=1e-6)


def test_k7_empty_windows_give_zero_stats():
    rng = np.random.default_rng(1)
    tgt = _make(rng, n=200, cap=256)
    index = icp.build_icp_target(_to_torch(tgt))
    src = torch.from_numpy(rng.uniform(50, 51, (128, 3)).astype(np.float32))
    stats = icp.SlabStats(index, src,
                                    torch.ones(128, dtype=torch.bool), 0.1)
    s = stats(torch.eye(4))
    assert float(s.n_corr) == 0.0 and float(s.sum_d2) == 0.0
    assert float(s.ata.abs().max()) == 0.0 and float(s.atb.abs().max()) == 0.0


def test_partials_layout_round_trip(rng):
    parts = torch.from_numpy(
        rng.normal(size=(5, icp_stats.PARTIAL_WIDTH)).astype(np.float32))
    ata, atb, nc, sd = icp_stats.unpack_partials(parts)
    s = parts.sum(0)
    assert torch.equal(ata, ata.T)
    assert float(ata[0, 5]) == float(s[5]) and float(ata[5, 5]) == float(s[20])
    assert torch.equal(atb, s[21:27])
    assert float(nc) == float(s[27]) and float(sd) == float(s[28])


def _prepared(n):
    src, tgt, R, t = make_pair(n, voxel=VOXEL)
    cfg = JaxConfig(voxel_size=VOXEL)
    sd = downsample_bucketed(JaxCloud.from_numpy(src), cfg)
    td = downsample_bucketed(JaxCloud.from_numpy(tgt), cfg)
    td, _ = prepare_features(td, cfg, "auto")
    return sd, td, R, t


@pytest.mark.parametrize("n,backend", [(4096, "slab"), (2048, "brute")])
def test_icp_refine_matches_jax(n, backend):
    sd, td, R, t = _prepared(n)
    assert (td.capacity >= 4096) == (backend == "slab")
    T0 = np.eye(4, dtype=np.float32)
    a = 0.01
    T0[:3, :3] = R @ np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
        np.float32)
    T0[:3, 3] = t + np.float32([0.003, -0.002, 0.001])
    ref = jax_icp_refine(sd, td, jnp.asarray(T0), VOXEL * 0.4,
                         max_iterations=200)
    got = icp.icp_refine(_to_torch(sd), _to_torch(td), _t(T0), VOXEL * 0.4,
                         max_iterations=200)
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-5)
    np.testing.assert_allclose(float(got.fitness), float(ref.fitness),
                               atol=1e-3)
    # The brute backend's d² comes from the ‖t‖² − 2t·s + ‖s‖² expansion,
    # whose ~1e-7 cancellation is the size of a converged match's d², so
    # its rmse (~2.6e-4 here) agrees to a few 1e-6 absolute.
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-3,
                               atol=1e-5)
    assert float(got.fitness) > 0.9


@pytest.fixture(scope="module")
def prepared_4096():
    return _prepared(4096)


@pytest.mark.parametrize("final_metrics,polish_threshold", [
    ("auto", 0.5), ("exact", 0.5), ("estimate", 0.5), ("auto", 2.0),
])
def test_icp_source_subset_matches_jax(prepared_4096, final_metrics,
                                       polish_threshold):
    """src_mode='auto' with src_cap=1,024 on a 4,096-row source: the
    strided subset, the final metrics, and (threshold 2.0) the forced
    full-source polish, from the same start as JAX."""
    sd, td, R, t = prepared_4096
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = R
    T0[:3, 3] = t + np.float32([0.002, -0.001, 0.001])
    kw = dict(max_iterations=50, src_cap=1024, final_metrics=final_metrics,
              polish_threshold=polish_threshold)
    ref = jax_icp_refine(sd, td, jnp.asarray(T0), VOXEL * 0.4, **kw)
    ts, tt = _to_torch(sd), _to_torch(td)
    got = icp.icp_refine(ts, tt, _t(T0), VOXEL * 0.4, **kw)
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-5)
    np.testing.assert_allclose(float(got.fitness), float(ref.fitness),
                               atol=1e-3)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-3,
                               atol=1e-6)
    assert float(got.fitness) > 0.9
    # A prebuilt target index gives the same result.
    again = icp.icp_refine(ts, tt, _t(T0), VOXEL * 0.4,
                           target_index=icp.build_icp_target(tt), **kw)
    assert torch.equal(again.transformation, got.transformation)


def test_point_to_point_raises():
    rng = np.random.default_rng(2)
    c = _to_torch(_make(rng, n=100, cap=128))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        icp.icp_refine(c, c, torch.eye(4), 0.1, point_to_plane=False)
