"""ICP port parity: the K7 plain version against the JAX slab stats (XLA
and Pallas interpret) and its match stage against the JAX slab top-1, and
``icp_refine`` against the JAX one from the same start, on the slab and
the brute backends, point-to-plane and point-to-point.

The JAX package's 'brute' backend has two CPU forms of one top-1: the XLA
fallback ``nearest_neighbor`` takes off the TPU, and the Pallas kernel in
interpret mode, which K5 ports. The brute cases run against both.

Point-to-plane on the slab and grid backends holds the pose at 1e-6, the
North star's rule. 'brute' and point-to-point on the slab and brute
backends hold 1e-5: ROADMAP.md §3 records the measured gaps and why."""

import contextlib
import functools

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
from tpu3d.ops.nn_pallas import nearest_neighbor_pallas
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


@contextlib.contextmanager
def _jax_top1(form):
    """JAX's ICP top-1 as ``form``: 'xla' (the off-TPU fallback it takes by
    itself) or 'interpret' (the Pallas kernel in interpret mode); the jit
    caches are cleared on both sides so that no trace of one form serves
    the other."""
    if form == "xla":
        yield
        return
    import tpu3d.ops.icp as jax_icp

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_icp, "nearest_neighbor",
                   functools.partial(nearest_neighbor_pallas, interpret=True))
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


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
        np.testing.assert_allclose(got.vec[:36].reshape(6, 6).numpy(),
                                   np.asarray(ata), rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(got.vec[36:42].numpy(), np.asarray(atb),
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
    assert float(s.vec[:42].abs().max()) == 0.0


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


@pytest.mark.parametrize("n,backend,jax_top1,atol", [
    (4096, "slab", "xla", 1e-6),
    (2048, "brute", "xla", 1e-5),
    (2048, "brute", "interpret", 1e-5),
])
def test_icp_refine_matches_jax(n, backend, jax_top1, atol):
    """The pose within ``atol`` of JAX's from the same start ('brute':
    4.3e-6 from the XLA fallback, 2.4e-6 from the Pallas kernel)."""
    sd, td, R, t = _prepared(n)
    assert (td.capacity >= 4096) == (backend == "slab")
    T0 = np.eye(4, dtype=np.float32)
    a = 0.01
    T0[:3, :3] = R @ np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
        np.float32)
    T0[:3, 3] = t + np.float32([0.003, -0.002, 0.001])
    with _jax_top1(jax_top1):
        ref = jax_icp_refine(sd, td, jnp.asarray(T0), VOXEL * 0.4,
                             max_iterations=200)
    got = icp.icp_refine(_to_torch(sd), _to_torch(td), _t(T0), VOXEL * 0.4,
                         max_iterations=200)
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=atol)
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
                               np.asarray(ref.transformation), atol=1e-6)
    np.testing.assert_allclose(float(got.fitness), float(ref.fitness),
                               atol=1e-3)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-3,
                               atol=1e-6)
    assert float(got.fitness) > 0.9
    # A prebuilt target index gives the same result.
    again = icp.icp_refine(ts, tt, _t(T0), VOXEL * 0.4,
                           target_index=icp.build_icp_target(tt), **kw)
    assert torch.equal(again.transformation, got.transformation)


def _start(R, t, a=0.01, dt=(0.003, -0.002, 0.001)):
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = R @ np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
        np.float32)
    T0[:3, 3] = t + np.float32(dt)
    return T0


@pytest.mark.parametrize("n,backend,normals,jax_top1", [
    (4096, "slab", True, "xla"), (2048, "brute", True, "xla"),
    (4096, "slab", False, "xla"), (2048, "brute", False, "xla"),
    (2048, "brute", True, "interpret"), (2048, "brute", False, "interpret"),
])
def test_point_to_point_matches_jax(n, backend, normals, jax_top1):
    """point_to_plane=False on both backends, and a target without normals
    (point-to-point whatever the flag): JAX's pose within 1e-5 (2.1e-6
    measured on the slab, 7.0e-6 and 7.1e-6 on 'brute' against JAX's two
    forms) and its inlier count."""
    sd, td, R, t = _prepared(n)
    assert (td.capacity >= 4096) == (backend == "slab")
    if not normals:
        td = td._replace(normals=None)
    T0 = _start(R, t)
    with _jax_top1(jax_top1):
        ref = jax_icp_refine(sd, td, jnp.asarray(T0), VOXEL * 0.4,
                             max_iterations=60, point_to_plane=not normals)
    got = icp.icp_refine(_to_torch(sd), _to_torch(td), _t(T0), VOXEL * 0.4,
                         max_iterations=60, point_to_plane=not normals)
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-5)
    n_valid = int(np.asarray(sd.mask).sum())
    assert round(float(got.fitness) * n_valid) == round(
        float(ref.fitness) * n_valid)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-3,
                               atol=1e-5)
    assert float(got.fitness) > 0.9


@pytest.mark.parametrize("final_metrics,polish_threshold", [
    ("exact", 0.5), ("auto", 2.0),
])
def test_point_to_point_subset_matches_jax(prepared_4096, final_metrics,
                                           polish_threshold):
    """The strided subset, its final metrics and the forced full-source
    polish with the point-to-point objective."""
    sd, td, R, t = prepared_4096
    T0 = _start(R, t, a=0.0, dt=(0.002, -0.001, 0.001))
    kw = dict(max_iterations=40, src_cap=1024, final_metrics=final_metrics,
              polish_threshold=polish_threshold, point_to_plane=False)
    ref = jax_icp_refine(sd, td, jnp.asarray(T0), VOXEL * 0.4, **kw)
    got = icp.icp_refine(_to_torch(sd), _to_torch(td), _t(T0), VOXEL * 0.4,
                         **kw)
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-6)
    np.testing.assert_allclose(float(got.fitness), float(ref.fitness),
                               atol=1e-3)
    assert float(got.fitness) > 0.9


def test_k7_match_stage_matches_jax_slab_top1():
    """The match stage's plain version against the JAX package's slab
    top-1 on the same transformed queries: the same kept matches (original
    rows equal, d² to rounding), duplicate target rows resolving to the
    lowest."""
    rng = np.random.default_rng(4)
    tgt = _make(rng, n=900, cap=1024)
    pts = np.array(tgt.points)
    pts[500:520] = pts[100:120]  # duplicates: the lower slab row wins
    tgt = tgt._replace(points=jnp.asarray(pts))
    src = _make(rng, n=700, cap=768)
    thr = 0.12
    index = icp.build_icp_target(_to_torch(tgt))
    order = np.argsort(np.where(np.asarray(src.mask),
                                np.asarray(src.points)[:, 0], 3e4),
                       kind="stable")
    stats = icp.SlabStats(index, _t(np.asarray(src.points)[order]),
                          _t(np.asarray(src.mask)[order]), thr,
                          point_to_plane=False)
    T = torch.from_numpy(_start(np.eye(3, dtype=np.float32),
                                np.zeros(3, np.float32), a=0.03))
    P, d2, row = icp_stats.icp_matches_plain(*stats.kernel_args(T))
    keep = (stats.qmask > 0.5) & (d2 <= stats.thr2)
    from tpu3d.ops.slab import slab_top1 as jax_slab_top1

    jidx, jd2, ovf = jax_slab_top1(jax.jit(jax_build_icp_target)(tgt).slab,
                                   jnp.asarray(P.numpy()), thr,
                                   slice_cap=1024)
    jidx, jd2 = np.asarray(jidx), np.asarray(jd2)
    assert not bool(ovf)
    jkeep = (jd2 < 1e29) & (stats.qmask.numpy() > 0.5)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    assert 100 < int(keep.sum())
    orig = index.slab.sorted_orig[row.clamp_min(0).long()].numpy()
    np.testing.assert_array_equal(orig[jkeep], jidx[jkeep])
    # XLA contracts the squares' sum into FMAs: d² agrees to 2 ulp.
    np.testing.assert_allclose(d2.numpy()[jkeep], jd2[jkeep], rtol=2.4e-7,
                               atol=0)
    # A duplicated row is matched by its lower original (and slab) row.
    dup = np.isin(orig[jkeep], np.arange(500, 520))
    assert not dup.any()


def test_kabsch_from_cross_cov_matches_jax(rng):
    """The host Kabsch step against the JAX package's, on weighted
    matches of a known pose and on a reflection-forcing set: bit for bit,
    both factoring H with LAPACK's sgesdd."""
    from tpu3d.ops.transforms import kabsch_from_cross_cov as jax_kabsch

    from tpu3d_torch.ops.transforms import kabsch_from_cross_cov

    for flip in (False, True):
        p = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
        a = 0.3
        R0 = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                       [0, 0, 1]], np.float32)
        q = p @ R0.T + np.float32([0.1, -0.2, 0.3])
        if flip:
            q[:, 2] *= -1
        w = (rng.uniform(size=200) > 0.2).astype(np.float32)
        sw = np.float32(w.sum())
        sp, sq = (p * w[:, None]).sum(0), (q * w[:, None]).sum(0)
        H = ((p - sp / sw) * w[:, None]).T @ (q - sq / sw)
        R, t = kabsch_from_cross_cov(sw, sp, sq, H)
        jR, jt = jax_kabsch(jnp.float32(sw), jnp.asarray(sp), jnp.asarray(sq),
                            jnp.asarray(H))
        np.testing.assert_array_equal(R, np.asarray(jR))
        np.testing.assert_array_equal(t, np.asarray(jt))
        assert abs(np.linalg.det(R) - 1.0) < 1e-5
    R, t = kabsch_from_cross_cov(3.0, np.zeros(3), np.zeros(3),
                                 np.full((3, 3), np.nan))
    assert not np.isfinite(R).any() and not np.isfinite(t).any()


@pytest.mark.parametrize(
    "nn_mode,point_to_plane,cell_capacity,jax_top1,atol", [
    ("grid", True, 16, "xla", 1e-6), ("grid", False, 16, "xla", 1e-6),
    ("grid", True, 4, "xla", 1e-6), ("brute", True, 16, "xla", 1e-5),
    ("brute", True, 16, "interpret", 1e-5), ("slab", False, 16, "xla", 1e-5),
])
def test_icp_nn_mode_matches_jax(prepared_4096, nn_mode, point_to_plane,
                                 cell_capacity, jax_top1, atol):
    """An explicit ``nn_mode`` on a 4,096-row target ('auto' would take
    the slab backend): the grid backend (cell size = the threshold, with
    the default and an overflowing ``cell_capacity``), brute and slab from
    the same start as JAX. 'grid' and 'brute' iterate every source row.
    The pose within ``atol``, the fitness within 1e-3. 'brute' holds 1e-5
    against either JAX form (6.0e-6 from the XLA fallback, 4.7e-6 from the
    Pallas kernel), the slab point-to-point case as
    test_point_to_point_matches_jax."""
    sd, td, R, t = prepared_4096
    T0 = _start(R, t)
    kw = dict(max_iterations=60, point_to_plane=point_to_plane,
              nn_mode=nn_mode, cell_capacity=cell_capacity)
    with _jax_top1(jax_top1):
        ref = jax_icp_refine(sd, td, jnp.asarray(T0), VOXEL * 0.4, **kw)
    got = icp.icp_refine(_to_torch(sd), _to_torch(td), _t(T0), VOXEL * 0.4,
                         **kw)
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=atol)
    np.testing.assert_allclose(float(got.fitness), float(ref.fitness),
                               atol=1e-3)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-3,
                               atol=1e-5)
    assert float(got.fitness) > 0.9


def test_icp_grid_stats_use_grid_top1(prepared_4096, monkeypatch):
    """nn_mode='grid' takes its matches from grid_top1 with the given
    cell capacity, never from K5 or K7."""
    sd, td, R, t = prepared_4096
    calls = []
    real = icp.grid_top1

    def counted(grid, P, cell_capacity):
        calls.append(cell_capacity)
        return real(grid, P, cell_capacity=cell_capacity)

    monkeypatch.setattr(icp, "grid_top1", counted)
    monkeypatch.setattr(icp, "nearest_neighbor",
                        lambda *a, **k: pytest.fail("K5 ran"))
    monkeypatch.setattr(icp, "SlabStats", lambda *a, **k: pytest.fail("K7"))
    res = icp.icp_refine(_to_torch(sd), _to_torch(td), _t(_start(R, t)),
                         VOXEL * 0.4, max_iterations=5, nn_mode="grid",
                         cell_capacity=12)
    assert calls and set(calls) == {12}
    assert float(res.fitness) > 0.5
