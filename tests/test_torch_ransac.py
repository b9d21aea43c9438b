"""RANSAC port parity: the K6 plain version against the JAX scorers, and
``ransac_registration``'s routes (chunked with the rotation or the gather
sampler, one shot, two-stage) against the JAX one with the JAX draw stream
replayed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_pair
from tpu3d.config import RegistrationConfig as JaxConfig
from tpu3d.ops.ransac import build_scoring_factors as jax_factors
from tpu3d.ops.ransac import decimation_stride as jax_decimation_stride
from tpu3d.ops.ransac import pack_hypotheses
from tpu3d.ops.ransac import ransac_registration as jax_ransac
from tpu3d.ops.ransac import score_w16
from tpu3d.ops.ransac_pallas import score_hypotheses_pallas
from tpu3d.ops.transforms import kabsch_quat
from tpu3d.registration import downsample_bucketed, prepare_features
from tpu3d.types import PointCloud as JaxCloud
from tpu3d_torch.ops import nn, ransac, ransac_score
from tpu3d_torch.types import FPFHFeatures, PointCloud
from torch_threads import one_torch_thread  # noqa: F401

VOXEL = 0.005


class JaxDraws:
    """The JAX package's draw stream (ops/ransac.py): the rotation
    sampler's per-(chunk, epoch) triples and the gather sampler's (h, 3)
    row draws, per chunk or (chunk None) from the one-shot key."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.hyp_key = jax.random.fold_in(self.key, 7)

    def __call__(self, c, e):
        k = jax.random.fold_in(jax.random.fold_in(self.hyp_key, c), e)
        u = np.asarray(jax.random.randint(k, (3,), 0, 1 << 30))
        return int(u[0]), int(u[1]), int(u[2])

    def triples(self, c, h, count):
        k = self.key if c is None else jax.random.fold_in(self.hyp_key, c)
        d = jax.random.randint(k, (h, 3), 0, jnp.int32(count))
        return torch.from_numpy(np.asarray(d).astype(np.int64))

    def rows(self, n, count):
        k = jax.random.fold_in(self.key, 1)
        d = jax.random.randint(k, (n,), 0, jnp.int32(count))
        return torch.from_numpy(np.asarray(d).astype(np.int64))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_torch_draws_are_deterministic_and_in_range():
    d = ransac.torch_draws(42)
    assert d(1, 2) == d(1, 2)
    assert d(0, 0) != d(0, 1)
    assert all(0 <= u < 1 << 30 for u in d(3, 4))
    rows = d.rows(ransac.SUB_N, 1000)
    assert rows.shape == (ransac.SUB_N,) and torch.equal(
        rows, d.rows(ransac.SUB_N, 1000))
    assert 0 <= int(rows.min()) and int(rows.max()) < 1000
    assert not torch.equal(rows[:64], d.triples(None, 64, 1000)[:, 0])


def test_k6_plain_matches_jax_scorers(rng):
    n, h = 600, 700
    p = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    # Inliers sit far inside the threshold and outliers far outside it.
    q = p + rng.normal(0, 3e-4, (n, 3)).astype(np.float32)
    out = rng.uniform(size=n) < 0.4
    q[out] += rng.uniform(0.05, 0.2, (out.sum(), 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    # Hypotheses: 3-point Kabsch fits of random triples — near the truth
    # when all three are inliers, wild otherwise.
    tri = rng.integers(0, n, (h, 3))
    Rs, ts = kabsch_quat(jnp.asarray(p[tri]), jnp.asarray(q[tri]))
    w16t, tn = pack_hypotheses(Rs, ts)
    ft, pq = jax_factors(jnp.asarray(p), jnp.asarray(q), jnp.asarray(mask))
    thr2 = np.float32((np.float32(VOXEL) * np.float32(1.5)) ** 2)
    c_ref, e_ref = score_w16(ft, pq, w16t, tn, thr2)
    c_pl, e_pl = score_hypotheses_pallas(ft, pq, w16t, tn, thr2,
                                         interpret=True)
    tft, tpq = ransac.build_scoring_factors(_t(p), _t(q), _t(mask))
    np.testing.assert_array_equal(tft.numpy(), np.asarray(ft))
    np.testing.assert_array_equal(tpq.numpy(), np.asarray(pq))
    c, e = ransac_score.score_hypotheses(tft, tpq, _t(w16t), _t(tn),
                                         float(thr2))
    assert c.numpy().max() > 50  # the inputs exercise the threshold
    # The rank-16 expansion cancels terms of O(1) (O(10) for a wild pose)
    # down to err² ~ 1e-5, so f32 summation order moves err² by up to a
    # few 1e-6: a row within 1e-5 of thr² may count in one scorer and not
    # another. Counts must agree exactly on every hypothesis with no such
    # row, and differ elsewhere by at most its number of such rows.
    W = np.asarray(w16t, np.float64)
    R64 = W[6:15].T.reshape(h, 3, 3)
    err64 = (((p.astype(np.float64) @ R64.transpose(0, 2, 1))
              + W[3:6].T[:, None, :] - q) ** 2).sum(-1)  # (h, n)
    near = ((np.abs(err64 - thr2) < 1e-5) & mask[None, :]).sum(1)
    clear = near == 0
    assert clear.mean() > 0.3
    for cr, er in ((c_ref, e_ref), (c_pl, e_pl)):
        cr, er = np.asarray(cr), np.asarray(er)
        np.testing.assert_array_equal(c.numpy()[clear], cr[clear])
        assert np.all(np.abs(c.numpy() - cr) <= near)
        # Σerr² over inliers carries the same per-row cancellation noise
        # (the reported rmse is rescored directly for this reason).
        assert np.all(
            np.abs(e.numpy() - er)[clear] <= 1e-4 * er[clear] + 1e-5 * cr[clear]
        )


@pytest.fixture(scope="module")
def prepared_4096():
    src, tgt, R, t = make_pair(4096, voxel=VOXEL)
    cfg = JaxConfig(voxel_size=VOXEL)
    sd = downsample_bucketed(JaxCloud.from_numpy(src), cfg)
    td = downsample_bucketed(JaxCloud.from_numpy(tgt), cfg)
    assert sd.capacity == td.capacity == 4096
    sd, sf = prepare_features(sd, cfg, "auto")
    td, tf = prepare_features(td, cfg, "auto")
    return sd, td, sf, tf


def _to_torch(sd, td, sf, tf):
    def cloud(c):
        return PointCloud(points=_t(c.points), mask=_t(c.mask),
                          normals=_t(c.normals))

    def feat(f):
        return FPFHFeatures(descriptors=_t(f.descriptors), mask=_t(f.mask))

    return cloud(sd), cloud(td), feat(sf), feat(tf)


def test_with_target_operand_builds_it_once(prepared_4096, monkeypatch):
    """K5's target operand is attached once per target model: not on the
    CPU (the plain version takes no operand); where the kernel would
    launch, it is descriptor_targets of the target's descriptors, a second
    call keeps it, and the correspondences through it are the JAX
    package's."""
    sd, td, sf, tf = prepared_4096
    from tpu3d.ops.ransac import feature_correspondences as jax_corr

    _, _, tsf, ttf = _to_torch(sd, td, sf, tf)
    assert ransac.with_target_operand(ttf) is ttf and ttf.nn_operand is None
    monkeypatch.setattr(ransac, "launches_kernel", lambda *ts: True)
    att = ransac.with_target_operand(ttf)
    assert torch.equal(att.nn_operand,
                       nn.descriptor_targets(ttf.descriptors, ttf.mask))
    assert ransac.with_target_operand(att) is att
    np.testing.assert_array_equal(
        ransac.feature_correspondences(tsf, att).numpy(),
        np.asarray(jax_corr(sf, tf)))


def test_ransac_registration_replays_jax(prepared_4096):
    """Same correspondences and the same draws give the same winner."""
    sd, td, sf, tf = prepared_4096
    from tpu3d.ops.ransac import feature_correspondences as jax_corr

    ts, tt, tsf, ttf = _to_torch(sd, td, sf, tf)
    corr_t = ransac.feature_correspondences(tsf, ttf)
    np.testing.assert_array_equal(corr_t.numpy(), np.asarray(jax_corr(sf, tf)))

    ref = jax_ransac(sd, td, sf, tf, VOXEL, max_iterations=30000)
    got = ransac.ransac_registration(ts, tt, tsf, ttf, VOXEL,
                                     max_iterations=30000,
                                     draws=JaxDraws(42))
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-5)
    assert float(got.fitness) == float(ref.fitness)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-5)
    assert float(got.fitness) > 0.3


def test_decimation_stride_matches_jax():
    for n in range(2, 600):
        for cap in (1, 2, 3, 7, 16, 64):
            if n >= 2 * cap:
                assert ransac.decimation_stride(n, cap) == \
                    jax_decimation_stride(n, cap), (n, cap)
    for n, cap in ((131072, 8192), (131072, 16384), (100352, 2048)):
        assert ransac.decimation_stride(n, cap) == jax_decimation_stride(n, cap)


def test_corr_subsample_replays_jax(prepared_4096):
    """corr_mode='auto' on a source of 2·corr_cap rows: the strided subset,
    its estimate stage and the JAX draws give the JAX winner."""
    sd, td, sf, tf = prepared_4096
    ts, tt, tsf, ttf = _to_torch(sd, td, sf, tf)
    kw = dict(max_iterations=30000, corr_cap=2048, est_cap=512)
    ref = jax_ransac(sd, td, sf, tf, VOXEL, **kw)
    got = ransac.ransac_registration(ts, tt, tsf, ttf, VOXEL,
                                     draws=JaxDraws(42), **kw)
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-5)
    assert float(got.fitness) == float(ref.fitness)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-5)
    assert float(got.fitness) > 0.3
    # 'exact' keeps every row: a different correspondence set.
    exact = ransac.ransac_registration(ts, tt, tsf, ttf, VOXEL,
                                       corr_mode="exact", draws=JaxDraws(42),
                                       **kw)
    assert float(exact.fitness) != float(got.fitness)


def _assert_replays(got, ref, n_valid):
    """The same winner: the pose within 1e-5 and identical inlier counts."""
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-5)
    assert round(float(got.fitness) * n_valid) == round(
        float(ref.fitness) * n_valid)
    np.testing.assert_allclose(float(got.rmse), float(ref.rmse), rtol=1e-5)


@pytest.mark.parametrize("iters,corr_mode", [(3000, "exact"),
                                             (10000, "auto")])
def test_one_shot_replays_jax(prepared_4096, iters, corr_mode):
    """max_iterations ≤ the chunk size: every gather-sampled hypothesis
    scored at once (with the corr subset at corr_cap 2,048)."""
    sd, td, sf, tf = prepared_4096
    ts, tt, tsf, ttf = _to_torch(sd, td, sf, tf)
    kw = dict(max_iterations=iters, corr_mode=corr_mode, corr_cap=2048)
    ref = jax_ransac(sd, td, sf, tf, VOXEL, **kw)
    got = ransac.ransac_registration(ts, tt, tsf, ttf, VOXEL,
                                     draws=JaxDraws(42), **kw)
    n_valid = 2048 if corr_mode == "auto" else int(np.asarray(sd.mask).sum())
    _assert_replays(got, ref, n_valid)
    assert float(got.fitness) > 0.3


@pytest.mark.parametrize("iters,corr_mode,confidence", [
    (30000, "exact", 0.999), (10000, "auto", 0.999), (30000, "exact", 0.5),
])
def test_two_stage_replays_jax(prepared_4096, iters, corr_mode, confidence):
    """two_stage=True: the one-shot hypotheses estimated on JAX's 16,384
    stage-1 rows, the early-exit prefix on the estimates (a confidence
    that some estimate exceeds, at 0.5), the top 1,024 rescored exactly:
    JAX's winner."""
    sd, td, sf, tf = prepared_4096
    ts, tt, tsf, ttf = _to_torch(sd, td, sf, tf)
    kw = dict(max_iterations=iters, corr_mode=corr_mode, corr_cap=2048,
              confidence=confidence, two_stage=True)
    ref = jax_ransac(sd, td, sf, tf, VOXEL, **kw)
    got = ransac.ransac_registration(ts, tt, tsf, ttf, VOXEL,
                                     draws=JaxDraws(42), **kw)
    n_valid = 2048 if corr_mode == "auto" else int(np.asarray(sd.mask).sum())
    _assert_replays(got, ref, n_valid)
    assert float(got.fitness) > 0.3


def test_two_stage_auto_needs_32768_rows(prepared_4096, monkeypatch):
    """'auto' takes two-stage scoring only from 2 x 16,384 rows: on 4,096
    it is the one-shot route, and the stage-1 draw is never made."""
    ts, tt, tsf, ttf = _to_torch(*prepared_4096)
    draws = JaxDraws(42)
    monkeypatch.setattr(JaxDraws, "rows", lambda *a: pytest.fail("drawn"),
                        raising=True)
    kw = dict(max_iterations=3000, corr_mode="exact", draws=draws)
    auto = ransac.ransac_registration(ts, tt, tsf, ttf, VOXEL, **kw)
    off = ransac.ransac_registration(ts, tt, tsf, ttf, VOXEL,
                                     two_stage=False, **kw)
    assert torch.equal(auto.transformation, off.transformation)
    assert float(auto.fitness) == float(off.fitness) > 0.3


def test_gather_sampler_chunks_replay_jax(prepared_4096):
    """Below 2,048 rows (here the corr subset at corr_cap 1,024) the
    chunked route draws with the gather sampler: an exhaustive 2-chunk
    budget (a confidence no hypothesis exceeds) and the early exit both
    give JAX's winner."""
    sd, td, sf, tf = prepared_4096
    ts, tt, tsf, ttf = _to_torch(sd, td, sf, tf)
    stride = ransac.decimation_stride(4096, 1024)
    n_valid = int(np.asarray(sd.mask)[: stride * 1024 : stride].sum())
    for conf in (1.0, 0.5):
        kw = dict(max_iterations=20000, confidence=conf, corr_cap=1024)
        ref = jax_ransac(sd, td, sf, tf, VOXEL, **kw)
        got = ransac.ransac_registration(ts, tt, tsf, ttf, VOXEL,
                                         draws=JaxDraws(42), **kw)
        _assert_replays(got, ref, n_valid)
        assert float(got.fitness) > 0.3


# The routing arguments (kw, the route JAX takes): the one-shot pad
# multiple, an explicit chunk size, the early exit off (one shot over the
# whole budget), and each sampler forced against its 'auto' choice.
ROUTES = {
    "chunk 1000, one shot": dict(max_iterations=3000, chunk=1000,
                                 corr_mode="exact"),
    "hyp_chunk 20480": dict(max_iterations=30000, hyp_chunk=20480,
                            corr_mode="exact", confidence=1.0),
    "early_exit off": dict(max_iterations=30000, early_exit=False,
                           corr_mode="exact"),
    "early_exit on": dict(max_iterations=30000, early_exit=True,
                          corr_mode="exact"),
    "sampling gather": dict(max_iterations=30000, sampling="gather",
                            corr_mode="exact", confidence=1.0),
    "sampling rotation, n 1024": dict(max_iterations=20000,
                                      sampling="rotation", corr_cap=1024,
                                      confidence=1.0),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routing_arguments_replay_jax(prepared_4096, route):
    """``chunk``, ``hyp_chunk``, ``early_exit`` and ``sampling`` take the
    JAX route with the JAX draws replayed: the same winner (the pose within
    1e-5, identical inlier counts, rmse within 1e-5 relative)."""
    sd, td, sf, tf = prepared_4096
    ts, tt, tsf, ttf = _to_torch(sd, td, sf, tf)
    kw = ROUTES[route]
    ref = jax_ransac(sd, td, sf, tf, VOXEL, **kw)
    got = ransac.ransac_registration(ts, tt, tsf, ttf, VOXEL,
                                     draws=JaxDraws(42), **kw)
    mask = np.asarray(sd.mask)
    if kw.get("corr_mode") == "exact":
        n_valid = int(mask.sum())
    else:
        stride = ransac.decimation_stride(4096, kw["corr_cap"])
        n_valid = int(mask[: stride * kw["corr_cap"]: stride].sum())
    _assert_replays(got, ref, n_valid)
    assert float(got.fitness) > 0.3


def test_routing_arguments_pick_the_route(prepared_4096, monkeypatch):
    """Which sampler and how many hypotheses each argument gives: the one
    shot draws ⌈iterations/chunk⌉·chunk triples from the one-shot stream
    (chunk None); hyp_chunk sets the chunked route's chunk size; sampling
    'gather' draws per chunk; early_exit=False never enters a chunk."""
    ts, tt, tsf, ttf = _to_torch(*prepared_4096)
    drawn = []

    class Recorder(JaxDraws):
        def __call__(self, c, e):
            drawn.append(("rotation", c))
            return super().__call__(c, e)

        def triples(self, c, h, count):
            drawn.append(("gather", c, h))
            return super().triples(c, h, count)

    def run(**kw):
        drawn.clear()
        ransac.ransac_registration(ts, tt, tsf, ttf, VOXEL, corr_mode="exact",
                                   confidence=1.0, draws=Recorder(42), **kw)
        return list(drawn)

    assert run(max_iterations=3000, chunk=1000) == [("gather", None, 3000)]
    assert run(max_iterations=30000, early_exit=False) == [
        ("gather", None, 30208)]
    assert run(max_iterations=30000, sampling="gather") == [
        ("gather", 0, 16384), ("gather", 1, 16384)]
    got = run(max_iterations=30000, hyp_chunk=20480)
    assert {d[1] for d in got} == {0, 1} and got[0][0] == "rotation"


def test_gather_sampler_small_counts():
    """Fewer than three valid rows: every gather triple repeats a row, so
    the result is the identity with fitness 0 on both routes."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.1, 0.1, (256, 3)).astype(np.float32)
    desc = rng.uniform(size=(256, 33)).astype(np.float32)
    for n_valid in (1, 2):
        mask = np.arange(256) < n_valid
        cloud = PointCloud(points=_t(pts), mask=_t(mask))
        feat = FPFHFeatures(descriptors=_t(desc), mask=_t(mask))
        for iters in (1000, 20000):
            res = ransac.ransac_registration(cloud, cloud, feat, feat, VOXEL,
                                             max_iterations=iters)
            assert float(res.fitness) == 0.0
            np.testing.assert_array_equal(res.transformation.numpy(),
                                          np.eye(4, dtype=np.float32))


def test_gather_solve_matches_jax(rng):
    """One gather draw through kabsch_quat and pack_hypotheses."""
    from tpu3d.ops.transforms import kabsch_quat as jax_kq

    n, h = 300, 500
    p = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    q = p + rng.normal(0, 1e-3, (n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.2
    tri = rng.integers(0, int(mask.sum()), (h, 3))
    perm = np.argsort(~mask, kind="stable")
    s6 = np.concatenate([p, q], 1)[perm[tri]]
    Rs, ts = jax_kq(jnp.asarray(s6[..., :3]), jnp.asarray(s6[..., 3:]))
    w_ref, tn_ref = pack_hypotheses(Rs, ts)
    w, tn, disabled = ransac.solve_gather(
        torch.from_numpy(tri), 7, torch.from_numpy(perm),
        torch.from_numpy(np.concatenate([p, q], 1)), 400)
    dup = ((tri[:, 0] == tri[:, 1]) | (tri[:, 1] == tri[:, 2])
           | (tri[:, 0] == tri[:, 2]))
    np.testing.assert_array_equal(disabled.numpy(),
                                  dup | (7 + np.arange(h) >= 400))
    # A repeated row leaves the rotation undetermined (any answer is
    # disabled); every distinct triple solves to the same pose.
    assert 0 < dup.sum() < h // 10
    np.testing.assert_allclose(w.numpy()[:, ~dup], np.asarray(w_ref)[:, ~dup],
                               atol=2e-5)
    np.testing.assert_allclose(tn.numpy()[~dup], np.asarray(tn_ref)[~dup],
                               atol=2e-6)


# --- The tensor-core kernels' arithmetic on the bench pair's FPFH
# descriptors and scoring factors, emulated (tests/tf32_emulation.py).


def test_k5_3xtf32_selection_on_fpfh(prepared_4096):
    """K5's descriptor route (packed operands, 3xTF32, splits) on the JAX
    package's FPFH descriptors against its nearest_neighbor on the CPU.
    d² within 1e-5 relative to max(d², 1): both round e = ‖t‖² − 2t·q,
    3xTF32 at ~2^-21 of Σ|t_k q_k| ≤ 1 (the histograms are L1-normalised).
    Differing picks must be float64 near-ties (≤ 1e-6): the two roundings
    may order near-equal candidates differently, nothing else."""
    from tf32_emulation import nn_3xtf32
    from tpu3d.ops.nn_pallas import nearest_neighbor as jax_nn

    _, _, sf, tf = prepared_4096
    q = np.asarray(sf.descriptors, np.float32)
    t = np.asarray(tf.descriptors, np.float32)
    mask = np.asarray(tf.mask)
    ji, jd = (np.asarray(a) for a in jax_nn(sf.descriptors, tf.descriptors,
                                            tf.mask))
    ei, ed = nn_3xtf32(_t(q), _t(t), _t(mask))
    ei, ed = ei.numpy(), ed.numpy()
    assert np.max(np.abs(ed - jd) / np.maximum(np.abs(jd), 1.0)) <= 1e-5
    rows = np.nonzero((ei != ji) & np.asarray(sf.mask))[0]
    tm = np.where(mask[:, None], t, 1e6).astype(np.float64)
    q64 = q.astype(np.float64)
    gap = np.abs(((tm[ei[rows]] - q64[rows]) ** 2).sum(1)
                 - ((tm[ji[rows]] - q64[rows]) ** 2).sum(1))
    assert rows.size == 0 or gap.max() <= 1e-6
    assert (ei == ji).mean() > 0.99


@pytest.fixture(scope="module")
def scoring_4096(prepared_4096):
    """The bench pair's scoring factors (JAX correspondences) and one
    rotation-sampler chunk of 4,096 hypotheses, as torch tensors."""
    from tpu3d.ops.ransac import feature_correspondences as jax_corr

    sd, td, sf, tf = prepared_4096
    corr = np.asarray(jax_corr(sf, tf))
    p = _t(np.asarray(sd.points))
    q = _t(np.asarray(td.points)[corr])
    mask = _t(np.asarray(sd.mask))
    feat, pq = ransac.build_scoring_factors(p, q, mask)
    count = int(mask.sum())
    table = ransac.build_rotation_table(torch.cat([p, q], 1), mask, count)
    draw = ransac.torch_draws(42)
    w16t, tn, _, _, _ = ransac.solve_rotation_chunk(
        lambda e: draw(0, e), 4096, 0, table, count, 10**9)
    feat_e, pq_e = ransac.build_scoring_factors(
        *(ransac.strided_rows(x, 1024) for x in (p, q, mask)))
    thr2 = float((np.float32(VOXEL) * np.float32(1.5)) ** 2)
    return {"rows": (feat, pq), "estimate": (feat_e, pq_e)}, w16t, tn, thr2


@pytest.mark.parametrize("rows,h", [("rows", 32), ("rows", 4096),
                                    ("estimate", 4096)])
def test_k6_band_recheck_gives_the_plain_inlier_sets(scoring_4096, rows, h):
    """K6's 3xTF32 scorer with the fp32 re-check inside the band around
    thr²: counts equal the plain version's on every hypothesis, and error
    sums agree within the expansion's cancellation noise. The band
    (BAND·(pq + 2)(‖t‖² + 3)) is at least four times the largest
    3xTF32-against-fp32 difference on these factors."""
    from tf32_emulation import score_3xtf32

    sets, w16t, tn, thr2 = scoring_4096
    feat, pq = sets[rows]
    w, t = w16t[:, :h].contiguous(), tn[:h].contiguous()
    pc, pe = ransac_score.score_hypotheses_plain(feat, pq, w, t, thr2)
    kc, ke, e_tc, e_32 = score_3xtf32(feat, pq, w, t, thr2)
    assert float(pc.max()) > 50
    np.testing.assert_array_equal(kc.numpy(), pc.numpy())
    assert torch.all((ke - pe).abs() <= 1e-4 * pe + 1e-5 * pc)
    valid = pq < 1e29
    scale = (pq[:, None] + 2.0) * (t[None, :] + 3.0)
    ratio = ((e_tc - e_32).abs() / scale)[valid]
    assert float(ratio.max()) <= ransac_score.BAND / 4
    near = ((e_tc - thr2).abs() <= ransac_score.band_margin(pq, t))[valid]
    assert float(near.float().mean()) < 0.02  # the re-check stays rare


@pytest.mark.parametrize("n,h", [(8192, 32), (2048, 25600), (77, 130),
                                 (1000, 1), (0, 5), (5190, 100000)])
def test_k6_slice_plan(n, h):
    rows, slices = ransac_score.slice_plan(n, h)
    assert rows % 32 == 0 and 32 <= rows <= 256
    assert slices == -(-n // rows)
    blocks = slices * -(-h // ransac_score.HYP_TILE)
    if (n, h) in ((8192, 32), (2048, 25600)):
        assert blocks >= 132  # both main-path shapes fill the card
