"""K10 (RANSAC's rotation-sampler hypotheses) and the chunk loop around it,
against the JAX package on the CPU.

K10's plain version (``ops/ransac.py`` ``rotation_hypotheses_plain``,
``qcp3_w16``) computes the 3-point QCP of ``tpu3d/ops/transforms.py``
``kabsch3_planes`` with every a·b + c of the JAX expression one fused
multiply-add and every other operation rounded once. XLA's CPU backend
contracts only products that its fused consumers do not share, and its
rsqrt is AVX-512's rsqrt14 estimate with two Newton steps, so neither
order is JAX's bit for bit. Measured here on the 20,000 seeded triples of
``test_k10_plain_against_jax_kabsch3_planes`` (half rigid with 1 mm
noise, half outliers; one torch thread): 24.4 % of the w16 elements and
0.73 % of whole columns bit for bit (the gather sampler's per-op solve,
``kabsch_quat``: 14.3 % and 0 %); 99.27 % of the columns within 1e-5
and 99.93 % within 1e-4, the median column's largest difference 1.8e-7
(per-op 2.4e-7); the largest differences (~1.2) are
near-degenerate samples (three nearly collinear points, two nearly tied
Horn eigenvalues), where both solutions are optima.
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bench import make_pair
from test_torch_ransac import JaxDraws
from tpu3d.config import RegistrationConfig as JaxConfig
from tpu3d.ops import ransac as jax_ransac_mod
from tpu3d.ops.transforms import kabsch3_planes as jax_kabsch3_planes
from tpu3d.registration import downsample_bucketed, prepare_features
from tpu3d.types import PointCloud as JaxCloud
from tpu3d_torch.ops import ransac
from tpu3d_torch.ops import transforms
from tpu3d_torch.types import FPFHFeatures, PointCloud
from torch_threads import one_torch_thread  # noqa: F401

VOXEL = 0.005


def _f32_round(x: fractions.Fraction) -> np.float32:
    """A rational rounded to the nearest float32, ties to even."""
    if x == 0:
        return np.float32(0.0)
    sign = -1 if x < 0 else 1
    x = abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while fractions.Fraction(2) ** e > x:
        e -= 1
    while fractions.Fraction(2) ** (e + 1) <= x:
        e += 1
    scale = fractions.Fraction(2) ** (max(e, -126) - 23)
    m = x / scale
    q, r = divmod(m.numerator, m.denominator)
    r2 = 2 * r
    if r2 > m.denominator or (r2 == m.denominator and q % 2 == 1):
        q += 1
    return np.float32(sign * float(q * scale))


def test_fma_is_rounded_once():
    """``_fma`` equals a·b + c computed exactly and rounded once to fp32,
    on random triples and on sums that cancel to near a rounding midpoint
    (where a float64 sum rounded again to fp32 would go wrong)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = rng.standard_normal(3000).astype(np.float32)
    # Cancelling sums: c = −fl(a·b) (+ an ulp), so a·b + c is the
    # product's rounding error, and c a hair off half an fp32 ulp of it.
    c[:1000] = -(a[:1000] * b[:1000])
    c[1000:2000] = np.nextafter(-(a[1000:2000] * b[1000:2000]), np.float32(0))
    half = np.float32(2.0) ** -24
    a[2000:2500] = np.float32(1.0) + half * 2
    b[2000:2500] = np.float32(1.0) + half * 2
    c[2000:2500] = np.float32(1.0)
    got = ransac._fma(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    F = fractions.Fraction
    want = np.array([_f32_round(F(float(x)) * F(float(y)) + F(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)


def _triples(h, seed):
    """(3, 6, h) f32 triples: half rigid motions of bin-scale points with
    1 mm noise, half outliers; and the rigid columns' mask."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(3, 3, h)) * 0.05
    ax = rng.normal(size=(h, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    th = rng.uniform(0, np.pi, h)
    K = np.zeros((h, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -ax[:, 2], ax[:, 1], -ax[:, 0]
    K = K - K.transpose(0, 2, 1)
    R = (np.eye(3) + np.sin(th)[:, None, None] * K
         + (1 - np.cos(th))[:, None, None] * K @ K)
    t = rng.normal(size=(h, 3)) * 0.2
    q = np.einsum("hij,shj->shi", R, p.transpose(0, 2, 1)).transpose(
        0, 2, 1) + t.T[None] + rng.normal(size=(3, 3, h)) * 1e-3
    rigid = rng.random(h) < 0.5
    q[:, :, ~rigid] = rng.normal(size=(3, 3, int((~rigid).sum()))) * 0.05
    return np.concatenate([p, q], axis=1).astype(np.float32), rigid


@jax.jit
def _jax_w16(x):
    """JAX's kabsch3_planes and solve_rotation_chunk's w16 packing, as XLA
    compiles them: (16, h) with ‖t‖² in row 15."""
    ps = tuple((x[k, 0], x[k, 1], x[k, 2]) for k in range(3))
    qs = tuple((x[k, 3], x[k, 4], x[k, 5]) for k in range(3))
    r, t = jax_kabsch3_planes(ps, qs)
    u = tuple(r[j] * t[0] + r[3 + j] * t[1] + r[6 + j] * t[2]
              for j in range(3))
    tn = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
    return jnp.stack(list(u) + list(t) + list(r) + [tn])


def _port_w16(x, fn):
    """(16, h) with ‖t‖² in row 15: K10's solve, or the gather sampler's
    per-op one (``kabsch_quat`` and ``pack_hypotheses``)."""
    tx = torch.from_numpy(x)
    if fn == "k10":
        P = [[tx[s, c] for c in range(3)] for s in range(3)]
        Q = [[tx[s, 3 + c] for c in range(3)] for s in range(3)]
        w, tn = ransac.qcp3_w16(P, Q)
    else:
        R, t = transforms.kabsch_quat(tx[:, :3].permute(2, 0, 1),
                                      tx[:, 3:].permute(2, 0, 1))
        w, tn = ransac.pack_hypotheses(R, t)
    return torch.cat([w[:15], tn[None]]).numpy()


def test_k10_plain_against_jax_kabsch3_planes():
    """K10's plain solve against XLA's compiled kabsch3_planes: 98 % of
    the columns within 1e-5 and 99.8 % within 1e-4, the rigid ones and
    all (98.7 % and 99.86 % of the rigid ones measured), and more elements
    bit for bit than the per-op order (module docstring)."""
    x, rigid = _triples(20000, 0)
    ref = np.asarray(_jax_w16(x))
    got = _port_w16(x, "k10")
    per_op = _port_w16(x, "per_op")
    d = np.abs(got - ref).max(0)
    assert np.isfinite(got).all()
    for cols in (rigid, slice(None)):
        assert (d[cols] <= 1e-5).mean() >= 0.98
        assert (d[cols] <= 1e-4).mean() >= 0.998
    share = (got == ref).mean()
    assert share > (per_op == ref).mean()
    assert share > 0.2


def test_rotation_chunk_matches_jax(rng):
    """solve_rotation_chunk on a table with padding rows, from JAX's draws:
    the disabled flags, the ids and the ids consumed equal JAX's; the w16
    columns as in the test above."""
    n, count, h = 1024, 1000, 3000
    p = (rng.random((n, 3)) * 0.2).astype(np.float32)
    q = (p[:, [1, 0, 2]] + 0.03).astype(np.float32)
    q[::3] = rng.random((len(q[::3]), 3)).astype(np.float32) * 0.2
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:count]] = True
    pq = np.concatenate([p, q], 1)
    jt = jax_ransac_mod.build_rotation_table(jnp.asarray(pq),
                                             jnp.asarray(mask), count)
    tt = ransac.build_rotation_table(torch.from_numpy(pq),
                                     torch.from_numpy(mask), count)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    draws = JaxDraws(42)
    kc = jax.random.fold_in(draws.hyp_key, 3)
    solve = jax.jit(jax_ransac_mod.solve_rotation_chunk,
                    static_argnums=(1,))
    jw, jtn, jd, jids, jcons = solve(kc, h, 700, jt, count, 4000)
    w, tn, dis, ids, cons = ransac.solve_rotation_chunk(
        lambda e: draws(3, e), h, 700, tt, count, 4000)
    np.testing.assert_array_equal(dis.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert cons == int(jcons)
    live = ~dis.numpy()
    assert live.sum() > 1000
    d = np.abs(w.numpy() - np.asarray(jw))[:, live].max(0)
    assert (d <= 1e-4).mean() >= 0.998
    np.testing.assert_allclose(tn.numpy()[live], np.asarray(jtn)[live],
                               atol=1e-4)


@pytest.fixture(scope="module")
def prepared_8192():
    src, tgt, _, _ = make_pair(8192, voxel=VOXEL)
    cfg = JaxConfig(voxel_size=VOXEL)
    sd = downsample_bucketed(JaxCloud.from_numpy(src), cfg)
    td = downsample_bucketed(JaxCloud.from_numpy(tgt), cfg)
    assert sd.capacity == td.capacity == 8192
    sd, sf = prepare_features(sd, cfg, "auto")
    td, tf = prepare_features(td, cfg, "auto")
    return sd, td, sf, tf


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_chunk_trace(sd, td, sf, tf, iters, confidence, est_cap):
    """JAX's chunked rotation route stepped on the host with its own
    functions (ransac_registration's while_loop body, with the estimate
    stage where n ≥ 2·est_cap): (chunks run, iteration ids consumed)."""
    m = jax_ransac_mod
    n = sd.capacity
    h = max(16384, (-(-iters // 4) + 1023) // 1024 * 1024)
    thr2 = (jnp.float32(VOXEL) * 1.5) ** 2
    corr = m.feature_correspondences(sf, tf)
    p, q, mask = sd.points, td.points[corr], sd.mask
    count = int(mask.sum())
    pq2p = m.build_rotation_table(jnp.concatenate([p, q], 1), mask, count)
    st = m.decimation_stride(n, est_cap) if n >= 2 * est_cap else 1
    rows = slice(0, st * min(est_cap, n), st)
    feat, pq = m.build_scoring_factors(p[rows], q[rows], mask[rows])
    n_valid = jnp.maximum(jnp.sum(mask[rows].astype(jnp.float32)), 1.0)
    cons = (h // n) * count + min(h % n, count)
    bound = (iters + cons - 1) // cons
    solve = jax.jit(m.solve_rotation_chunk, static_argnums=(1,))
    hyp_key = JaxDraws(42).hyp_key
    c, fid, done = 0, 0, False
    while c == 0 or (c < bound and fid < iters and not done):
        w16t, tn, dis, _, n_cons = solve(jax.random.fold_in(hyp_key, c), h,
                                         fid, pq2p, count, iters)
        cnt, _ = m.score_w16(feat, pq, w16t, tn, thr2)
        fitness = jnp.where(dis, -1.0, cnt / n_valid)
        done = bool(jnp.any(fitness > confidence))
        fid += int(n_cons)
        c += 1
    return c, fid


class _HostReads(TorchDispatchMode):
    """Counts the reads of a tensor value back to the host
    (``aten._local_scalar_dense``: ``bool()``, ``float()``, ``.item()``)."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def _port_inputs(prepared):
    sd, td, sf, tf = prepared
    return (PointCloud(points=_t(sd.points), mask=_t(sd.mask)),
            PointCloud(points=_t(td.points), mask=_t(td.mask)),
            FPFHFeatures(descriptors=_t(sf.descriptors), mask=_t(sf.mask)),
            FPFHFeatures(descriptors=_t(tf.descriptors), mask=_t(tf.mask)))


@pytest.mark.parametrize("confidence,est_cap,winner", [
    (0.999, 8192, True), (0.35, 2048, True), (0.999, 2048, False)])
def test_chunks_replay_jax_on_bucket_8192(prepared_8192, confidence,
                                          est_cap, winner):
    """On the bucket-8,192 pair with JAX's draws injected (60,000
    iterations): the same chunks run (the early exit's chunk, or the
    budget's last) and the same iteration ids consumed as JAX's loop, and
    JAX's winner (pose within 1e-5, the same fitness) where every chunk is
    scored exactly (est_cap 8,192) or the exit comes in the first chunk.
    Through four chunks of the estimate stage (2,048 rows) the winner is
    another: integer counts on 2,048 rows tie often, and a hypothesis a
    few ulp off JAX's reorders the top 32 that are rescored exactly;
    there the port's winner scores at least JAX's, in its basin."""
    iters = 60000
    ref = jax_ransac_mod.ransac_registration(
        *prepared_8192, VOXEL, max_iterations=iters, confidence=confidence,
        est_cap=est_cap)
    jax_chunks, jax_ids = _jax_chunk_trace(*prepared_8192, iters,
                                           confidence, est_cap)
    drawn = []

    class Recorder(JaxDraws):
        def __call__(self, c, e):
            drawn.append(c)
            return super().__call__(c, e)

    got = ransac.ransac_registration(
        *_port_inputs(prepared_8192), VOXEL, max_iterations=iters,
        confidence=confidence, est_cap=est_cap, draws=Recorder(42))
    chunks = sorted(set(drawn))
    assert chunks == list(range(jax_chunks))
    count = int(np.asarray(prepared_8192[0].mask).sum())
    h = ransac.hypothesis_chunk(iters)
    assert len(chunks) * ((h // 8192) * count
                          + min(h % 8192, count)) == jax_ids
    T, T_ref = got.transformation.numpy(), np.asarray(ref.transformation)
    if winner:
        np.testing.assert_allclose(T, T_ref, atol=1e-5)
        assert float(got.fitness) == float(ref.fitness)
    else:
        assert float(got.fitness) >= float(ref.fitness)
        np.testing.assert_allclose(T, T_ref, atol=5e-3)


def test_one_host_read_a_chunk(prepared_8192):
    """No host read inside a chunk's body; the chunk loop reads one exit
    flag a chunk (a run of every chunk of the budget against a run of
    the fewest chunks)."""
    inside = _HostReads()
    step = ransac._ChunkBody.rotation_step

    def guarded_step(body):
        with inside:
            step(body)

    src, tgt, fs, ft = _port_inputs(prepared_8192)
    count = int(src.mask.sum())
    h = ransac.hypothesis_chunk(60000)
    cons = (h // 8192) * count + min(h % 8192, count)
    reads = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ransac._ChunkBody, "rotation_step", guarded_step)
        for iters in (60000, h + 1):
            mode = _HostReads()
            with mode:
                ransac.ransac_registration(
                    src, tgt, fs, ft, VOXEL, max_iterations=iters,
                    confidence=1.0, hyp_chunk=h, draws=JaxDraws(42))
            reads[-(-iters // cons)] = mode.reads
    assert inside.reads == 0
    (few, r_few), (many, r_many) = sorted(reads.items())
    assert many > few >= 1
    assert r_many - r_few == many - few
