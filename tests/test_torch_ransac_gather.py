"""K11 (RANSAC's gather-sampler hypotheses) and the gather chunk around it,
against the JAX package on the CPU.

K11's plain version (``ops/ransac.py`` ``gather_hypotheses_plain``) is
the gather sampler's eager solve, ``kabsch_quat`` and
``pack_hypotheses``, with each operation rounded once on either device:
every division by a device scalar, 1/√x a square root and a division
(``transforms.rsqrt_div``), which is what ``torch.rsqrt`` computes on the
CPU. So on the CPU it is the eager body it replaces, bit for bit. Measured
here on the 20,000 seeded triples of ``_samples`` (half rigid with 1 mm
noise, half outliers; then 500 each with coincident points, with
collinear points and with a repeated draw; one torch thread), against
XLA's compiled ``kabsch_quat`` + ``pack_hypotheses``: 13.2 % of the w16
elements (‖t‖² in place of the zero row) bit for bit, no whole column;
the median column's largest difference 2.7e-7; the rigid columns 98.7 %
within 1e-5 and 99.8 % within 1e-4 (18 beyond, up to 1.57: nearly
collinear samples with two nearly tied Horn eigenvalues, where both
solutions are optima); the outlier columns 99.8 % within 1e-5, all
within 2.8e-5; the degenerate ones ~3e-3 apart at the median (the
rotation is undetermined there).

A correctly rounded 1/√x (``__frsqrt_rn``) was measured first: 15.6 % of
the elements bit for bit to JAX's, but it moved 53.1 % of them against
the eager body (an ulp in 1/√x passes through the Rayleigh polish into
every entry) and the coarse pose with them, and
``test_multiscale_matches_jax[False-3]`` then missed its 1e-6 by 1.3e-6
(ICP's stop flips on an ulp of its start, ROADMAP section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bench import make_pair
from test_torch_ransac import JaxDraws
from tpu3d.config import RegistrationConfig as JaxConfig
from tpu3d.ops.ransac import pack_hypotheses as jax_pack
from tpu3d.ops.ransac import ransac_registration as jax_ransac
from tpu3d.ops.transforms import kabsch_quat as jax_kabsch_quat
from tpu3d.registration import downsample_bucketed, prepare_features
from tpu3d.types import PointCloud as JaxCloud
from tpu3d_torch.ops import ransac, transforms
from tpu3d_torch.types import FPFHFeatures, PointCloud
from torch_threads import one_torch_thread  # noqa: F401

VOXEL = 0.005


def _samples(h, seed):
    """(pq (3h, 6) f32 rows, triples (h, 3) i64, kinds (h,) str): sample i
    reads rows 3i, 3i+1, 3i+2 (half rigid motions of bin-scale points
    with 1 mm noise, half outliers), then 500 samples each with two
    coincident points, with three collinear points, and with a repeated
    draw."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(h, 3, 3)) * 0.05
    ax = rng.normal(size=(h, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    th = rng.uniform(0, np.pi, h)
    K = np.zeros((h, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -ax[:, 2], ax[:, 1], -ax[:, 0]
    K = K - K.transpose(0, 2, 1)
    R = (np.eye(3) + np.sin(th)[:, None, None] * K
         + (1 - np.cos(th))[:, None, None] * K @ K)
    t = rng.normal(size=(h, 1, 3)) * 0.2
    q = p @ R.transpose(0, 2, 1) + t + rng.normal(size=(h, 3, 3)) * 1e-3
    kinds = np.where(rng.random(h) < 0.5, "rigid", "outlier").astype(object)
    out = kinds == "outlier"
    q[out] = rng.normal(size=(int(out.sum()), 3, 3)) * 0.05
    tri = np.arange(3 * h).reshape(h, 3)
    lo = h - 1500
    p[lo:lo + 500, 1], q[lo:lo + 500, 1] = p[lo:lo + 500, 0], q[lo:lo + 500, 0]
    kinds[lo:lo + 500] = "coincident"
    mid = slice(lo + 500, lo + 1000)
    p[mid, 2] = p[mid, 0] + 0.5 * (p[mid, 1] - p[mid, 0])
    q[mid, 2] = q[mid, 0] + 0.5 * (q[mid, 1] - q[mid, 0])
    kinds[mid] = "collinear"
    tri[lo + 1000:, 1] = tri[lo + 1000:, 0]
    kinds[lo + 1000:] = "repeated"
    pq = np.concatenate([p, q], axis=2).reshape(3 * h, 6).astype(np.float32)
    return pq, tri, kinds


@jax.jit
def _jax_w16(s6):
    """JAX's kabsch_quat and pack_hypotheses as XLA compiles them: (16, h)
    with ‖t‖² in row 15."""
    R, t = jax_kabsch_quat(s6[..., :3], s6[..., 3:])
    w, tn = jax_pack(R, t)
    return jnp.concatenate([w[:15], tn[None]])


def _port_w16(pq, tri, first_id=0, max_it=10**9):
    """(16, h) with ‖t‖² in row 15, and the disabled flags: K11's plain
    version through the wrapper, on the CPU."""
    h = tri.shape[0]
    params = ransac.gather_params(torch.from_numpy(tri), first_id, max_it,
                                  pq.shape[0])
    w, tn, dis = ransac.gather_hypotheses(
        params, torch.arange(pq.shape[0]), torch.from_numpy(pq), h)
    return torch.cat([w[:15], tn[None]]).numpy(), dis.numpy()


@pytest.fixture(scope="module")
def samples():
    """The 20,000 triples, JAX's (16, h) for them, and K11's plain
    version's with its flags."""
    pq, tri, kinds = _samples(20000, 0)
    ref = np.asarray(_jax_w16(jnp.asarray(pq[tri])))
    got, dis = _port_w16(pq, tri)
    return pq, tri, kinds, ref, got, dis


def test_k11_plain_against_jax_kabsch_quat(samples):
    """K11's plain version against XLA's compiled kabsch_quat +
    pack_hypotheses on 20,000 triples, degenerate ones included: the
    flags are the repeated draws, every element finite, the rigid and
    outlier columns 99 % within 1e-5 and 99.8 % within 1e-4, the outlier
    ones all within 1e-4, at least 13 % of the elements bit for bit
    (module docstring), coincident points still a rotation."""
    _, _, kinds, ref, got, dis = samples
    np.testing.assert_array_equal(dis, kinds == "repeated")
    assert np.isfinite(got).all()
    d = np.abs(got - ref).max(0)
    regular = np.isin(kinds, ("rigid", "outlier"))
    assert (d[regular] <= 1e-5).mean() >= 0.99
    assert (d[regular] <= 1e-4).mean() >= 0.998
    assert d[kinds == "outlier"].max() <= 1e-4
    assert (got == ref).mean() >= 0.13
    R = got[6:15, kinds == "coincident"].T.reshape(-1, 3, 3).astype(
        np.float64)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_k11_plain_is_the_eager_body_on_the_cpu(samples, monkeypatch):
    """With ``torch.rsqrt`` in place of ``rsqrt_div`` the solve is the
    eager body K11 replaces: on the CPU not one element moves."""
    pq, tri, _, _, new, _ = samples
    monkeypatch.setattr(transforms, "rsqrt_div", torch.rsqrt)
    old, _ = _port_w16(pq, tri)
    np.testing.assert_array_equal(new, old)


def test_rsqrt_div_rounds_twice_as_the_cpu_does():
    """``rsqrt_div`` is √x rounded to fp32, then 1 over it rounded
    (computed exactly to 60 digits here), and equals ``torch.rsqrt`` on
    the CPU bit for bit, on random values, subnormals, exact squares and
    powers of 4; 0 → inf and inf → 0."""
    import decimal
    import fractions

    from test_torch_ransac_hyp import _f32_round

    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(1e-30, 1e30, 500),
                        rng.uniform(0.5, 2.0, 500),
                        rng.uniform(1e-42, 1e-38, 100),
                        rng.integers(1, 4096, 200) ** 2.0,
                        4.0 ** np.arange(-20, 20)]).astype(np.float32)
    got = transforms.rsqrt_div(torch.from_numpy(x)).numpy()
    decimal.getcontext().prec = 60
    F = fractions.Fraction
    want = [_f32_round(1 / F(float(_f32_round(F(
        decimal.Decimal(float(v)).sqrt()))))) for v in x]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    np.testing.assert_array_equal(got, torch.rsqrt(torch.from_numpy(x)))
    edge = transforms.rsqrt_div(torch.tensor([0.0, float("inf")])).tolist()
    assert edge == [float("inf"), 0.0]


def test_gather_params_layout_and_checks():
    """[first_id, budget, triples row by row] as int32; a draw outside the
    rows of perm is refused; the wrapper refuses mismatched operands."""
    tri = torch.tensor([[0, 1, 2], [3, 3, 4]])
    prm = ransac.gather_params(tri, 7, 9, 5)
    assert prm.dtype == torch.int32 and not prm.is_pinned()
    assert prm.tolist() == [7, 9, 0, 1, 2, 3, 3, 4]
    for bad in ([[0, 1, 5]], [[-1, 0, 1]]):
        with pytest.raises(ValueError):
            ransac.gather_params(torch.tensor(bad), 0, 9, 5)
    pq = torch.zeros(5, 6)
    with pytest.raises(ValueError):
        ransac.gather_hypotheses(prm[:-1], torch.arange(5), pq, 2)
    with pytest.raises(ValueError):
        ransac.gather_hypotheses(prm, torch.arange(4), pq, 2)
    w, tn, dis = ransac.gather_hypotheses(prm, torch.arange(5), pq, 2)
    assert w.shape == (16, 2) and dis.tolist() == [False, True]
    # Ids first_id + j at or past the budget are disabled.
    prm = ransac.gather_params(torch.tensor([[0, 1, 2]] * 4), 7, 9, 5)
    dis = ransac.gather_hypotheses(prm, torch.arange(5), pq, 4)[2]
    assert dis.tolist() == [False, False, True, True]


@pytest.fixture(scope="module")
def prepared_4096():
    src, tgt, _, _ = make_pair(4096, voxel=VOXEL)
    cfg = JaxConfig(voxel_size=VOXEL)
    sd = downsample_bucketed(JaxCloud.from_numpy(src), cfg)
    td = downsample_bucketed(JaxCloud.from_numpy(tgt), cfg)
    sd, sf = prepare_features(sd, cfg, "auto")
    td, tf = prepare_features(td, cfg, "auto")
    return sd, td, sf, tf


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_inputs(prepared):
    sd, td, sf, tf = prepared
    return (PointCloud(points=_t(sd.points), mask=_t(sd.mask)),
            PointCloud(points=_t(td.points), mask=_t(td.mask)),
            FPFHFeatures(descriptors=_t(sf.descriptors), mask=_t(sf.mask)),
            FPFHFeatures(descriptors=_t(tf.descriptors), mask=_t(tf.mask)))


class _HostReads(TorchDispatchMode):
    """Counts the reads of a tensor value back to the host."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kw", [
    dict(max_iterations=20000, confidence=1.0, corr_cap=1024),
    dict(max_iterations=30000, confidence=1.0, sampling="gather",
         corr_mode="exact", est_cap=1024),
], ids=["below 2048 rows", "sampling gather, estimate stage"])
def test_gather_chunk_steps_replay_jax(prepared_4096, kw):
    """The gather chunk as the graph runs it, called eagerly on the CPU:
    one ``chunk_step`` (K11 → K6 → champion) a chunk with no host read
    inside it, K11's wrapper once a chunk, and JAX's winner from its
    draws (the pose within 1e-5, the same inlier count)."""
    sd = prepared_4096[0]
    steps, k11 = _HostReads(), []
    chunk_step = ransac._ChunkBody.chunk_step
    wrapper = ransac.gather_hypotheses

    def guarded(body):
        with steps:
            chunk_step(body)

    def counted(*a):
        k11.append(a[-1])
        return wrapper(*a)

    drawn = []

    class Recorder(JaxDraws):
        def triples(self, c, h, count):
            drawn.append(c)
            return super().triples(c, h, count)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ransac._ChunkBody, "chunk_step", guarded)
        mp.setattr(ransac, "gather_hypotheses", counted)
        got = ransac.ransac_registration(*_port_inputs(prepared_4096), VOXEL,
                                         draws=Recorder(42), **kw)
    ref = jax_ransac(*prepared_4096, VOXEL, **kw)
    h = ransac.hypothesis_chunk(kw["max_iterations"])
    assert drawn == list(range(-(-kw["max_iterations"] // h)))
    assert k11 == [h] * len(drawn) and steps.reads == 0
    np.testing.assert_allclose(got.transformation.numpy(),
                               np.asarray(ref.transformation), atol=1e-5)
    mask = np.asarray(sd.mask)
    if "corr_cap" in kw:
        st = ransac.decimation_stride(4096, kw["corr_cap"])
        mask = mask[: st * kw["corr_cap"]: st]
    n_valid = int(mask.sum())
    assert round(float(got.fitness) * n_valid) == round(
        float(ref.fitness) * n_valid)
    assert float(got.fitness) > 0.3


def test_one_shot_and_two_stage_solve_once(prepared_4096):
    """The one shot and the two-stage route solve every hypothesis in one
    K11 call, on the padded budget drawn from the one-shot stream."""
    k11 = []
    wrapper = ransac.gather_hypotheses

    def counted(*a):
        k11.append(a[-1])
        return wrapper(*a)

    inputs = _port_inputs(prepared_4096)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ransac, "gather_hypotheses", counted)
        for kw in (dict(max_iterations=3000), dict(max_iterations=3000,
                                                   two_stage=True)):
            k11.clear()
            res = ransac.ransac_registration(*inputs, VOXEL,
                                             corr_mode="exact",
                                             draws=JaxDraws(42), **kw)
            assert k11 == [3072] and float(res.fitness) > 0.3
