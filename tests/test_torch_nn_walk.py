"""slab2 walk NN port parity: ``tpu3d_torch.ops.nn_walk`` against
``tpu3d/ops/nn_walk.py`` (its Pallas kernel K8 in interpret mode) on the
same inputs, through the plain version of K8.

Tolerances. The indices must be equal on every row, rows without a match
included (they carry the walk's last improvement); a differing row is
allowed only at a float64 near-tie of the two picks. The port computes
d² = (dx² + dy²) + dz² rounding each operation once, as K8 does; XLA on
the CPU contracts the JAX kernel's sum into two FMAs, dz·dz + (dx·dx +
dy²), which moves d² by at most 2 ulp. So d² is held within 2 ulp of
JAX's and bit for bit to the separately rounded sum at the returned row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.ops import nn_walk as jnn_walk
from tpu3d_torch.models.fixtures import make_pair
from tpu3d_torch.ops import nn_walk
from torch_threads import one_torch_thread  # noqa: F401

D2_ULP = 2


def _ulp_diff(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _separately_rounded(q, t, idx):
    d = t[idx] - q
    return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]


def assert_matches_jax(q, qm, t, tm, got, ref):
    """Index on every row (near-ties aside), d² within D2_ULP of JAX's and
    equal to the separately rounded sum where a target matched. Invalid
    queries walk their block's windows from the sentinel coordinate 3e4,
    where fp32 d² values a few ulp apart tie in float64 terms too."""
    idx, d2 = (x.numpy() for x in got)
    jidx, jd2 = (np.asarray(x) for x in ref)
    assert idx.dtype == np.int32 and d2.dtype == np.float32
    matched = jd2 < 1e29
    np.testing.assert_array_equal(d2 < 1e29, matched)
    diff = idx != jidx
    if diff.any():
        walked = np.where(qm[:, None], q, np.float32(3.0e4))
        q64, t64 = walked[diff].astype(np.float64), t.astype(np.float64)
        gap = np.abs(((t64[idx[diff]] - q64) ** 2).sum(1)
                     - ((t64[jidx[diff]] - q64) ** 2).sum(1))
        scale = ((t64[jidx[diff]] - q64) ** 2).sum(1)
        assert np.all(gap <= 2.0 ** -21 * scale), gap.max()
    assert _ulp_diff(d2[matched], jd2[matched]).max(initial=0) <= D2_ULP
    np.testing.assert_array_equal(
        d2[matched], _separately_rounded(q[matched], t, idx[matched]))
    assert np.all(tm[idx[matched]])
    return matched


def _run(q, qm, t, tm, r, **kw):
    ref = jnn_walk.slab2_top1(jnp.asarray(q), jnp.asarray(qm),
                              jnp.asarray(t), jnp.asarray(tm),
                              jnp.float32(r), interpret=True, **kw)
    got = nn_walk.slab2_top1(torch.from_numpy(q), torch.from_numpy(qm),
                             torch.from_numpy(t), torch.from_numpy(tm),
                             np.float32(r), **kw)
    return got, ref


def _brute(q, qm, t, tm, r):
    d2 = ((q[:, None, :].astype(np.float64)
           - t[None, :, :].astype(np.float64)) ** 2).sum(-1)
    d2 = np.where(tm[None, :], d2, np.inf)
    best = d2.min(1)
    return np.where(qm & (best <= float(np.float32(r)) ** 2), best, np.inf)


@pytest.mark.parametrize("block,sub,k_windows", [
    (128, 128, 10), (128, 128, 8), (256, 256, 8), (512, 512, 8),
    (512, 512, 10), (256, 128, 3)])
def test_slab2_top1_matches_jax(block, sub, k_windows):
    rng = np.random.default_rng(block + k_windows)
    nq, nt = 1500, 2000
    q = rng.uniform(-0.3, 0.3, (nq, 3)).astype(np.float32)
    t = rng.uniform(-0.3, 0.3, (nt, 3)).astype(np.float32)
    qm = np.ones(nq, bool)
    qm[::17] = False
    tm = np.ones(nt, bool)
    tm[::13] = False
    r = 0.05
    got, ref = _run(q, qm, t, tm, r, block=block, sub=sub,
                    k_windows=k_windows)
    matched = assert_matches_jax(q, qm, t, tm, got, ref)
    assert 0 < matched.sum() < qm.sum()  # matches and no-matches both
    # Against float64 brute force: the same matched set and distances.
    bd = _brute(q, qm, t, tm, r)
    np.testing.assert_array_equal(matched, np.isfinite(bd))
    np.testing.assert_allclose(got[1].numpy()[matched], bd[matched],
                               rtol=1e-6)


def test_slab2_top1_ties_go_to_the_lowest_sorted_row():
    """Duplicated targets: every query's pick is the duplicate that sorts
    first, in both packages."""
    rng = np.random.default_rng(3)
    base = rng.uniform(-0.2, 0.2, (300, 3)).astype(np.float32)
    t = np.concatenate([base, base, base])
    tm = np.ones(len(t), bool)
    q = (base + rng.normal(0, 0.002, base.shape)).astype(np.float32)
    qm = np.ones(len(q), bool)
    got, ref = _run(q, qm, t, tm, 0.01, block=128, sub=128, k_windows=10)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert_matches_jax(q, qm, t, tm, got, ref)


def test_slab2_top1_no_matches():
    rng = np.random.default_rng(5)
    q = rng.uniform(10.0, 11.0, (200, 3)).astype(np.float32)
    t = rng.uniform(-0.3, 0.3, (300, 3)).astype(np.float32)
    got, ref = _run(q, np.ones(200, bool), t, np.ones(300, bool), 0.05,
                    block=128, sub=128)
    assert np.all(got[1].numpy() >= 1e29)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))


def test_slab2_top1_degenerate_x():
    rng = np.random.default_rng(9)
    n = 400
    t = np.zeros((n, 3), np.float32)
    t[:, 1:] = rng.uniform(-0.2, 0.2, (n, 2)).astype(np.float32)
    q = (t + rng.normal(0, 0.004, (n, 3))).astype(np.float32)
    qm = np.ones(n, bool)
    tm = np.ones(n, bool)
    got, ref = _run(q, qm, t, tm, 0.03, block=128, sub=128)
    matched = assert_matches_jax(q, qm, t, tm, got, ref)
    bd = _brute(q, qm, t, tm, 0.03)
    np.testing.assert_array_equal(matched, np.isfinite(bd))


def test_build_walk_target_matches_jax():
    rng = np.random.default_rng(1)
    t = rng.uniform(-0.3, 0.3, (3000, 3)).astype(np.float32)
    tm = rng.uniform(size=3000) > 0.1
    r = np.float32(0.002)
    ref = jnn_walk.build_walk_target(jnp.asarray(t), jnp.asarray(tm), r)
    got = nn_walk.build_walk_target(torch.from_numpy(t),
                                    torch.from_numpy(tm), r)
    for field in ref._fields:
        a = np.asarray(getattr(ref, field))
        b = getattr(got, field).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, field
        np.testing.assert_array_equal(b, a, err_msg=field)


def test_slab2_top1_indexed_on_a_prebuilt_target():
    rng = np.random.default_rng(2)
    t = rng.uniform(-0.2, 0.2, (2500, 3)).astype(np.float32)
    tm = np.ones(2500, bool)
    tm[-100:] = False
    r = np.float32(0.03)
    jwt = jnn_walk.build_walk_target(jnp.asarray(t), jnp.asarray(tm), r)
    wt = nn_walk.build_walk_target(torch.from_numpy(t), torch.from_numpy(tm),
                                   r)
    for seed in range(2):  # one target, two query sets
        q = rng.uniform(-0.2, 0.2, (700 + seed * 300, 3)).astype(np.float32)
        qm = rng.uniform(size=len(q)) > 0.05
        ref = jnn_walk.slab2_top1_indexed(jwt, jnp.asarray(q),
                                          jnp.asarray(qm), r, block=256,
                                          sub=256, k_windows=8,
                                          interpret=True)
        got = nn_walk.slab2_top1_indexed(wt, torch.from_numpy(q),
                                         torch.from_numpy(qm), r, block=256,
                                         sub=256, k_windows=8)
        assert_matches_jax(q, qm, t, tm, got, ref)


def test_slab2_top1_on_the_bench_fixture():
    """The slice as a whole: the bench's 1M-scene call (block 512, sub
    512, k_windows 8) on make_pair(16384), source against target at a
    radius that matches part of the rows."""
    src, tgt, _, _ = make_pair(16384, seed=5)
    m = np.ones(16384, bool)
    got, ref = _run(src, m, tgt, m, 0.006, block=512, sub=512, k_windows=8)
    matched = assert_matches_jax(src, m, tgt, m, got, ref)
    assert 0 < matched.sum() < 16384


def test_top1_walk_checks_its_inputs():
    q4 = torch.zeros(4, 512)
    packed = torch.zeros(4, 100)
    lo = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="block"):
        nn_walk.top1_walk(q4, packed, lo, lo, 1e-4, 64)
    with pytest.raises(TypeError):
        nn_walk.top1_walk(q4.double(), packed.double(), lo, lo, 1e-4, 128)
    with pytest.raises(ValueError, match="2\\^24"):
        nn_walk.top1_walk(q4, torch.zeros(4, 1).expand(4, 1 << 24), lo, lo,
                          1e-4, 128)
    with pytest.raises(ValueError, match="K must"):
        big = torch.zeros(4, 17, dtype=torch.int32)
        nn_walk.top1_walk(q4, packed, big, big, 1e-4, 128)
