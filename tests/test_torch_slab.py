"""slab_top1 port parity: ``tpu3d_torch.ops.slab.slab_top1`` (plain
PyTorch, chunked over blocks) against ``tpu3d/ops/slab.py`` on the same
inputs: the original-row indices on every row, d² and the overflow flag.

XLA on the CPU may contract the JAX version's Σ(q − t)² into FMAs, so d²
is held within 2 ulp of JAX's, and bit for bit to the separately rounded
(dx² + dy²) + dz² at the returned row; a differing index is allowed only
at a float64 near-tie of the two picks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.ops import slab as jslab
from tpu3d_torch.ops import slab
from torch_threads import one_torch_thread  # noqa: F401


def _surface(rng, n):
    xy = rng.uniform(-0.4, 0.4, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.05 * np.sin(20 * xy[:, 0]) * np.cos(18 * xy[:, 1])
    pts = np.column_stack([xy, z]).astype(np.float32)
    return pts[np.argsort(pts[:, 0], kind="stable")]


# (targets, queries, valid targets, radius, slice_cap, block)
CASES = {
    "exact": (3000, 3000, 2900, 0.01, 1024, 128),
    "overflow": (2000, 2000, 2000, 0.2, 256, 128),
    # slice_cap near M: the blocks at the end clamp their start below lo;
    # 1,000 queries are not a whole number of blocks (padded queries).
    "start-clamp": (1500, 1000, 1450, 0.02, 1024, 256),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_top1_matches_jax(case):
    nt, nq, nvalid, radius, cap, block = CASES[case]
    rng = np.random.default_rng(nt + nq)
    t = _surface(rng, nt)
    mask = np.arange(nt) < nvalid
    q = (t[np.linspace(0, nt - 1, nq).astype(int)]
         + rng.normal(scale=0.004, size=(nq, 3))).astype(np.float32)
    js = jslab.build_slab(jnp.asarray(t), jnp.asarray(mask))
    jidx, jd2, jovf = (np.asarray(x) for x in jslab.slab_top1(
        js, jnp.asarray(q), radius, slice_cap=cap, block=block))
    ts = slab.build_slab(torch.from_numpy(t), torch.from_numpy(mask))
    idx, d2, ovf = slab.slab_top1(ts, torch.from_numpy(q), radius,
                                  slice_cap=cap, block=block)
    idx, d2 = idx.numpy(), d2.numpy()
    assert bool(ovf) == bool(jovf) == (case == "overflow")
    matched = jd2 < 1e29
    np.testing.assert_array_equal(d2 < 1e29, matched)
    assert 0 < matched.sum()
    diff = idx != jidx
    if diff.any():
        q64, t64 = q[diff].astype(np.float64), t.astype(np.float64)
        a = ((t64[idx[diff]] - q64) ** 2).sum(1)
        b = ((t64[jidx[diff]] - q64) ** 2).sum(1)
        assert np.all(np.abs(a - b) <= 2.0 ** -21 * b), np.abs(a - b).max()
    ulp = np.abs(d2[matched].view(np.int32).astype(np.int64)
                 - jd2[matched].view(np.int32).astype(np.int64))
    assert ulp.max() <= 2
    dd = q[matched] - t[idx[matched]]
    np.testing.assert_array_equal(
        d2[matched],
        (dd[:, 0] * dd[:, 0] + dd[:, 1] * dd[:, 1]) + dd[:, 2] * dd[:, 2])
    if case == "start-clamp":
        lo, _ = slab.block_slices(ts, torch.from_numpy(
            np.pad(q, ((0, (-nq) % block), (0, 0)),
                   constant_values=2.9e4)).reshape(-1, block, 3)[..., 0],
            radius)
        assert int(lo.max()) > nt - cap  # some start is clamped


def _hold_knn(q, t, idx, d2, jidx, jd2):
    """slab_knn/grid_knn parity: the gated slots (d² ≥ 1e30) equal; d²
    within 2 ulp of JAX's (XLA's FMA contraction) and bit for bit the
    separately rounded (dx² + dy²) + dz² at the returned rows; a differing
    index only at a float64 near-tie (2⁻²¹ relative) of the two picks."""
    matched = jd2 < 1e29
    np.testing.assert_array_equal(d2 < 1e29, matched)
    diff = idx != jidx
    if diff.any():
        qq = np.broadcast_to(q[:, None, :], idx.shape + (3,))[diff]
        q64, t64 = qq.astype(np.float64), t.astype(np.float64)
        a = ((t64[idx[diff]] - q64) ** 2).sum(1)
        b = ((t64[jidx[diff]] - q64) ** 2).sum(1)
        assert np.all(np.abs(a - b) <= 2.0 ** -21 * b), np.abs(a - b).max()
    ulp = np.abs(d2[matched].view(np.int32).astype(np.int64)
                 - jd2[matched].view(np.int32).astype(np.int64))
    assert ulp.max() <= 2
    dd = q[:, None, :] - t[idx]
    np.testing.assert_array_equal(
        d2[matched],
        ((dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1])
         + dd[..., 2] * dd[..., 2])[matched])
    return matched


# (targets, queries, valid targets, radius, slice_cap, block, k)
KNN_CASES = {
    "exact": (3000, 2000, 2900, 0.02, 1024, 128, 30),
    # Windows longer than slice_cap: the first slice_cap rows, overflowed;
    # the last blocks' starts clamp below their window.
    "overflow and clamp": (600, 600, 590, 0.1, 256, 128, 30),
    # k above slice_cap: the extra slots are index 0 at 1e30.
    "k above slice_cap": (1500, 1000, 1450, 0.05, 16, 256, 30),
}


@pytest.mark.parametrize("case", sorted(KNN_CASES))
def test_slab_knn_matches_jax(case):
    nt, nq, nvalid, radius, cap, block, k = KNN_CASES[case]
    rng = np.random.default_rng(nt + nq + k)
    t = _surface(rng, nt)
    mask = np.arange(nt) < nvalid
    q = (t[np.sort(rng.permutation(nt)[:nq])]
         + rng.normal(scale=0.004, size=(nq, 3))).astype(np.float32)
    js = jslab.build_slab(jnp.asarray(t), jnp.asarray(mask))
    jidx, jd2, jovf = (np.asarray(x) for x in jslab.slab_knn(
        js, jnp.asarray(q), radius, k=k, slice_cap=cap, block=block,
        method="exact"))
    ts = slab.build_slab(torch.from_numpy(t), torch.from_numpy(mask))
    idx, d2, ovf = slab.slab_knn(ts, torch.from_numpy(q), radius, k=k,
                                 slice_cap=cap, block=block)
    assert idx.dtype == torch.int32 and idx.shape == d2.shape == (nq, k)
    assert bool(ovf) == bool(jovf) == (case != "exact")
    matched = _hold_knn(q, t, idx.numpy(), d2.numpy(), jidx, jd2)
    assert matched.sum() > 0
    if case == "k above slice_cap":
        assert np.all(idx.numpy()[:, cap:] == 0)
        assert np.all(d2.numpy()[:, cap:] == np.float32(1e30))
    if case == "overflow and clamp":
        lo, _ = slab.block_slices(ts, torch.from_numpy(
            np.pad(q, ((0, (-nq) % block), (0, 0)),
                   constant_values=2.9e4)).reshape(-1, block, 3)[..., 0],
            radius)
        assert int(lo.max()) > nt - cap  # some start is clamped
