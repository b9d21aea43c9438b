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
