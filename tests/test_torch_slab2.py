"""Aligned slab2 port parity: the layout, bucket tables and window tables
of ``tpu3d_torch.ops.slab2`` equal the JAX package's exactly (integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.ops import slab2 as jslab2
from tpu3d_torch.ops import slab2
from torch_threads import one_torch_thread  # noqa: F401


def _surface(rng, n, cap, degenerate_x=False):
    xy = rng.uniform(-0.2, 0.2, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.03 * np.sin(25 * xy[:, 0]) * np.cos(22 * xy[:, 1])
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = np.column_stack([xy, z])
    if degenerate_x:
        pts[:n, 0] = 0.0
    return pts, np.arange(cap) < n


CASES = {
    "surface-b128": (4000, 4096, 128, False),
    "surface-b256": (4000, 4096, 256, False),
    "degenerate-x": (2048, 2048, 128, True),
    "capacity-200": (150, 200, 128, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_aligned_layout_and_windows_match_jax(case):
    n, cap, block, degenerate = CASES[case]
    pts, mask = _surface(np.random.default_rng(7), n, cap, degenerate)
    r = np.float32(0.02)
    ref = jslab2.build_slab2_aligned(jnp.asarray(pts), jnp.asarray(mask), r,
                                     block=block, max_buckets=128)
    jlo, jln = jslab2.aligned_block_windows(ref, r, block)
    got = slab2.build_slab2_aligned(torch.from_numpy(pts),
                                    torch.from_numpy(mask), float(r),
                                    block=block, max_buckets=128)
    lo, ln = slab2.aligned_block_windows(got, float(r), block)
    assert got.padded_points_t.shape[1] == slab2.aligned_capacity(
        cap, block, 128)
    for field in ref._fields:
        a = np.asarray(getattr(ref, field))
        b = getattr(got, field).numpy()
        assert a.shape == b.shape, field
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=field)
    # Padding rows carry the unique out-of-bounds originals n + position.
    pad = ~got.valid_padded
    pos = torch.arange(pad.shape[0])
    assert torch.equal(got.padded_orig[pad], cap + pos[pad])
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jln))
    assert int(ln.sum()) > 0


@pytest.mark.parametrize("side", ["left", "right"])
def test_sorted_positions_and_qy_match_jax(rng, side):
    keys = np.sort(rng.integers(0, 1 << 30, 3000).astype(np.int32))
    keys[100:140] = keys[100]  # runs of equal keys
    q = np.concatenate([keys[::37], rng.integers(0, 1 << 30, 200),
                        [0, np.iinfo(np.int32).max]]).astype(np.int32)
    ref = jslab2.sorted_positions(jnp.asarray(keys), jnp.asarray(q), side)
    got = slab2.sorted_positions(torch.from_numpy(keys), torch.from_numpy(q),
                                 side)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    y = np.concatenate([rng.uniform(-1, 1, 500), [np.inf, -np.inf, 1e9]])
    y = y.astype(np.float32)
    y0, scale = np.float32(-0.7), np.float32(12345.678)
    np.testing.assert_array_equal(
        slab2._qy_of(torch.from_numpy(y), float(y0), float(scale)).numpy(),
        np.asarray(jslab2._qy_of(jnp.asarray(y), y0, scale)),
    )


# --------------------------------------------------------------------------
# The plain layout: build_slab2, query_keys, block_windows
# --------------------------------------------------------------------------


def _plain_cloud(case, rng):
    """(points, mask, bucket width, radius, block, k_max, sorted queries):
    ``sorted_queries`` False feeds block_windows the rows in their random
    order, so blocks span many buckets and the overflow window is live."""
    n = 4096
    pts, mask = _surface(rng, 3900, n)
    width, radius, block, k_max, sorted_q = 0.02, 0.02, 128, 10, True
    if case == "masked-rows":
        mask &= rng.uniform(size=n) > 0.2
    elif case == "degenerate-x":
        pts[:, 0] = 0.125
    elif case == "degenerate-xy":
        pts[:, :2] = np.float32([0.125, -0.25])
    elif case == "overflow-window":
        k_max, sorted_q = 3, False
    elif case == "widened-buckets":
        width = radius = 1e-5  # 40,000 buckets over the x-extent → 2,047
    elif case == "block-512-k8":
        block, k_max = 512, 8
    return pts, mask, width, radius, block, k_max, sorted_q


PLAIN_CASES = ["masked-rows", "degenerate-x", "degenerate-xy",
               "overflow-window", "widened-buckets", "block-512-k8"]


@pytest.mark.parametrize("case", PLAIN_CASES)
def test_plain_slab2_and_windows_match_jax(case):
    rng = np.random.default_rng(11)
    pts, mask, width, radius, block, k_max, sorted_q = _plain_cloud(case,
                                                                    rng)
    w = np.float32(width)
    ref = jslab2.build_slab2(jnp.asarray(pts), jnp.asarray(mask), w)
    got = slab2.build_slab2(torch.from_numpy(pts), torch.from_numpy(mask),
                            float(w))
    for field in got._fields:
        a = np.asarray(getattr(ref, field))
        b = getattr(got, field).numpy()
        assert a.shape == b.shape, field
        np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=field)
    np.testing.assert_array_equal(got.sorted_points_t.numpy().T,
                                  np.asarray(ref.sorted_points))

    # Queries: the cloud itself, jittered, with its own mask; blocks of the
    # key-sorted queries (as slab2_top1 forms them) or of the raw rows.
    q = (pts + rng.normal(0, 0.003, pts.shape)).astype(np.float32)
    qm = rng.uniform(size=len(q)) > 0.1
    qm[-2 * block:] = False  # whole blocks of invalid queries
    np.testing.assert_array_equal(
        slab2.query_keys(got, torch.from_numpy(q),
                         torch.from_numpy(qm)).numpy(),
        np.asarray(jslab2.query_keys(ref, jnp.asarray(q), jnp.asarray(qm))))
    if sorted_q:
        qslab = jslab2.build_slab2(jnp.asarray(q), jnp.asarray(qm),
                                   np.float32(radius))
        q = np.array(qslab.sorted_points)
        qm = np.array(qslab.valid_sorted)
    qb = q.reshape(-1, block, 3)
    mb = qm.reshape(-1, block)
    r = np.float32(radius)
    jlo, jln = jslab2.block_windows(
        ref, (jnp.asarray(qb[..., 0]), jnp.asarray(qb[..., 1])),
        jnp.asarray(mb), r, k_max=k_max)
    lo, ln = slab2.block_windows(
        got, (torch.from_numpy(qb[..., 0]), torch.from_numpy(qb[..., 1])),
        torch.from_numpy(mb), float(r), k_max=k_max)
    assert lo.dtype == ln.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jln))
    # The cases reach what they are named for.
    ln_np = ln.numpy()
    assert (ln_np == 0).any() and ln_np.sum() > 0  # empty windows, lo kept
    if case == "overflow-window":
        assert (ln_np[:, -1] > 0).any()
    if case == "widened-buckets":
        assert float(got.inv_w) < 1.0 / float(w)
    # The (nb, B, 3) form gives the same tables.
    lo3, ln3 = slab2.block_windows(got, torch.from_numpy(qb),
                                   torch.from_numpy(mb), float(r), k_max)
    assert torch.equal(lo3, lo) and torch.equal(ln3, ln)
