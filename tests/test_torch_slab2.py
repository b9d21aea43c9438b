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
