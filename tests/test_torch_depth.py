"""The port's depth front end against the JAX package: ``depth_preprocess``,
the bilateral filter's plain version (the CPU side of K9) and
``deproject``, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d import oracle
from tpu3d.ops.deproject import deproject as jax_deproject
from tpu3d.ops.depth import bilateral_filter as jax_bilateral
from tpu3d.ops.depth import depth_preprocess as jax_preprocess
from tpu3d_torch.ops import deproject, depth
from torch_threads import one_torch_thread  # noqa: F401


def _frame(rng, h, w):
    """A depth frame with holes and a zero border strip, so windows meet
    both zero neighbours and the frame's edge."""
    d = rng.uniform(0.5, 1.5, size=(h, w)).astype(np.float32)
    d[rng.uniform(size=(h, w)) < 0.2] = 0.0
    d[:, :2] = 0.0
    d[5:9, 10:20] += 0.2  # a step well above sigma_range
    return d


@pytest.mark.parametrize("apply_mask", [True, False])
def test_depth_preprocess_matches_jax(rng, apply_mask):
    raw = rng.integers(0, 20000, size=(24, 40)).astype(np.uint16)
    mask = rng.integers(0, 30, size=(24, 40)).astype(np.uint8)  # around 10
    for m in (mask, None):
        ref = np.asarray(jax_preprocess(
            jnp.asarray(raw), None if m is None else jnp.asarray(m), 1000.0,
            apply_mask=apply_mask))
        got = depth.depth_preprocess(
            torch.from_numpy(raw.astype(np.float32)),
            None if m is None else torch.from_numpy(m), 1000.0,
            apply_mask=apply_mask)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("sigma_s,radius", [(2.0, 4), (3.0, 5)])
def test_bilateral_plain_matches_jax(rng, sigma_s, radius):
    assert depth.bf_radius(sigma_s) == radius
    d = _frame(rng, 60, 80)
    ref = np.asarray(jax_bilateral(jnp.asarray(d), sigma_s, 0.05,
                                   use_pallas=False))
    got = depth.bilateral_filter(torch.from_numpy(d), sigma_s, 0.05).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_array_equal(got == 0, d == 0)


@pytest.mark.parametrize("sigma_s", [2.0, 3.0])
def test_bilateral_plain_matches_oracle(rng, sigma_s):
    d = _frame(rng, 20, 28)
    exp = oracle.bilateral_filter(d, sigma_s, 0.05)
    got = depth.bilateral_filter(torch.from_numpy(d), sigma_s, 0.05).numpy()
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)


def test_bilateral_rejects_a_batch():
    with pytest.raises(ValueError):
        depth.bilateral_filter(torch.zeros(2, 8, 8))


def test_deproject_matches_jax(rng):
    h, w = 12, 16
    d = rng.uniform(0, 2.0, size=(h, w)).astype(np.float32)
    d[d < 0.2] = 0.0
    d[0, 0] = 1.5  # the clip is inclusive
    rgb = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
    K = np.array([[100.0, 0, 8.0], [0, 110.0, 6.0], [0, 0, 1]], np.float32)
    ref = jax_deproject(jnp.asarray(d), jnp.asarray(rgb), jnp.asarray(K), 1.5)
    got = deproject.deproject(torch.from_numpy(d), torch.from_numpy(rgb),
                              torch.from_numpy(K), 1.5)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.colors.numpy(), np.asarray(ref.colors))
    assert bool(got.mask[0])
    # Row r is pixel (r // W, r % W).
    r = 3 * w + 5
    assert float(got.points[r, 2]) == float(d[3, 5])
    nocol = deproject.deproject(torch.from_numpy(d), None,
                                torch.from_numpy(K), 1.5)
    assert nocol.colors is None
