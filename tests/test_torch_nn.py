"""K5 plain version (tpu3d_torch.ops.nn) against the JAX top-1 searches:
``nearest_neighbor_xla`` and ``nearest_neighbor_pallas`` in interpret mode.
The CUDA kernel itself is held against this plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.ops.neighbors import nearest_neighbor_xla
from tpu3d.ops.nn_pallas import nearest_neighbor_pallas
from tpu3d_torch.ops import nn
from torch_threads import one_torch_thread  # noqa: F401


def _inputs(rng, d, q=150, m=230):
    qs = rng.normal(size=(q, d)).astype(np.float32)
    ts = rng.normal(size=(m, d)).astype(np.float32)
    mask = np.ones(m, bool)
    mask[200:] = False
    mask[::17] = False
    return qs, ts, mask


def _untied(ref_d2_all, tol=1e-5):
    """Queries whose best and second-best valid distances differ by more
    than the float noise of the expansion."""
    s = np.sort(ref_d2_all, axis=1)
    return (s[:, 1] - s[:, 0]) > tol * np.maximum(1.0, s[:, 0])


@pytest.mark.parametrize("d", [3, 33])
def test_plain_matches_xla_and_pallas(rng, d):
    q, t, mask = _inputs(rng, d)
    ti, td = nn.nearest_neighbor(torch.from_numpy(q), torch.from_numpy(t),
                                 torch.from_numpy(mask))
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    exact = ((q[:, None, :].astype(np.float64) - t[None].astype(np.float64))
             ** 2).sum(-1)
    exact[:, ~mask] = np.inf
    untied = _untied(exact)
    assert untied.mean() > 0.9
    xi, xd = nearest_neighbor_xla(jnp.asarray(q), jnp.asarray(t),
                                  jnp.asarray(mask))
    pi, pd = nearest_neighbor_pallas(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask),
        block_n=128, block_m=128, interpret=True,
    )
    for ref_i, ref_d in ((xi, xd), (pi, pd)):
        np.testing.assert_array_equal(ti.numpy()[untied],
                                      np.asarray(ref_i)[untied])
        np.testing.assert_allclose(td.numpy(), np.asarray(ref_d), rtol=1e-5,
                                   atol=1e-5)


def test_ties_go_to_lowest_index():
    t = np.zeros((6, 3), np.float32)
    t[:, 0] = [5, 1, 1, 3, 1, 9]  # rows 1, 2 and 4 tie for query x = 1
    q = np.array([[1.0, 0, 0], [9.0, 0, 0]], np.float32)
    mask = np.ones(6, bool)
    mask[1] = False  # an invalid row never wins
    ti, td = nn.nearest_neighbor(torch.from_numpy(q), torch.from_numpy(t),
                                 torch.from_numpy(mask))
    assert ti.tolist() == [2, 5]
    assert td.tolist() == [0.0, 0.0]


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        nn.nearest_neighbor(torch.zeros(4, 3), torch.zeros(5, 4),
                            torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError):
        nn.nearest_neighbor(torch.zeros(4, 3), torch.zeros(5, 3),
                            torch.ones(4, dtype=torch.bool))
