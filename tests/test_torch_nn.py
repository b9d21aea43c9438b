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


# --- The descriptor route's host-side rules (operands, splits, reduction)
# and its 3xTF32 arithmetic, emulated (tests/tf32_emulation.py).


@pytest.mark.parametrize("q,m,d", [(5, 7, 33), (300, 129, 33), (256, 128, 36)])
def test_descriptor_operands_pack(rng, q, m, d):
    qs = rng.random((q, d)).astype(np.float32)
    ts = rng.random((m, d)).astype(np.float32)
    mask = rng.random(m) > 0.3
    qop = nn.descriptor_queries(torch.from_numpy(qs))
    top = nn.descriptor_targets(torch.from_numpy(ts), torch.from_numpy(mask))
    qp, mp = -(-q // nn.Q_TILE) * nn.Q_TILE, -(-m // nn.T_TILE) * nn.T_TILE
    assert qop.shape == (qp, nn.PACKED_K) and top.shape == (mp, nn.PACKED_K)
    assert qop.dtype == top.dtype == torch.float32
    # Rows of 160 bytes: 16-byte aligned for cp.async.
    assert nn.PACKED_K * 4 % 16 == 0 and nn.PACKED_K % 8 == 0
    qop, top = qop.numpy(), top.numpy()
    tgt = np.where(mask[:, None], ts, np.float32(1e6))
    np.testing.assert_array_equal(top[:m, :d], tgt)
    # The norm column in fp32 (its summation order is PyTorch's).
    np.testing.assert_allclose(top[:m, d], (tgt * tgt).sum(1), rtol=1e-6)
    assert (top[:m, d + 1:] == 0).all()
    pad = np.float32(nn.PAD_NORM)
    assert (top[m:, :d] == 0).all() and (top[m:, d] == pad).all()
    np.testing.assert_array_equal(qop[:q, :d], -2.0 * qs)
    assert (qop[:q, d] == 1).all() and (qop[:q, d + 1:] == 0).all()
    assert (qop[q:] == 0).all()
    # One contraction gives e = ‖t‖² − 2t·q (in float64, to rounding of
    # the float64 sums); padded targets give the pad norm.
    e = qop[:q].astype(np.float64) @ top.T.astype(np.float64)
    ref = (top[:m, d].astype(np.float64)[None]
           - 2.0 * qs.astype(np.float64) @ tgt.T.astype(np.float64))
    np.testing.assert_allclose(e[:, :m], ref, rtol=1e-12, atol=1e-9)
    assert (e[:, m:] == pad).all()


@pytest.mark.parametrize("q,m", [(8192, 8192), (8192, 100352),
                                 (8192, 1 << 20), (4, 20000), (1, 1),
                                 (257, 129), (5190, 86036)])
def test_split_plan_covers_every_tile(q, m):
    per, splits = nn.split_plan(q, m)
    m_tiles = -(-m // nn.T_TILE)
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < m_tiles <= splits * per  # none empty
    if m_tiles >= 4 * nn.MIN_SPLIT_TILES:
        assert splits > 1
    if (q, m) in ((8192, 8192), (8192, 100352), (8192, 1 << 20)):
        # The main path's shapes launch at least two waves of blocks.
        assert -(-q // nn.Q_TILE) * splits >= 2 * 132


def test_reduce_splits_plain_keeps_the_lower_split():
    inf = float("inf")
    part_e = torch.tensor([[1.0, 2.0, 5.0, inf],
                           [1.0, 1.5, 5.0, 3.0],
                           [0.5, 1.5, 4.0, 3.0]])
    part_i = torch.tensor([[10, 11, 12, 13],
                           [20, 21, 22, 23],
                           [30, 31, 32, 33]], dtype=torch.int32)
    qn = torch.tensor([0.5, 1.0, 2.0, -4.0])
    idx, d2 = nn.reduce_splits_plain(part_e, part_i, qn)
    # An exact tie keeps the earlier split (column 1: 1.5 in splits 1 and
    # 2 -> 21; column 3: 3.0 in splits 1 and 2 -> 23); a strictly smaller
    # e takes over (column 0 -> 30, column 2 -> 32); d2 clamps at 0.
    assert idx.tolist() == [30, 21, 32, 23]
    assert d2.tolist() == [1.0, 2.5, 6.0, 0.0]


@pytest.mark.parametrize("m", [230, 3000])
def test_descriptor_route_emulated_matches_xla(rng, m):
    """The descriptor route's arithmetic (packed operands, 3xTF32, the
    per-split argmin and the split reduction) against the JAX top-1 on
    L1-normalised histograms. d² within 1e-5 of JAX's relative to
    max(d², 1): both round ‖t‖² − 2t·q, 3xTF32 at ~2^-21 of Σ|t_k q_k| ≤ 1.
    Differing picks must be float64 near-ties (≤ 1e-6)."""
    q = rng.random((150, 33)) ** 4
    t = rng.random((m, 33)) ** 4
    q = (q / q.sum(1, keepdims=True)).astype(np.float32)
    t = (t / t.sum(1, keepdims=True)).astype(np.float32)
    mask = rng.random(m) > 0.1
    t[7] = q[3]
    t[m - 1] = q[3]  # an exact tie across tiles (and splits at m = 3000)
    from tf32_emulation import nn_3xtf32

    ei, ed = nn_3xtf32(torch.from_numpy(q), torch.from_numpy(t),
                       torch.from_numpy(mask))
    xi, xd = (np.asarray(a) for a in nearest_neighbor_xla(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask)))
    ei, ed = ei.numpy(), ed.numpy()
    assert ei[3] == 7 and xi[3] == 7
    assert np.max(np.abs(ed - xd) / np.maximum(np.abs(xd), 1.0)) <= 1e-5
    rows = np.nonzero(ei != xi)[0]
    tm = np.where(mask[:, None], t, 1e6).astype(np.float64)
    q64 = q.astype(np.float64)
    gap = np.abs(((tm[ei[rows]] - q64[rows]) ** 2).sum(1)
                 - ((tm[xi[rows]] - q64[rows]) ** 2).sum(1))
    assert rows.size == 0 or gap.max() <= 1e-6
    if m == 3000:
        assert nn.split_plan(150, m)[1] > 1
