"""Grid-index port parity: ``tpu3d_torch.ops.grid`` (``build_grid``,
``grid_top1``, ``grid_knn``, plain PyTorch) against ``tpu3d/ops/grid.py``
on the same inputs.

``build_grid`` is held field by field, bit for bit. The searches are held
on the JAX index moved over by ``carry.from_numpy`` (so a search is tested
apart from the build) and on the port's own: indices equal, d² bit for bit
on lattice clouds (exact arithmetic), elsewhere within 2 ulp of JAX's
(XLA's FMA contraction) and bit for bit the separately rounded sum, a
differing index only at a float64 near-tie (``_hold_knn``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slab import _hold_knn
from tpu3d.ops import grid as jgrid
from tpu3d_torch import carry
from tpu3d_torch.ops import grid
from torch_threads import one_torch_thread  # noqa: F401


def _cloud(case):
    """(targets, mask, queries, cell size) of a case."""
    rng = np.random.default_rng(len(case))
    if case == "lattice ties":
        # 1/64 lattice points and queries on lattice points: many exactly
        # equidistant candidates, all products exact.
        t = rng.integers(-12, 12, (3000, 3)).astype(np.float32) / 64
        q = rng.integers(-12, 12, (700, 3)).astype(np.float32) / 64
        return t, rng.uniform(size=3000) > 0.05, q, 1 / 32
    t = rng.uniform(-0.1, 0.1, (3000, 3)).astype(np.float32)
    q = (t[:700] + rng.normal(0, 0.004, (700, 3))).astype(np.float32)
    mask = rng.uniform(size=3000) > 0.1
    if case == "span clamp":
        # A requested cell far below span / 1,287: h grows to ~1.6e-4 and
        # dims = 1,290; queries within a cell of a target.
        q = (t[:700] + rng.normal(0, 5e-5, (700, 3))).astype(np.float32)
        return t, mask, q, 1e-5
    return t, mask, q, 0.01  # "overflowing cells" at small capacities


CASES = ["overflowing cells", "lattice ties", "span clamp"]


@pytest.mark.parametrize("case", CASES)
def test_build_grid_matches_jax(case):
    t, mask, _, h = _cloud(case)
    jg = jgrid.build_grid(jnp.asarray(t), jnp.asarray(mask), h)
    tg = grid.build_grid(torch.from_numpy(t), torch.from_numpy(mask), h)
    for f in jgrid.GridIndex._fields:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    dims = tg.dims.numpy()
    if case == "span clamp":
        assert dims.max() == 1290 and float(tg.cell_size) > h
    # Invalid rows sit last, in the sentinel cell.
    ids = tg.sorted_cell_ids.numpy()
    assert np.all(ids[mask.sum():] == 2**31 - 1)


def test_build_grid_all_invalid():
    t = np.zeros((64, 3), np.float32)
    mask = np.zeros(64, bool)
    jg = jgrid.build_grid(jnp.asarray(t), jnp.asarray(mask), 0.01)
    tg = grid.build_grid(torch.from_numpy(t), torch.from_numpy(mask), 0.01)
    for f in jgrid.GridIndex._fields:
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)


def _indexes(t, mask, h):
    jg = jgrid.build_grid(jnp.asarray(t), jnp.asarray(mask), h)
    tg = grid.build_grid(torch.from_numpy(t), torch.from_numpy(mask), h)
    moved = carry.from_numpy(grid.GridIndex, jg._asdict(), device="cpu")
    return jg, (tg, moved)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("cell_capacity", [2, 8])
def test_grid_top1_matches_jax(case, cell_capacity):
    t, mask, q, h = _cloud(case)
    jg, indexes = _indexes(t, mask, h)
    jidx, jd2 = (np.asarray(x) for x in jgrid.grid_top1(
        jg, jnp.asarray(q), cell_capacity=cell_capacity))
    for tg in indexes:
        idx, d2 = grid.grid_top1(tg, torch.from_numpy(q),
                                 cell_capacity=cell_capacity, chunk=256)
        assert idx.dtype == torch.int32
        matched = _hold_knn(q, t, idx.numpy()[:, None], d2.numpy()[:, None],
                            jidx[:, None], jd2[:, None])
        assert matched.any()
        if case == "lattice ties":
            np.testing.assert_array_equal(idx.numpy(), jidx)
            np.testing.assert_array_equal(d2.numpy(), jd2)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("cell_capacity,k", [(4, 20), (32, 30)])
def test_grid_knn_matches_jax(case, cell_capacity, k):
    t, mask, q, h = _cloud(case)
    jg, indexes = _indexes(t, mask, h)
    jidx, jd2 = (np.asarray(x) for x in jgrid.grid_knn(
        jg, jnp.asarray(q), k=k, cell_capacity=cell_capacity))
    for tg in indexes:
        idx, d2 = grid.grid_knn(tg, torch.from_numpy(q), k=k,
                                cell_capacity=cell_capacity, chunk=300)
        assert idx.shape == d2.shape == (len(q), k)
        matched = _hold_knn(q, t, idx.numpy(), d2.numpy(), jidx, jd2)
        assert matched.any()
        if case == "lattice ties":
            np.testing.assert_array_equal(idx.numpy(), jidx)
            np.testing.assert_array_equal(d2.numpy(), jd2)


def test_grid_overflow_drops_the_same_rows():
    """Cells holding more rows than cell_capacity offer their first rows in
    the stable sort's order: with one row a cell, a query's 27 candidates
    are each cell's lowest original row."""
    rng = np.random.default_rng(5)
    t = rng.uniform(0, 0.05, (4000, 3)).astype(np.float32)
    mask = np.ones(4000, bool)
    q = t[:200]
    jg = jgrid.build_grid(jnp.asarray(t), jnp.asarray(mask), 0.01)
    tg = grid.build_grid(torch.from_numpy(t), torch.from_numpy(mask), 0.01)
    counts = np.bincount(np.unique(tg.sorted_cell_ids.numpy(),
                                   return_inverse=True)[1])
    assert counts.max() > 20  # cells overflow a capacity of 1
    jidx, _ = jgrid.grid_knn(jg, jnp.asarray(q), k=27, cell_capacity=1)
    idx, _ = grid.grid_knn(tg, torch.from_numpy(q), k=27, cell_capacity=1)
    np.testing.assert_array_equal(np.sort(idx.numpy(), 1),
                                  np.sort(np.asarray(jidx), 1))
