"""Prepare-sweep port parity: the plain versions of K2, K3 and K4 against
the JAX Pallas kernels in interpret mode on identical operands, and the
Newton eigenvector against the JAX one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu3d.ops.features_pallas import (
    fpfh_sweep_pallas,
    moments_sweep_pallas,
    spfh_sweep_pallas,
)
from tpu3d.ops.normals import (
    smallest_eigvec_3x3_planes_newton as jax_newton,
)
from tpu3d_torch.ops import features, fused_features, nn_walk
from tpu3d_torch.ops.normals import smallest_eigvec_3x3_planes_newton
from tpu3d_torch.types import PointCloud
from torch_threads import one_torch_thread  # noqa: F401

R = 0.02
R2 = float(np.float32(R) * np.float32(R))


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module", params=["dense", "sparse"])
def operands(request):
    """Sweep operands of a 4,096-capacity surface at block 128, with the
    sparse member sets' pruned window tables for the 'sparse' case."""
    rng = np.random.default_rng(3)
    n, cap, block = 4000, 4096, 128
    xy = rng.uniform(-0.2, 0.2, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.03 * np.sin(25 * xy[:, 0]) * np.cos(22 * xy[:, 1])
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = np.column_stack([xy, z])
    cloud = PointCloud(points=torch.from_numpy(pts),
                       mask=torch.from_numpy(np.arange(cap) < n))
    al, lo, ln = fused_features.aligned_layout(cloud, R, block)
    lens = (ln, ln, ln)
    if request.param == "sparse":
        lens = fused_features.member_lengths(lo, ln, block, nq=8)[:3]
        assert 0 < int(lens[2].sum()) < int(lens[0].sum()) < int(ln.sum())
    return al, lo, lens, block


def test_k2_plain_matches_pallas(operands):
    al, lo, (len_a, _, _), block = operands
    q8 = fused_features.moments_operands(al)
    got = features.moments_sweep(q8, al.padded_points_t, lo, len_a, R2, block)
    ref = _np(moments_sweep_pallas(
        jnp.asarray(q8.numpy()), jnp.asarray(al.padded_points_t.numpy()),
        jnp.asarray(lo.numpy()), jnp.asarray(len_a.numpy()), R2,
        block=block, sub=256, interpret=True))
    g = got.numpy()
    np.testing.assert_array_equal(g[3], ref[3])  # counts exact
    well = (ref[3] >= 3) & (q8[3].numpy() > 0.5)
    assert well.sum() > 300
    cos = np.abs((g[:3] * ref[:3]).sum(0))
    assert cos[well].min() >= 0.9999
    # Invalid rows are zero in both.
    assert not g[:3, q8[3].numpy() < 0.5].any()
    assert not ref[:3, q8[3].numpy() < 0.5].any()


def test_k3_plain_matches_pallas(operands):
    al, lo, (len_a, len_b, _), block = operands
    q8 = fused_features.moments_operands(al)
    nrm8 = features.moments_sweep(q8, al.padded_points_t, lo, len_a, R2,
                                  block)
    q8n, packed_b = fused_features.spfh_operands(al, nrm8)
    got = features.spfh_sweep(q8n, packed_b, lo, len_b, R2, block).numpy()
    ref = _np(spfh_sweep_pallas(
        jnp.asarray(q8n.numpy()), jnp.asarray(packed_b.numpy()),
        jnp.asarray(lo.numpy()), jnp.asarray(len_b.numpy()), R2,
        block=block, sub=256, interpret=True))
    np.testing.assert_array_equal(got[33], ref[33])  # counts exact
    live = ref[33] > 0
    assert live.sum() > 300
    same = np.all(got[:33] == ref[:33], axis=0)
    assert same[live].mean() >= 0.99, same[live].mean()
    # A bin flip moves one neighbour's mass (1 / (3·count)) by one bin.
    np.testing.assert_allclose(got[:33].sum(0)[live], 1.0, atol=1e-5)
    assert not got[34:].any() and not ref[34:].any()


@pytest.fixture(scope="module", params=[128, 256])
def sparse_operands(request):
    """The sparse prepare's operands (member-set windows) of an 8,000-point
    surface in capacity 8,192 at block 128 or 256, with sweep B's normals
    from the plain K2."""
    rng = np.random.default_rng(4)
    n, cap, block = 8000, 8192, request.param
    xy = rng.uniform(-0.25, 0.25, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.03 * np.sin(25 * xy[:, 0]) * np.cos(22 * xy[:, 1])
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = np.column_stack([xy, z])
    cloud = PointCloud(points=torch.from_numpy(pts),
                       mask=torch.from_numpy(np.arange(cap) < n))
    al, lo, ln = fused_features.aligned_layout(cloud, R, block)
    len_a, len_b, _, _ = fused_features.member_lengths(lo, ln, block,
                                                       2048 // block)
    assert 0 < int((len_b > 0).any(1).sum()) < lo.shape[0]
    q8 = fused_features.moments_operands(al)
    nrm8 = features.moments_sweep(q8, al.padded_points_t, lo, len_a, R2,
                                  block)
    return al, lo, len_a, len_b, block, q8, nrm8


def test_k2_sparse_hint_matches_pallas(sparse_operands):
    """K2's plain version with the sparse launch hint, on the sparse
    prepare's windows at block 128 and 256: the same result as without it,
    and the Pallas kernel's counts exactly and normals to |cos| >= 0.9999."""
    al, lo, len_a, _, block, q8, nrm8 = sparse_operands
    got = features.moments_sweep(q8, al.padded_points_t, lo, len_a, R2,
                                 block, sparse=True)
    assert torch.equal(got, nrm8)
    ref = _np(moments_sweep_pallas(
        jnp.asarray(q8.numpy()), jnp.asarray(al.padded_points_t.numpy()),
        jnp.asarray(lo.numpy()), jnp.asarray(len_a.numpy()), R2,
        block=block, sub=256, interpret=True))
    g = got.numpy()
    np.testing.assert_array_equal(g[3], ref[3])
    well = (ref[3] >= 3) & (q8[3].numpy() > 0.5)
    assert well.sum() > 300
    assert np.abs((g[:3] * ref[:3]).sum(0))[well].min() >= 0.9999


def test_k3_sparse_hint_matches_pallas(sparse_operands):
    """K3's plain version with the sparse launch hint: the same result as
    without it, and the Pallas kernel's counts exactly, its histograms on
    at least 99 % of the live rows."""
    al, lo, _, len_b, block, _, nrm8 = sparse_operands
    q8n, packed_b = fused_features.spfh_operands(al, nrm8)
    got = features.spfh_sweep(q8n, packed_b, lo, len_b, R2, block,
                              sparse=True)
    assert torch.equal(got, features.spfh_sweep(q8n, packed_b, lo, len_b,
                                                R2, block))
    got = got.numpy()
    ref = _np(spfh_sweep_pallas(
        jnp.asarray(q8n.numpy()), jnp.asarray(packed_b.numpy()),
        jnp.asarray(lo.numpy()), jnp.asarray(len_b.numpy()), R2,
        block=block, sub=256, interpret=True))
    np.testing.assert_array_equal(got[33], ref[33])
    live = ref[33] > 0
    assert live.sum() > 300
    same = np.all(got[:33] == ref[:33], axis=0)
    assert same[live].mean() >= 0.99, same[live].mean()
    # Rows of blocks without a live window are zero in both.
    dead = np.repeat(~(len_b.numpy() > 0).any(1), block)
    assert dead.any() and not got[:, dead].any() and not ref[:, dead].any()


def test_k4_plain_matches_pallas(operands):
    al, lo, (_, len_b, len_c), block = operands
    q8 = fused_features.moments_operands(al)
    rng = np.random.default_rng(5)
    spfh = np.zeros((40, q8.shape[1]), np.float32)
    spfh[:33] = rng.uniform(0, 0.1, (33, q8.shape[1]))
    packed = fused_features.fpfh_operands(al, torch.from_numpy(spfh))
    got = features.fpfh_sweep(q8, packed, lo, len_c, R2, block).numpy()
    ref = _np(fpfh_sweep_pallas(
        jnp.asarray(q8.numpy()), jnp.asarray(packed.numpy()),
        jnp.asarray(lo.numpy()), jnp.asarray(len_c.numpy()), R2,
        block=block, sub=256, interpret=True))
    assert got.shape == ref.shape == (q8.shape[1], 36)
    assert (got[:, 0] > 0).sum() > 100
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_k4_block_list(operands):
    """A block list runs K4 on those blocks alone: their rows equal the
    full sweep's, every other row is zero; the sparse prepare's list is
    its query blocks, which hold every live sweep-C window."""
    al, lo, (len_a, _, len_c), block = operands
    q8 = fused_features.moments_operands(al)
    rng = np.random.default_rng(6)
    spfh = np.zeros((40, q8.shape[1]), np.float32)
    spfh[:33] = rng.uniform(0, 0.1, (33, q8.shape[1]))
    packed = fused_features.fpfh_operands(al, torch.from_numpy(spfh))
    full = features.fpfh_sweep(q8, packed, lo, len_c, R2, block)
    nbk = lo.shape[0]
    live = np.nonzero(len_c.sum(1).numpy() > 0)[0]
    ids = live[::2]
    got = features.fpfh_sweep(q8, packed, lo, len_c, R2, block,
                              blocks=torch.from_numpy(ids.astype(np.int32)))
    rows = np.zeros(nbk, bool)
    rows[ids] = True
    rows = np.repeat(rows, block)
    assert torch.equal(got[torch.from_numpy(rows)],
                       full[torch.from_numpy(rows)])
    assert float(got[torch.from_numpy(rows)].abs().sum()) > 0
    assert not got[torch.from_numpy(~rows)].any()
    if len_c is not len_a:  # the sparse member sets
        assert set(live) <= set(fused_features.query_blocks(nbk, 8))


@pytest.mark.parametrize("block,nblocks,listed,plan", [
    (128, 911, False, (1, 4)), (256, 700, False, (1, 8)),
    (128, 661, False, (1, 4)), (128, 660, False, (4, 8)),
    (128, 255, False, (4, 8)), (128, 191, False, (4, 8)),
    (128, 4000, True, (4, 8)), (256, 520, True, (8, 8)),
])
def test_k4_launch_plan(block, nblocks, listed, plan):
    """More than five blocks per SM (132 here): one CTA per block, a thread
    per query; fewer, or a block list: slices of 32 queries on 8 warps."""
    slices, warps = features.fpfh_plan(block, nblocks, listed, 132)
    assert (slices, warps) == plan
    assert block // slices == (32 if slices > 1 else warps * 32)


@pytest.mark.parametrize("block,nblocks,sparse,plan", [
    (128, 191, False, (1, 4, 1)), (128, 255, False, (1, 4, 1)),
    (128, 911, False, (1, 4, 1)), (128, 1151, False, (1, 2, 2)),
    (128, 8700, False, (1, 2, 2)), (256, 520, True, (2, 4, 1)),
    (256, 4606, True, (2, 4, 1)), (256, 192, True, (2, 4, 1)),
    (128, 520, True, (2, 2, 1)), (128, 1056, False, (1, 4, 1)),
    (128, 1057, False, (1, 2, 2)), (256, 2000, False, (1, 4, 2)),
])
def test_k2_launch_plan(block, nblocks, sparse, plan):
    """K2: the sparse prepare's layouts (100k's 520 blocks of 256, 1M's
    4,606, the bin instance's 192) two CTAs a block, a query a thread; a
    dense layout one CTA a block, a query a thread up to
    TILE_BLOCKS_PER_SM (8) blocks per SM (132 here: the batch's 191 and
    255 blocks, 100k's 911), two queries a thread above (the bin
    reference's 1,151, 1M's 8,700)."""
    slices, warps, per = features.moments_plan(block, nblocks, sparse, 132)
    assert (slices, warps, per) == plan
    assert slices * warps * 32 * per == block


@pytest.mark.parametrize("block,nblocks,sparse,plan", [
    (128, 191, False, (4, 8, True)), (128, 255, False, (4, 8, True)),
    (128, 396, False, (4, 8, True)), (128, 397, False, (1, 4, False)),
    (128, 911, False, (1, 4, False)), (128, 1151, False, (1, 4, False)),
    (128, 8700, False, (1, 4, False)), (256, 520, True, (8, 8, True)),
    (256, 4606, True, (8, 8, True)), (256, 192, True, (8, 8, True)),
    (256, 900, False, (1, 8, False)),
])
def test_k3_launch_plan(block, nblocks, sparse, plan):
    """At most SPFH_LANE_BLOCKS_PER_SM (3) blocks per SM (132 here), or the
    sparse prepare: the lane kernel on slices of 32 queries, 8 warps each;
    a larger dense layout: one CTA a block, a thread a query."""
    slices, warps, lanes = features.spfh_plan(block, nblocks, sparse, 132)
    assert (slices, warps, lanes) == plan
    assert block // slices == (32 if lanes else warps * 32)


@pytest.mark.parametrize("block,nblocks,plan", [
    (512, 2048, (1, 4)), (512, 660, (1, 4)), (512, 528, (1, 4)),
    (512, 527, (2, 2)), (512, 264, (2, 2)), (512, 263, (4, 1)),
    (512, 96, (4, 1)), (512, 5, (4, 1)), (256, 4096, (1, 2)),
    (256, 528, (1, 2)), (256, 527, (2, 1)), (256, 5, (2, 1)),
    (128, 8192, (1, 1)), (128, 1024, (1, 1)), (128, 96, (1, 1)),
    (128, 5, (1, 1)),
])
def test_k8_launch_plan(block, nblocks, plan):
    """K8 (132 SMs here): CTAs of 128 threads; a query block is cut into
    the fewest slices (1, 2 or 4) that launch WALK_CTAS_PER_SM (4) CTAs an
    SM, and a thread takes the block's remaining queries (the 1M
    self-join's 2,048 blocks of 512: one CTA a block, four a thread; its
    first 96: four CTAs a block, one a thread)."""
    slices, per = nn_walk.nn_walk_plan(block, nblocks, 132)
    assert (slices, per) == plan
    assert block // (slices * per) == 128


def test_newton_eigvec_matches_jax(rng):
    """Agreement to 1e-6 where the eigenvector is well defined: eigenvalue
    gaps of at least 20 % of the largest (XLA contracts some products into
    FMAs, so near-degenerate inputs may pick another vector), over six
    decades of scale; plus the degenerate zero, isotropic and rank-one
    matrices."""
    n = 2000
    rot, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = np.stack([rng.uniform(0, 0.1, n), rng.uniform(0.3, 0.6, n),
                    rng.uniform(0.7, 1.0, n)], 1)
    lam *= 10.0 ** rng.uniform(-6, 0, (n, 1))
    cov = np.einsum("nij,nj,nkj->nik", rot, lam, rot)
    cov[:3] = [np.zeros((3, 3)), np.eye(3), np.outer([1, 2, 3], [1, 2, 3])]
    cov = cov.astype(np.float32)
    ij = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    got = smallest_eigvec_3x3_planes_newton(
        *(torch.from_numpy(cov[:, i, j].copy()) for i, j in ij))
    ref = jax_newton(*(jnp.asarray(cov[:, i, j]) for i, j in ij))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), _np(r), atol=1e-6)
    v = np.stack([g.numpy() for g in got], 1)
    np.testing.assert_allclose(np.linalg.norm(v[3:], axis=1), 1.0, atol=1e-5)
    # The true smallest eigenvector, up to sign.
    true = rot[3:, :, 0]
    assert np.abs((v[3:] * true).sum(1)).min() > 0.999


def test_sweeps_check_shapes():
    q8 = torch.zeros((8, 256))
    lo = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="packed"):
        features.moments_sweep(q8, torch.zeros((4, 256)), lo, lo, R2, 128)
    with pytest.raises(ValueError, match="lo and ln"):
        features.spfh_sweep(q8, torch.zeros((10, 256)), lo[:1], lo[:1], R2,
                            128)
    with pytest.raises(ValueError, match="q8"):
        features.fpfh_sweep(q8[:, :200], torch.zeros((36, 200)), lo, lo, R2,
                            128)
    with pytest.raises(ValueError, match="128 or 256"):
        features.moments_sweep(q8[:, :192], torch.zeros((3, 192)), lo, lo,
                               R2, 96)
    # A power of two the kernels do not take: the plain path refuses it too.
    with pytest.raises(ValueError, match="128 or 256"):
        features.moments_sweep(q8, torch.zeros((3, 256)), lo, lo, R2, 64)
