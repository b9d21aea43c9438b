"""The port's CUDA kernels (K2-K11 and the probe's) against their plain
PyTorch versions, and the pipeline's routes, on the card. Every test here
needs a CUDA device and skips without one.

This file imports neither jax nor tpu3d, so it runs where they are not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py``.
"""

import itertools

import numpy as np
import pytest
import torch

import tpu3d_torch
from tpu3d_torch.models.fixtures import make_pair
from tpu3d_torch.ops import (
    depth,
    features,
    fused_features,
    gather_graph,
    icp,
    icp_stats,
    neighbors,
    nn,
    nn_walk,
    ransac,
    ransac_score,
)
from tpu3d_torch import probe

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("d", [3, 33])
def test_nn_kernel_matches_plain(dev, d):
    g = torch.Generator().manual_seed(d)
    q = torch.randn(1000, d, generator=g)
    t = torch.randn(1500, d, generator=g)
    mask = torch.rand(1500, generator=g) > 0.1
    pi, pd = nn.nearest_neighbor(q, t, mask)
    before = nn.nearest_neighbor.launches
    ki, kd = nn.nearest_neighbor(q.to(dev), t.to(dev), mask.to(dev))
    torch.cuda.synchronize()
    assert nn.nearest_neighbor.launches == before + 1
    assert ki.is_cuda and ki.dtype == torch.int32
    assert (ki.cpu() == pi).float().mean() > 0.99
    torch.testing.assert_close(kd.cpu(), pd, rtol=1e-5, atol=1e-5)


def test_nn_kernel_ties_and_mask(dev):
    t = torch.zeros(300, 3)
    t[:, 0] = 7.0
    t[5:8, 0] = 1.0  # rows 5, 6, 7 tie for the query at x = 1
    t[290:, 0] = 9.0  # rows past one tile
    mask = torch.ones(300, dtype=torch.bool)
    mask[5] = False
    q = torch.tensor([[1.0, 0, 0], [9.0, 0, 0]])
    ki, kd = nn.nearest_neighbor(q.to(dev), t.to(dev), mask.to(dev))
    assert ki.cpu().tolist() == [6, 290]
    assert kd.cpu().tolist() == [0.0, 0.0]


def test_nn_kernel_rejects_wide_and_double(dev):
    with pytest.raises(ValueError):
        nn.nearest_neighbor(torch.zeros(4, 40, device=dev),
                            torch.zeros(5, 40, device=dev),
                            torch.ones(5, dtype=torch.bool, device=dev))
    with pytest.raises(TypeError):
        nn.nearest_neighbor(torch.zeros(4, 3, device=dev, dtype=torch.float64),
                            torch.zeros(5, 3, device=dev, dtype=torch.float64),
                            torch.ones(5, dtype=torch.bool, device=dev))


def test_score_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(0)
    n, h = 3000, 2000
    p = torch.rand(n, 3, generator=g) - 0.5
    q = p + 3e-4 * torch.randn(n, 3, generator=g)
    out = torch.rand(n, generator=g) < 0.4
    q[out] += 0.05 + 0.15 * torch.rand(int(out.sum()), 3, generator=g)
    mask = torch.rand(n, generator=g) > 0.1
    feat, pq = ransac.build_scoring_factors(p, q, mask)
    count = int(mask.sum())
    table = ransac.build_rotation_table(torch.cat([p, q], 1), mask, count)
    draw = ransac.torch_draws(0)
    w16t, tn, _, _, _ = ransac.solve_rotation_chunk(
        lambda e: draw(0, e), h, 0, table, count, 10**9)
    thr2 = float(np.float32(0.0075) ** 2)
    pc, pe = ransac_score.score_hypotheses(feat, pq, w16t, tn, thr2)
    kc, ke = ransac_score.score_hypotheses(
        feat.to(dev), pq.to(dev), w16t.to(dev), tn.to(dev), thr2)
    torch.cuda.synchronize()
    # Rows within the expansion's rounding band of thr² may flip; inliers
    # here sit far inside it and outliers far outside.
    assert (kc.cpu() - pc).abs().max() <= 2
    assert (kc.cpu() == pc).float().mean() > 0.99
    # Σerr² carries the expansion's per-row cancellation noise (~1e-6).
    same = kc.cpu() == pc
    assert torch.all(
        (ke.cpu() - pe).abs()[same] <= 1e-3 * pe[same] + 1e-5 * pc[same]
    )


def _histograms(g, n, d=33):
    """Descriptor-like rows: non-negative, L1-normalised, as FPFH."""
    x = torch.rand(n, d, generator=g) ** 4
    return x / x.sum(1, keepdim=True)


def _hold_nn(q, t, mask, dev):
    """The kernel against its plain version: d² within 1e-5 relative (the
    plain version's own fp32 rounding of ‖t‖² − 2t·q, and 3xTF32's
    ~2^-21), and every differing pick a float64 near-tie (≤ 1e-6)."""
    pi, pd = nn.nearest_neighbor(q, t, mask)
    ki, kd = nn.nearest_neighbor(q.to(dev), t.to(dev), mask.to(dev))
    torch.cuda.synchronize()
    ki, kd = ki.cpu(), kd.cpu()
    assert ki.dtype == torch.int32 and kd.shape == pd.shape
    assert float(((kd - pd).abs() / pd.abs().clamp_min(1.0)).max()) <= 1e-5
    rows = (ki != pi).nonzero()[:, 0]
    tm = torch.where(mask[:, None], t, 1.0e6).double()
    q64 = q[rows].double()
    gap = ((tm[ki[rows].long()] - q64).pow(2).sum(1)
           - (tm[pi[rows].long()] - q64).pow(2).sum(1)).abs()
    assert rows.numel() == 0 or float(gap.max()) <= 1e-6
    return ki, kd


@pytest.mark.parametrize("q,m", [(1, 1), (1, 50), (257, 129), (300, 4097),
                                 (1000, 40000)])
def test_nn_descriptor_kernel_ragged(dev, q, m):
    """K5's tensor-core route at ragged Q and M: one query, fewer targets
    than one tile, Q past a 256-query tile, M past a 128-row tile, and a
    grid split over targets."""
    g = torch.Generator().manual_seed(q + m)
    qs, ts = _histograms(g, q), _histograms(g, m)
    mask = torch.rand(m, generator=g) > 0.1
    mask[0] = True
    if m >= 40000:
        assert nn.split_plan(q, m)[1] > 1
    _hold_nn(qs, ts, mask, dev)


def test_nn_descriptor_kernel_seam_ties(dev):
    """Exact duplicates of a query's match on both sides of a tile seam,
    of a split seam, within one thread's columns and across lanes: the
    lowest row wins every time."""
    m = 20000
    per, splits = nn.split_plan(4, m)
    assert splits > 1
    seam = per * nn.T_TILE  # the first row of split 1
    g = torch.Generator().manual_seed(5)
    ts = _histograms(g, m)
    mask = torch.ones(m, dtype=torch.bool)
    groups = [[128, 127], [seam, seam - 1], [130, 129, 3000],
              [seam + 700, 5, seam + 1]]
    qs = _histograms(g, len(groups))
    for i, rows in enumerate(groups):
        ts[rows] = qs[i]
    ki, kd = _hold_nn(qs, ts, mask, dev)
    assert ki.tolist() == [min(r) for r in groups]
    assert float(kd.max()) <= 1e-6


def test_nn_descriptor_kernel_packed_targets(dev):
    """A target operand built once (descriptor_targets) gives the same
    picks and d² as the call that packs the targets itself; one of other
    targets' shape is refused."""
    g = torch.Generator().manual_seed(11)
    qs, ts = _histograms(g, 500).to(dev), _histograms(g, 3000).to(dev)
    mask = (torch.rand(3000, generator=g) > 0.1).to(dev)
    top = nn.descriptor_targets(ts, mask)
    ki, kd = nn.nearest_neighbor(qs, ts, mask)
    pi, pd = nn.nearest_neighbor(qs, ts, mask, packed_targets=top)
    assert torch.equal(ki, pi) and torch.equal(kd, pd)
    with pytest.raises(ValueError):
        nn.nearest_neighbor(qs, ts[:2000], mask[:2000], packed_targets=top)


def test_nn_descriptor_kernel_all_invalid(dev):
    """Every target masked: all sit at the sentinel, and row 0 wins."""
    g = torch.Generator().manual_seed(9)
    qs, ts = _histograms(g, 300), _histograms(g, 1000)
    mask = torch.zeros(1000, dtype=torch.bool)
    ki, _ = _hold_nn(qs, ts, mask, dev)
    assert int(ki.abs().max()) == 0


def _scoring_inputs(n, h, seed=0, invalid=0.1):
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(n, 3, generator=g) - 0.5
    q = p + 3e-4 * torch.randn(n, 3, generator=g)
    out = torch.rand(n, generator=g) < 0.4
    q[out] += 0.05 + 0.15 * torch.rand(int(out.sum()), 3, generator=g)
    mask = torch.rand(n, generator=g) >= invalid
    feat, pq = ransac.build_scoring_factors(p, q, mask)
    # Hypotheses from the valid rows (from every row when none is valid).
    valid = mask if int(mask.sum()) >= 3 else torch.ones_like(mask)
    count = int(valid.sum())
    table = ransac.build_rotation_table(torch.cat([p, q], 1), valid, count)
    draw = ransac.torch_draws(seed)
    w16t, tn, _, _, _ = ransac.solve_rotation_chunk(
        lambda e: draw(0, e), h, 0, table, count, 10**9)
    return feat, pq, w16t, tn, float(np.float32(0.0075) ** 2)


def _hold_score(args, dev):
    """The kernel against its plain version: counts equal on every
    hypothesis (the kernel recomputes in fp32, as the plain version, every
    element inside the band around thr²), sums within the expansion's
    cancellation noise."""
    pc, pe = ransac_score.score_hypotheses(*args)
    before = ransac_score.score_hypotheses.launches
    kc, ke = ransac_score.score_hypotheses(
        *(x.to(dev) for x in args[:4]), args[4])
    torch.cuda.synchronize()
    assert ransac_score.score_hypotheses.launches == before + 1
    kc, ke = kc.cpu(), ke.cpu()
    assert torch.equal(kc, pc)
    assert torch.all((ke - pe).abs() <= 1e-3 * pe + 1e-5 * pc)
    return kc, pc


@pytest.mark.parametrize("n,h", [(8192, 32), (2048, 25600), (1000, 1),
                                 (77, 130), (5000, 700)])
def test_score_kernel_shapes(dev, n, h):
    """K6's tensor-core route at the finalists' shape (H 32 x N 8,192,
    sliced over rows), the estimate shape, one hypothesis, ragged N and H
    (N not a multiple of the row slice, H past one 128-hypothesis tile)."""
    rows, slices = ransac_score.slice_plan(n, h)
    kc, _ = _hold_score(_scoring_inputs(n, h, seed=n + h), dev)
    if (n, h) == (8192, 32):
        assert slices * -(-h // ransac_score.HYP_TILE) >= 132
        assert float(kc.max()) > 1000


def test_score_kernel_band_heavy(dev):
    """Most elements inside the band around thr² (each row's pq set so
    that err² sits within a few 1e-6 of thr²): every warp's list of
    deferred elements fills and is recomputed many times per slice, and
    the counts still equal the plain version's."""
    feat, pq, w16t, tn, thr2 = _scoring_inputs(4096, 300, seed=3)
    w16t = 1e-6 * w16t / w16t.abs().amax(0, keepdim=True)
    tn = torch.zeros_like(tn)
    pq = torch.where(pq < 1e30, torch.full_like(pq, thr2), pq)
    e = feat.T @ w16t + pq[:, None]
    band = ransac_score.band_margin(pq, tn)
    assert float(((e - thr2).abs() <= band).float().mean()) > 0.5
    kc, _ = _hold_score((feat, pq, w16t, tn, thr2), dev)
    assert 0 < float(kc.min()) and float(kc.max()) < 4096


def test_score_kernel_all_rows_invalid(dev):
    """Every row invalid (pq = 1e30): no hypothesis counts anything."""
    feat, pq, w16t, tn, thr2 = _scoring_inputs(600, 300, invalid=1.0)
    assert float(pq.min()) >= 1e30
    kc, _ = _hold_score((feat, pq, w16t, tn, thr2), dev)
    assert float(kc.abs().max()) == 0.0


def test_icp_stats_kernel_matches_plain(dev):
    g = torch.Generator().manual_seed(1)
    m, n, block = 3000, 2048, 64
    tp = torch.rand(m, 3, generator=g) * 2 - 1
    tnrm = torch.nn.functional.normalize(torch.randn(m, 3, generator=g), dim=1)
    tmask = torch.arange(m) < 2900
    target = tpu3d_torch.PointCloud(points=tp, mask=tmask, normals=tnrm)
    src = torch.rand(n, 3, generator=g) * 2 - 1
    src = src[torch.argsort(src[:, 0])]
    smask = torch.rand(n, generator=g) > 0.05
    T = torch.eye(4)
    T[:3, 3] = torch.tensor([0.01, -0.02, 0.005])
    thr = 0.1
    sp = icp.SlabStats(icp.build_icp_target(target), src, smask,
                                 thr, block=block)(T)
    tgt_d = tpu3d_torch.PointCloud(points=tp.to(dev), mask=tmask.to(dev),
                                   normals=tnrm.to(dev))
    before = icp_stats.icp_p2plane_stats.launches
    sk = icp.SlabStats(icp.build_icp_target(tgt_d), src.to(dev),
                                 smask.to(dev), thr, block=block)(T.to(dev))
    torch.cuda.synchronize()
    assert icp_stats.icp_p2plane_stats.launches == before + 1
    assert float(sk.n_corr) == float(sp.n_corr) > 100
    torch.testing.assert_close(sk.sum_d2.cpu(), sp.sum_d2, rtol=1e-5, atol=0)
    torch.testing.assert_close(sk.vec[:36].cpu(), sp.vec[:36], rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(sk.vec[36:42].cpu(), sp.vec[36:42],
                               rtol=1e-4, atol=1e-6)


def _k7_case():
    """A target and query blocks of 64 that reach K7's edges: windows of
    over 1,024 rows (three 512-row tiles), a run of 700 rows at one x
    holding duplicates at row distances 1, 3, 4, 8, 512 and 513 (lane and
    tile seams), one-row and empty windows, a block of invalid queries,
    and invalid target rows at the end."""
    g = torch.Generator().manual_seed(8)
    a = torch.rand(3000, 3, generator=g) * torch.tensor([0.2, 0.3, 0.3])
    run = torch.rand(700, 3, generator=g) * 0.3
    run[:, 0] = 0.1
    for i, d in enumerate((1, 3, 4, 8, 512, 513)):
        run[30 * i + d] = run[30 * i]
    iso = torch.tensor([[10.0, 0.0, 0.0], [11.0, 0.0, 0.0],
                        [12.0, 0.0, 0.0]])
    pts = torch.cat([a, run, iso])
    _, order = torch.sort(pts[:, 0], stable=True)
    pts = torch.cat([pts[order], torch.full((5, 3), 3.0e4)])
    m = pts.shape[0]
    nrm = torch.nn.functional.normalize(torch.randn(m, 3, generator=g), dim=1)
    nrm[-5:] = 0.0
    packed = torch.cat([pts.T, nrm.T]).contiguous()
    sorted_x = pts[:, 0].contiguous()
    blocks = [a[torch.randint(0, 3000, (64,), generator=g)]
              + 0.01 * torch.randn(64, 3, generator=g) for _ in range(6)]
    dup = run[[30 * i for i in range(6)]]  # each also 1-513 rows later
    blocks.append(torch.cat([dup.repeat(8, 1),
                             run[torch.randint(0, 700, (16,), generator=g)]]))
    one = torch.zeros(64, 3)
    one[:, 0] = 11.0 + 0.005 * torch.rand(64, generator=g)
    empty = torch.zeros(64, 3)
    empty[:, 0] = 12.5
    blocks += [one, empty, blocks[0].clone()]
    src = torch.cat(blocks).contiguous()
    qmask = torch.ones(src.shape[0])
    qmask[-64:] = 0.0
    qmask[5] = 0.0
    return src, qmask, packed, sorted_x


def test_icp_kernel_windows_ties_and_edges(dev):
    """K7's sums and its match-only epilogue against the plain versions on
    _k7_case: matches (P, d², row) equal, the lowest duplicate row
    matched, n_corr equal and the sums within the stated tolerances."""
    src, qmask, packed, sorted_x = _k7_case()
    block, thr = 64, 0.05
    thr2 = float(np.float32(thr) * np.float32(thr))
    T = torch.eye(4)
    args = (src, qmask, packed, sorted_x, T, thr)
    pl = icp_stats.icp_matches_plain(*args, block)
    before = (icp_stats.icp_matches.launches,
              icp_stats.icp_p2plane_stats.launches)
    on = tuple(x.to(dev) for x in args[:4]) + (T, thr)
    kn = icp_stats.icp_matches(*on, block)
    ks = icp_stats.icp_p2plane_stats(*on, thr2, block)
    torch.cuda.synchronize()
    assert (icp_stats.icp_matches.launches,
            icp_stats.icp_p2plane_stats.launches) == tuple(
                b + 1 for b in before)
    for k, p in zip(kn, pl):
        assert torch.equal(k.cpu(), p)
    P, d2, row = pl
    # Windows: blocks 0-5 span over two tiles; block 7 has one row, block 8
    # none; the last block is invalid.
    lo, ln = icp_stats.query_windows(sorted_x, P, qmask > 0.5, thr, block)
    assert int(ln[:6].min()) > 1024 and int(ln[7]) == 1 and int(ln[8]) == 0
    assert int(ln[-1]) == 0
    assert bool((row[8 * block:9 * block] == -1).all())
    assert bool((d2[8 * block:9 * block] == 1e30).all())
    # Exact duplicates: the first row of equal coordinates is matched.
    tie = slice(6 * block, 7 * block)
    first = {}
    for i, p in enumerate(packed[:3].T.tolist()):
        first.setdefault(tuple(p), i)
    assert [first[tuple(p)] for p in src[tie].tolist()] == row[tie].tolist()
    assert len({tuple(p) for p in src[tie][:48].tolist()}) == 6
    assert bool((d2[tie] == 0).all())
    ps = icp_stats.icp_p2plane_stats_plain(*args, thr2, block)
    ks = ks.cpu()
    assert float(ks[42]) == float(ps[42]) > 300
    torch.testing.assert_close(ks[:36], ps[:36], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ks[36:42], ps[36:42], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(ks[43], ps[43], rtol=1e-5, atol=0)
    # Repeated calls reuse the block counter: the same sums, bit for bit.
    again = icp_stats.icp_p2plane_stats(*on, thr2, block)
    assert torch.equal(again.cpu(), ks)


def test_icp_kernel_rejects_bad_launch(dev):
    src, qmask, packed, sorted_x = (x.to(dev) for x in _k7_case())
    with pytest.raises(ValueError):  # 1,024 threads
        icp_stats.icp_matches(src, qmask, packed, sorted_x, torch.eye(4),
                              0.05, 128)
    with pytest.raises(ValueError):  # 320 threads
        icp_stats.icp_matches(src, qmask, packed, sorted_x, torch.eye(4),
                              0.05, 40)


@pytest.mark.parametrize("normals", [True, False])
def test_point_to_point_icp_on_card(dev, normals):
    """Point-to-point ICP (asked for, or a target without normals) on the
    card, slab backend through K7's match-only epilogue: the CPU run's
    pose within 1e-5 and its inlier count."""
    src, tgt, R, t = make_pair(4096, voxel=0.005)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=0.005)
    reg = tpu3d_torch.registration
    sd = reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(src, device="cpu"), cfg)
    td = reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(tgt, device="cpu"), cfg)
    td, _ = reg.prepare_features(td, cfg)
    assert td.capacity >= icp.SLAB_MIN_TARGET
    if not normals:
        td = td._replace(normals=None)
    a = 0.01
    T0 = torch.eye(4)
    T0[:3, :3] = torch.from_numpy(R) @ torch.tensor(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
        dtype=torch.float32)
    T0[:3, 3] = torch.from_numpy(t) + torch.tensor([0.003, -0.002, 0.001])
    kw = dict(max_iterations=40, point_to_plane=not normals)
    cpu = icp.icp_refine(sd, td, T0, 0.002, **kw)

    def on(c):
        return tpu3d_torch.PointCloud(
            points=c.points.to(dev), mask=c.mask.to(dev),
            normals=None if c.normals is None else c.normals.to(dev))

    before = icp_stats.icp_matches.launches
    card = icp.icp_refine(on(sd), on(td), T0.to(dev), 0.002, **kw)
    torch.cuda.synchronize()
    assert icp_stats.icp_matches.launches > before
    torch.testing.assert_close(card.transformation.cpu(), cpu.transformation,
                               rtol=0, atol=1e-5)
    n = int(sd.mask.sum())
    assert round(float(card.fitness) * n) == round(float(cpu.fitness) * n)
    assert float(cpu.fitness) > 0.9


def test_register_pair_on_card(dev):
    src, tgt, R, t = make_pair(2048, voxel=0.005)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=0.005,
                                         ransac_max_iterations=30000)
    counts = (nn.nearest_neighbor.launches,
              ransac_score.score_hypotheses.launches,
              icp_stats.icp_p2plane_stats.launches)
    refined, _ = tpu3d_torch.register_pair(
        tpu3d_torch.PointCloud.from_numpy(src, device=dev),
        tpu3d_torch.PointCloud.from_numpy(tgt, device=dev), cfg)
    T = refined.transformation.cpu().numpy()
    assert np.abs(T[:3, :3] - R).max() < 0.02
    assert np.abs(T[:3, 3] - t).max() < 0.005
    # Capacity 2048: K5 serves both the descriptors and brute ICP, K6 the
    # scoring; K7 (slab ICP) starts at 4,096 target rows.
    assert nn.nearest_neighbor.launches > counts[0] + 1
    assert ransac_score.score_hypotheses.launches > counts[1]
    assert icp_stats.icp_p2plane_stats.launches == counts[2]


def _surface_cloud(n, cap, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.3, 0.3, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.03 * np.sin(25 * xy[:, 0]) * np.cos(22 * xy[:, 1])
    return tpu3d_torch.PointCloud.from_numpy(
        np.column_stack([xy, z]).astype(np.float32), capacity=cap,
        device="cpu")


@pytest.mark.parametrize("block,n,lanes", [(128, 20000, True),
                                           (256, 20000, True),
                                           (128, 8000, True),
                                           (128, 80000, False)])
def test_prepare_sweeps_match_plain(dev, block, n, lanes):
    """K2, K3 and K4 on the card against their plain versions on the same
    operands (each sweep fed the plain chain's inputs); K4 by its kernel
    for layouts of more than LANE_BLOCKS_PER_SM blocks per SM (~750
    blocks) and by its kernel with the bins across the lanes (287, 208
    and 194 blocks)."""
    cloud = _surface_cloud(n, n + 480)
    r = 0.012
    r2 = float(np.float32(r) * np.float32(r))
    al, lo, ln = fused_features.aligned_layout(cloud, r, block)
    q8 = fused_features.moments_operands(al)
    on = [x.to(dev) for x in (q8, al.padded_points_t, lo, ln)]
    counts = (features.moments_sweep.launches, features.spfh_sweep.launches,
              features.fpfh_sweep.launches)

    pa = features.moments_sweep(q8, al.padded_points_t, lo, ln, r2, block)
    ka = features.moments_sweep(*on, r2, block).cpu()
    assert torch.equal(ka[3], pa[3]) and float(pa[3].max()) > 10
    well = pa[3] >= 3
    cos = (ka[:3] * pa[:3]).sum(0).abs()
    assert float(cos[well].min()) >= 0.9999

    q8n, pb = fused_features.spfh_operands(al, pa)
    pbk = features.spfh_sweep(q8n, pb, lo, ln, r2, block)
    kbk = features.spfh_sweep(q8n.to(dev), pb.to(dev), on[2], on[3], r2,
                              block).cpu()
    assert torch.equal(kbk[33], pbk[33])
    same = (kbk[:33] == pbk[:33]).all(0)
    assert float(same.float().mean()) >= 0.999

    pc = fused_features.fpfh_operands(al, pbk)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (lo.shape[0] <= features.LANE_BLOCKS_PER_SM * sms) == lanes
    pcs = features.fpfh_sweep(q8, pc, lo, ln, r2, block)
    kcs = features.fpfh_sweep(on[0], pc.to(dev), on[2], on[3], r2,
                              block).cpu()
    torch.testing.assert_close(kcs, pcs, rtol=1e-4, atol=1e-6)
    # On the card's own plain arithmetic, K4 is the same bit for bit.
    card = features.fpfh_sweep_plain(on[0], pc.to(dev), on[2], on[3], r2,
                                     block).cpu()
    assert torch.equal(kcs, card) and float(kcs.abs().max()) > 0
    torch.cuda.synchronize()
    assert (features.moments_sweep.launches, features.spfh_sweep.launches,
            features.fpfh_sweep.launches) == tuple(c + 1 for c in counts)


@pytest.mark.parametrize("block", [128, 256])
def test_fpfh_kernel_block_list(dev, block):
    """K4 over a block list, as the sparse prepare launches it: bit for bit
    the plain version's on the card, with a listed block whose windows are
    all empty and the unlisted rows zero."""
    cloud = _surface_cloud(20000, 20480, seed=2)
    r = 0.012
    r2 = float(np.float32(r) * np.float32(r))
    al, lo, ln = fused_features.aligned_layout(cloud, r, block)
    lens = fused_features.member_lengths(lo, ln, block, 4096 // block)
    len_c = lens[2].clone()
    ids = fused_features.query_blocks(lo.shape[0], 4096 // block)
    len_c[int(ids[0])] = 0  # a listed block with no window
    q8 = fused_features.moments_operands(al)
    g = torch.Generator().manual_seed(block)
    spfh = torch.zeros((40, q8.shape[1]))
    spfh[:33] = torch.rand(33, q8.shape[1], generator=g) * 0.1
    pc = fused_features.fpfh_operands(al, spfh)
    blocks = torch.from_numpy(ids.astype(np.int32))
    on = [x.to(dev) for x in (q8, pc, lo, len_c)]
    pl = features.fpfh_sweep_plain(*on, r2, block,
                                   blocks=blocks.to(dev)).cpu()
    before = features.fpfh_sweep.launches
    kn = features.fpfh_sweep(*on, r2, block, blocks=blocks.to(dev)).cpu()
    torch.cuda.synchronize()
    assert features.fpfh_sweep.launches == before + 1
    assert torch.equal(kn, pl)
    first = int(ids[0]) * block
    assert not kn[first:first + block].any()
    assert float(kn.abs().sum()) > 0


def _k2_plans(block):
    """(slices, warps, per) launches of K2, ``per`` queries a thread: CTAs
    of a whole block, half a block (the sparse prepare's plan) or 32
    queries, a query a thread; two or four queries a thread on CTAs of a
    whole block, two on CTAs of half a block."""
    return [(1, block // 32, 1), (2, block // 64, 1), (block // 32, 1, 1),
            (1, block // 64, 2), (1, block // 128, 4), (2, block // 128, 2)]


def _k3_plans(block):
    """(slices, warps, lanes) launches of K3: a thread a query on CTAs of a
    whole block or half a block, the lane kernel on CTAs of 32 queries (the
    plan for small and sparse layouts) or a whole block."""
    return [(1, block // 32, False), (2, block // 64, False),
            (block // 32, 8, True), (1, 8, True)]


def _hold_k2(monkeypatch, dev, q8, packed3, lo, ln, r2, block):
    """K2 under every launch against its plain version on the card, bit
    for bit; returns the plain result (on the CPU)."""
    on = [x.to(dev) for x in (q8, packed3, lo, ln)]
    plain = features.moments_sweep_plain(*on, r2, block).cpu()
    for plan in _k2_plans(block):
        monkeypatch.setattr(features, "moments_plan", lambda *a, p=plan: p)
        got = features.moments_sweep(*on, r2, block,
                                     sparse=plan[0] > 1).cpu()
        torch.cuda.synchronize()
        assert torch.equal(got[3], plain[3]), plan
        assert torch.equal(got, plain), plan
    return plain


def _hold_k3(monkeypatch, dev, q8n, packed10, lo, ln, r2, block):
    """K3 under every launch against its plain version on the card, bit
    for bit on all 40 rows; returns the plain result."""
    on = [x.to(dev) for x in (q8n, packed10, lo, ln)]
    plain = features.spfh_sweep_plain(*on, r2, block).cpu()
    for plan in _k3_plans(block):
        monkeypatch.setattr(features, "spfh_plan", lambda *a, p=plan: p)
        got = features.spfh_sweep(*on, r2, block, sparse=plan[2]).cpu()
        torch.cuda.synchronize()
        assert torch.equal(got, plain), plan
    return plain


@pytest.mark.parametrize("block", [128, 256])
def test_moments_spfh_kernels_every_plan(dev, monkeypatch, block):
    """K2 and K3 under each launch their plans can take (_k2_plans,
    _k3_plans) on a
    surface layout of ~160 (block 128) or ~80 blocks, against their plain
    versions bit for bit."""
    cloud = _surface_cloud(20000, 20480, seed=4)
    r = 0.012
    r2 = float(np.float32(r) * np.float32(r))
    al, lo, ln = fused_features.aligned_layout(cloud, r, block)
    q8 = fused_features.moments_operands(al)
    nrm8 = _hold_k2(monkeypatch, dev, q8, al.padded_points_t, lo, ln, r2,
                    block)
    assert float(nrm8[3].max()) > 10
    q8n, pb = fused_features.spfh_operands(al, nrm8)
    spfh = _hold_k3(monkeypatch, dev, q8n, pb, lo, ln, r2, block)
    assert float(spfh[33].max()) > 10


def _edge_case(block, live_blocks):
    """Four blocks of crafted operands, r² = 4. Block 0's queries (p = 0
    on the even rows, small random p on the odd) face window 0, rows
    [2·block, 2·block + 200) (two tiles), and window 1, rows 5-39 of it
    again (duplicate rows). Its candidates: ten at d = (2, 0, 0), d² = r²
    exactly, whose b = (2·T_k, 0, 0) put α of a query with n = (1, 0, 0)
    on threshold T_k; ten just outside the radius; ten at d² equal to the
    1e-16 floor and ten just below it; ten at the query (d² = 0); the rest
    random. Queries with n = (T_k, 0, 0) put φ on T_k. Block 2 (if
    ``live_blocks`` is 2) uses block 0's windows, blocks 1 and 3 have
    none; some rows are invalid."""
    rng = np.random.default_rng(block)
    thr = features.THRESH
    m = 4 * block
    q = np.zeros((8, m), np.float32)
    pk = np.zeros((10, m), np.float32)
    q[3] = (rng.uniform(size=m) > 0.1).astype(np.float32)
    odd = np.arange(m) % 2 == 1
    q[:3, odd] = rng.uniform(-0.5, 0.5, (3, int(odd.sum())))
    nrm = rng.normal(size=(3, m))
    nrm /= np.linalg.norm(nrm, axis=0)
    kind = np.arange(m) % 3
    nrm[:, kind == 0] = [[1.0], [0.0], [0.0]]
    nrm[:, kind == 1] = 0.0
    nrm[0, kind == 1] = thr[np.arange(m)[kind == 1] % 10]
    q[4:7] = nrm
    c0 = 2 * block
    # 1e-16 on the floor: the float32 x with fl(x²) == fl(1e-16), and one
    # whose square lies below it.
    floor = np.float32(1e-16)
    xs = np.float32(1e-8) + np.arange(-4000, 4000, dtype=np.float32) * \
        np.spacing(np.float32(1e-8))
    on_floor = xs[(xs * xs) == floor]
    below = xs[(xs * xs) < floor][-1]
    x_floor = on_floor[0] if on_floor.size else xs[(xs * xs) > floor][0]
    cand = np.zeros((10, 200), np.float32)
    cand[:3] = rng.uniform(-2.2, 2.2, (3, 200))
    cand[3:6] = rng.normal(size=(3, 200))
    cand[6:9] = rng.normal(size=(3, 200))
    cand[9] = rng.normal(size=200)
    k = np.arange(10)
    cand[:3, 0:10] = [[2.0], [0.0], [0.0]]
    cand[3:6, 0:10] = 0.0
    cand[3, 0:10] = 2.0 * thr[k]
    cand[:3, 10:20] = [[np.nextafter(np.float32(2), np.float32(3))], [0.0],
                       [0.0]]
    cand[:3, 20:30] = [[x_floor], [0.0], [0.0]]
    cand[:3, 30:40] = [[below], [0.0], [0.0]]
    cand[:3, 40:50] = 0.0
    pk[:, c0:c0 + 200] = cand
    q[:3, c0:c0 + 200] = cand[:3]
    lo = np.zeros((4, 3), np.int32)
    ln = np.zeros((4, 3), np.int32)
    for b in (0, 2)[:live_blocks]:
        lo[b] = [c0, c0 + 5, 0]
        ln[b] = [200, 35, 0]
    t = torch.from_numpy
    return t(q), t(pk), t(lo), t(ln)


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("live_blocks", [1, 2])
def test_moments_spfh_kernels_edge_pairs(dev, monkeypatch, block,
                                         live_blocks):
    """The crafted pairs of _edge_case under every launch, bit for bit
    against the plain versions: d² == r² is in (K2, K3), the 1e-16 floor
    is in for K3 and just below it out, d² = 0 counts for K2 only, α and φ
    exactly on a threshold fall in the bin above it, duplicate rows count
    twice, and the rows of blocks without a window are what an empty walk
    gives them (one live block, or two)."""
    q, pk, lo, ln = _edge_case(block, live_blocks)
    r2 = 4.0
    k2 = _hold_k2(monkeypatch, dev, q, pk[:3].contiguous(), lo, ln, r2,
                  block)
    k3 = _hold_k3(monkeypatch, dev, q, pk, lo, ln, r2, block)
    # Query 0 (p = 0): K2 counts the ten rows at d² = 0 and the twenty
    # below the floor (ten of them in window 1 again) that K3 leaves out.
    assert float(k3[33, 0]) >= 20
    assert float(k2[3, 0] - k3[33, 0]) == 30.0
    dead = torch.ones(4, dtype=torch.bool)
    dead[[0, 2][:live_blocks]] = False
    dead = dead.repeat_interleave(block)
    assert not k3[:, dead].any()
    assert not k2[3, dead].any()


@pytest.mark.parametrize("block", [128, 256])
def test_sparse_windows_equal_dense_on_card(dev, block):
    """A dense layout made sparse (every block's windows zeroed but every
    seventh block's), launched with the sparse grid: K2 and K3 give the
    live blocks' rows of the dense launch bit for bit, every row of the
    plain versions on the sparse windows, and each wrapper counts one
    launch."""
    cloud = _surface_cloud(20000, 20480, seed=5)
    r = 0.012
    r2 = float(np.float32(r) * np.float32(r))
    al, lo, ln = fused_features.aligned_layout(cloud, r, block)
    keep = torch.zeros(lo.shape[0], dtype=torch.bool)
    keep[::7] = True
    ln_s = torch.where(keep[:, None], ln, 0)
    rows = keep.repeat_interleave(block)
    q8 = fused_features.moments_operands(al)
    on = [x.to(dev) for x in (q8, al.padded_points_t, lo)]
    before = (features.moments_sweep.launches, features.spfh_sweep.launches)
    kd = features.moments_sweep(*on, ln.to(dev), r2, block).cpu()
    ks = features.moments_sweep(*on, ln_s.to(dev), r2, block,
                                sparse=True).cpu()
    assert torch.equal(ks[:, rows], kd[:, rows])
    assert torch.equal(ks, features.moments_sweep_plain(
        q8, al.padded_points_t, lo, ln_s, r2, block))
    q8n, pb = fused_features.spfh_operands(al, kd)
    on = [x.to(dev) for x in (q8n, pb, lo)]
    sd = features.spfh_sweep(*on, ln.to(dev), r2, block).cpu()
    ss = features.spfh_sweep(*on, ln_s.to(dev), r2, block, sparse=True)
    assert torch.equal(ss.cpu()[:, rows], sd[:, rows])
    assert torch.equal(ss, features.spfh_sweep_plain(*on, ln_s.to(dev), r2,
                                                     block))
    assert not ss[:, ~rows.to(dev)].any() and float(ss[33].max()) > 10
    torch.cuda.synchronize()
    assert (features.moments_sweep.launches,
            features.spfh_sweep.launches) == (before[0] + 2, before[1] + 2)


def test_moments_spfh_reject_bad_plans(dev, monkeypatch):
    """A plan the kernels do not take raises: slices that do not divide
    the block, more than 8 warps, a thread launch whose warps and queries
    a thread do not cover its slice, K2 at other than 1, 2 or 4 queries a
    thread, a lane launch whose warps do not share its slice's queries
    evenly."""
    q, pk, lo, ln = (x.to(dev) for x in _edge_case(128, 1))
    cases = [("moments_plan", features.moments_sweep, pk[:3].contiguous(),
              [(3, 8, 1), (1, 2, 1), (1, 16, 1), (1, 2, 4), (1, 1, 3)]),
             ("spfh_plan", features.spfh_sweep, pk,
              [(3, 8, True), (4, 16, True), (1, 2, False), (4, 3, True)])]
    for name, fn, packed, bad in cases:
        for plan in bad:
            monkeypatch.setattr(features, name, lambda *a, p=plan: p)
            with pytest.raises(RuntimeError):
                fn(q, packed, lo, ln, 4.0, 128)


def test_prepare_sweeps_reject_bad_block(dev):
    z = torch.zeros((8, 192), device=dev)
    ij = torch.zeros((3, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        features.moments_sweep(z, z[:3], ij, ij, 1e-4, 64)


@pytest.mark.parametrize("block,degenerate", [(128, False), (256, False),
                                              (128, True)])
def test_sparse_equals_dense_on_card(dev, block, degenerate):
    cloud = _surface_cloud(20000, 20480, seed=1)
    if degenerate:
        pts = cloud.points.clone()
        pts[:, 0] = 0.0
        cloud = cloud._replace(points=pts)
    cloud = tpu3d_torch.PointCloud(points=cloud.points.to(dev),
                                   mask=cloud.mask.to(dev))
    _, df = fused_features.fused_prepare_features(cloud, 0.012, block=block)
    _, sf, sorig = fused_features.fused_prepare_sparse(
        cloud, 0.012, corr_cap=4096, block=block)
    sm = sf.mask
    assert int(sm.sum()) > 100
    assert torch.equal(sf.descriptors[sm], df.descriptors[sorig[sm]])


def test_sparse_register_pair_on_card(dev):
    """The sparse arm at bucket 32,768 launches every kernel K2-K7."""
    src, tgt, R, t = make_pair(40000, voxel=0.004)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=0.004,
                                         ransac_max_iterations=30000)
    kernels = (features.moments_sweep, features.spfh_sweep,
               features.fpfh_sweep, nn.nearest_neighbor,
               ransac_score.score_hypotheses, icp_stats.icp_p2plane_stats)
    before = [k.launches for k in kernels]
    refined, _ = tpu3d_torch.register_pair(
        tpu3d_torch.PointCloud.from_numpy(src, device=dev),
        tpu3d_torch.PointCloud.from_numpy(tgt, device=dev), cfg)
    T = refined.transformation.cpu().numpy()
    assert np.abs(T[:3, :3] - R).max() < 0.02
    assert np.abs(T[:3, 3] - t).max() < 0.005
    assert all(k.launches > b for k, b in zip(kernels, before))


# sigma_s for each radius K9 takes, r = min(int(2 sigma_s + 0.5), 5).
_BF_SIGMAS = [(0.1, 0), (0.5, 1), (1.0, 2), (1.5, 3), (2.0, 4), (3.0, 5)]


def _hold_k9(dev, d, sigma_s):
    """K9 on frame ``d``: bit for bit equal to the plain version run on
    the card (the same expf), one launch."""
    pd = depth.bilateral_filter_plain(d.to(dev), sigma_s, 0.05)
    before = depth.bilateral_filter.launches
    kd = depth.bilateral_filter(d.to(dev), sigma_s, 0.05)
    torch.cuda.synchronize()
    assert depth.bilateral_filter.launches == before + 1
    assert kd.is_cuda and kd.shape == d.shape
    assert torch.equal(kd, pd)
    return kd


@pytest.mark.parametrize("sigma_s,radius", _BF_SIGMAS)
def test_bilateral_kernel_matches_plain(dev, sigma_s, radius):
    """K9 on a frame with holes and a zero border strip, odd sizes so the
    CTAs meet the frame's edge part way, at every radius: bit for bit
    equal to the plain version on the card, and within 1e-6 of the CPU's
    (another expf)."""
    g = torch.Generator().manual_seed(radius)
    d = 0.5 + torch.rand(203, 301, generator=g)
    d[torch.rand(203, 301, generator=g) < 0.2] = 0.0
    d[:, :3] = 0.0
    d[40:60, 50:90] += 0.3  # a step well above sigma_range
    assert depth.bf_radius(sigma_s) == radius
    pd = depth.bilateral_filter(d, sigma_s, 0.05)
    kd = _hold_k9(dev, d, sigma_s)
    assert torch.equal(kd.cpu() == 0, pd == 0)
    assert float((kd.cpu() - pd).abs().max()) <= 1e-6


def _bf_frames():
    """Frames whose centres are mostly zero (odd sizes): all zero; zero
    over a region wider than any CTA's pixels, so that CTAs inside it have
    only zero centres but halos that reach depth; one masked instance."""
    g = torch.Generator().manual_seed(7)
    full = 0.5 + torch.rand(181, 333, generator=g)
    full[torch.rand(181, 333, generator=g) < 0.1] = 0.0
    hole = full.clone()
    hole[16:112, 64:224] = 0.0
    inst = torch.zeros_like(full)
    inst[37:121, 45:170] = full[37:121, 45:170]
    return {"zero": torch.zeros(181, 333), "hole": hole, "instance": inst}


@pytest.mark.parametrize("kind", ["zero", "hole", "instance"])
@pytest.mark.parametrize("sigma_s,radius", _BF_SIGMAS)
def test_bilateral_kernel_zero_centres(dev, kind, sigma_s, radius):
    """K9 where most centres are zero, the work its CTAs and threads
    retire: bit for bit equal to the plain version, zero exactly where the
    centre is."""
    d = _bf_frames()[kind]
    kd = _hold_k9(dev, d, sigma_s)
    assert torch.equal(kd.cpu() == 0, d <= 0)


def test_bilateral_kernel_rejects_double_and_batch(dev):
    with pytest.raises(TypeError):
        depth.bilateral_filter(torch.ones(8, 8, dtype=torch.float64,
                                          device=dev))
    with pytest.raises(ValueError):
        depth.bilateral_filter(torch.ones(2, 8, 8, device=dev))


@pytest.mark.parametrize("iters", [3000, 20000])
def test_gather_routes_on_card(dev, iters):
    """Below 2,048 rows RANSAC draws with the gather sampler: one shot at
    3,000 hypotheses, chunked at 20,000; both find the pose on the card."""
    src, tgt, R, t = make_pair(1500, voxel=0.005)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=0.005,
                                         ransac_max_iterations=iters)
    before = ransac_score.score_hypotheses.launches
    k11 = ransac.gather_hypotheses.launches
    refined, coarse = tpu3d_torch.register_pair(
        tpu3d_torch.PointCloud.from_numpy(src, device=dev),
        tpu3d_torch.PointCloud.from_numpy(tgt, device=dev), cfg)
    T = refined.transformation.cpu().numpy()
    assert float(coarse.fitness) > 0.3
    assert np.abs(T[:3, :3] - R).max() < 0.02
    assert np.abs(T[:3, 3] - t).max() < 0.005
    assert ransac_score.score_hypotheses.launches > before
    assert ransac.gather_hypotheses.launches > k11


def test_pipeline_cli_on_card(dev, tmp_path, capsys):
    """``python -m tpu3d_torch`` on a small demo config runs on the card,
    with K9 in the depth front end."""
    from tpu3d_torch.__main__ import main

    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(
        "camera:\n  width: 320\n  height: 240\n"
        "depth:\n  bilateral_filter: true\n"
        "registration:\n  voxel_size: 0.005\n  ransac_max_iterations: 500\n"
        "  icp_max_iterations: 10\n"
        "use_camera: false\nuse_robot: false\nvisualization: \"none\"\n"
    )
    before = depth.bilateral_filter.launches
    assert main([str(cfg_path)]) == 0
    out = capsys.readouterr().out
    assert "accelerator=on" in out and "Computed 1 pick poses." in out
    assert depth.bilateral_filter.launches == before + 1


def _walk_inputs(block, k_windows, seed):
    """A target with duplicated rows (ties) and a masked tail, and jittered
    queries with masked rows, as K8's operands (CPU tensors)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.2, 0.2, (3000, 3)).astype(np.float32)
    t = np.concatenate([base, base[:1000]])
    tm = np.ones(len(t), bool)
    tm[-300:] = False
    q = (t[::2] + rng.normal(0, 0.004, t[::2].shape)).astype(np.float32)
    qm = rng.uniform(size=len(q)) > 0.1
    wt = nn_walk.build_walk_target(torch.from_numpy(t), torch.from_numpy(tm),
                                   0.01)
    q4, lo, ln, _ = nn_walk.walk_operands(wt, torch.from_numpy(q),
                                          torch.from_numpy(qm), 0.01, block,
                                          k_windows)
    return q4, wt.packed, lo, ln, float(np.float32(0.01) ** 2)


def _k8_plans(block):
    """Every launch K8's plan can take at ``block``: (slices, per) with a
    multiple of 32 threads a CTA."""
    return [(s, p) for s in (1, 2, 4) for p in (1, 2, 4)
            if (block // (s * p)) % 32 == 0]


def _hold_k8(monkeypatch, dev, q4, packed, lo, ln, r2, block, subs):
    """K8 under every launch its plan can take and each staged tile of
    ``subs``: d2 and the index equal the plain version's (on the CPU) bit
    for bit on every row, one launch each; returns the plain result."""
    pd, pi = nn_walk.top1_walk(q4, packed, lo, ln, r2, block)
    on_card = [a.to(dev) for a in (q4, packed, lo, ln)]
    for plan, sub in itertools.product(_k8_plans(block), subs):
        monkeypatch.setattr(nn_walk, "nn_walk_plan", lambda *a, p=plan: p)
        before = nn_walk.top1_walk.launches
        kd, ki = nn_walk.top1_walk(*on_card, r2, block, sub=sub)
        torch.cuda.synchronize()
        assert nn_walk.top1_walk.launches == before + 1
        assert ki.dtype == torch.int32 and kd.dtype == torch.float32
        assert torch.equal(ki.cpu(), pi), (plan, sub)
        assert torch.equal(kd.cpu(), pd), (plan, sub)
    return pd, pi


@pytest.mark.parametrize("block", [128, 256, 512])
@pytest.mark.parametrize("k_windows", list(range(1, 17)))
def test_nn_walk_kernel_matches_plain(dev, monkeypatch, block, k_windows):
    """K8 equals its plain version bit for bit under every launch its plan
    can take: d2, and the index on every row, rows without a match
    included; K from 1 to 16, each block size, one staged tile a case."""
    args = _walk_inputs(block, k_windows, block + k_windows)
    pd, _ = _hold_k8(monkeypatch, dev, *args, block,
                     [(128, 256, 512)[k_windows % 3]])
    matched = pd < 1e29
    assert 0 < int(matched.sum()) < matched.numel()


def _walk_lattice(block, seed):
    """K8 operands of exact ties: coordinates on a 1/64 grid in a small
    cube, so many rows lie at the same d2 from a query (every difference,
    square and sum is exact in fp32), and payloads a permutation, so that
    each tie picks a different index. Five query blocks of windows:
    0. five windows, one empty, crossing tile boundaries, ending mid-group,
       the third repeating rows of the first (ties across windows);
    1. every window empty;
    2. every query invalid, windows not empty;
    3. one window ending mid-tile, the rest empty;
    4. windows of 1, 7, 8 and 9 rows, one empty.
    The target repeats rows within a tile (rows 8-15 equal row 8) and
    across tiles (row 700 equals row 100)."""
    rng = np.random.default_rng(seed)
    m, nb, k = 3000, 5, 5
    packed = np.empty((4, m), np.float32)
    packed[:3] = rng.integers(-6, 7, (3, m)) / 64
    packed[:3, 8:16] = packed[:3, 8:9]
    packed[:3, 700] = packed[:3, 100]
    packed[3] = rng.permutation(m)
    q4 = np.empty((4, nb * block), np.float32)
    q4[:3] = rng.integers(-6, 7, (3, nb * block)) / 64
    q4[3] = rng.uniform(size=nb * block) > 0.1
    q4[3, 2 * block:3 * block] = 0.0
    lo = np.array([[0, 600, 0, 1500, 2990], [0] * 5, [200, 900, 0, 0, 0],
                   [37, 0, 0, 0, 0], [3, 10, 20, 40, 60]], np.int32)
    ln = np.array([[517, 0, 300, 1309, 10], [0] * 5, [500, 700, 0, 0, 0],
                   [301, 0, 0, 0, 0], [1, 7, 0, 8, 9]], np.int32)
    r2 = float(np.float32(3 / 64) ** 2)
    return (torch.from_numpy(q4), torch.from_numpy(packed),
            torch.from_numpy(lo), torch.from_numpy(ln), r2)


@pytest.mark.parametrize("block", [128, 256, 512])
def test_nn_walk_kernel_ties_and_edges(dev, monkeypatch, block):
    """K8 on exact ties inside one tile, across tiles and across windows,
    empty windows, an all-empty block, an all-invalid block, and windows
    that end mid-tile and mid-group: bit for bit equal to the plain
    version under every launch and every staged tile."""
    q4, packed, lo, ln, r2 = _walk_lattice(block, block)
    pd, pi = _hold_k8(monkeypatch, dev, q4, packed, lo, ln, r2, block,
                      (128, 256, 512))
    rows = pi.reshape(5, block)
    assert torch.equal(rows[1], torch.zeros(block, dtype=torch.int32))
    assert bool((pd.reshape(5, block)[2] == 1e30).all())
    assert int((pd < 1e29).sum()) > block  # matches, at exact ties


def test_nn_walk_kernel_rejects_bad_inputs(dev):
    q4, packed, lo, ln, r2 = (a.to(dev) if torch.is_tensor(a) else a
                              for a in _walk_inputs(128, 8, 0))
    with pytest.raises(ValueError, match="block"):
        nn_walk.top1_walk(q4, packed, lo, ln, r2, 64)
    with pytest.raises(TypeError):
        nn_walk.top1_walk(q4.double(), packed.double(), lo, ln, r2, 128)
    huge = torch.zeros((4, 1), device=dev).expand(4, 1 << 24)
    with pytest.raises(ValueError, match="2\\^24"):
        nn_walk.top1_walk(q4, huge, lo, ln, r2, 128)


def test_slab2_top1_on_card(dev):
    """The entry point on the card equals its CPU run, index and d²."""
    src, tgt, _, _ = make_pair(30000, seed=5)
    m = torch.ones(30000, dtype=torch.bool)
    args = (torch.from_numpy(src), m, torch.from_numpy(tgt), m, 0.004)
    pi, pd = nn_walk.slab2_top1(*args, block=512, sub=512, k_windows=8)
    before = nn_walk.top1_walk.launches
    ki, kd = nn_walk.slab2_top1(*(a.to(dev) if torch.is_tensor(a) else a
                                  for a in args),
                                block=512, sub=512, k_windows=8)
    torch.cuda.synchronize()
    assert nn_walk.top1_walk.launches == before + 1
    assert torch.equal(ki.cpu(), pi) and torch.equal(kd.cpu(), pd)


def test_probe_kernels_match_pytorch(dev):
    before = {n: f.launches for n, f in probe.WRAPPERS.items()}
    results = probe.run(dev)
    torch.cuda.synchronize()
    assert all(r["ok"] for r in results), results
    assert all(f.launches > before[n] for n, f in probe.WRAPPERS.items())
    # argmin with ties: the lowest index, as torch.argmin.
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 5, (64, 1000), generator=g).float()
    assert torch.equal(probe.row_argmin(x.to(dev)).cpu(),
                       probe.row_argmin_plain(x))
    big = torch.rand(300, 300, generator=g)
    assert torch.equal(probe.transpose(big.to(dev)).cpu(), big.T)


def test_voxel_downsample_is_deterministic(dev):
    """The voxel centroids on the card, five runs over a masked 1M-point
    cloud with colors (most rows padding): equal to each other and to the
    CPU's bit for bit, so that every registration from them repeats."""
    from tpu3d_torch.ops import voxel

    g = torch.Generator().manual_seed(11)
    n = 1 << 20
    pts = torch.rand(n, 3, generator=g) * torch.tensor([0.4, 0.3, 0.05])
    mask = torch.rand(n, generator=g) < 0.15
    cols = torch.rand(n, 3, generator=g)
    cpu = voxel.voxel_downsample(
        tpu3d_torch.PointCloud(points=pts, mask=mask, colors=cols), 0.002)
    card = tpu3d_torch.PointCloud(points=pts.to(dev), mask=mask.to(dev),
                                  colors=cols.to(dev))
    runs = [voxel.voxel_downsample(card, 0.002) for _ in range(5)]
    assert int(cpu.mask.sum()) > 10000
    for out in runs:
        assert torch.equal(out.mask.cpu(), cpu.mask)
        assert torch.equal(out.points.cpu(), cpu.points)
        assert torch.equal(out.colors.cpu(), cpu.colors)


# --- The neighbour backends (plain PyTorch, no kernel) on the card equal
# their CPU runs: the grid index, its searches, slab_knn and
# surface_neighbors bit for bit (each d² rounded (dx² + dy²) + dz² on both
# devices), and ICP on the grid backend at the CPU's pose.


def _wavy_surface(n, seed):
    g = np.random.default_rng(seed)
    xy = g.uniform(-0.2, 0.2, size=(n, 2)).astype(np.float32)
    z = 0.7 + 0.03 * np.sin(20 * xy[:, 0]) * np.cos(18 * xy[:, 1])
    return np.column_stack([xy, z]).astype(np.float32)


@pytest.mark.parametrize("cell", [0.01, 1e-6])
def test_grid_on_card_equals_cpu(dev, cell):
    from tpu3d_torch.ops import grid

    pts = torch.from_numpy(_wavy_surface(6000, 1))
    mask = torch.arange(6000) < 5800
    q = pts[::3] + 0.002
    cpu = grid.build_grid(pts, mask, cell)
    card = grid.build_grid(pts.to(dev), mask.to(dev), cell)
    for f in grid.GridIndex._fields:
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    for a, b in zip(grid.grid_top1(card, q.to(dev)), grid.grid_top1(cpu, q)):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(grid.grid_knn(card, q.to(dev), k=30),
                    grid.grid_knn(cpu, q, k=30)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("slice_cap,k", [(8192, 30), (256, 30), (16, 30)])
def test_slab_knn_on_card_equals_cpu(dev, slice_cap, k):
    from tpu3d_torch.ops import slab

    pts = torch.from_numpy(_wavy_surface(20000, 2))
    mask = torch.arange(20000) < 19500
    cpu = slab.build_slab(pts, mask)
    card = slab.build_slab(pts.to(dev), mask.to(dev))
    q = cpu.sorted_points_t.T.contiguous()
    want = slab.slab_knn(cpu, q, 0.01, k=k, slice_cap=slice_cap)
    got = slab.slab_knn(card, q.to(dev), 0.01, k=k, slice_cap=slice_cap)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert bool((want[1] < 1e29).any())


@pytest.mark.parametrize("mode", ["slab", "grid", "brute"])
def test_surface_neighbors_on_card_equals_cpu(dev, mode):
    """Slab and grid bit for bit; brute's d² is the matmul expansion, whose
    rounding the two devices' products differ in, which reorders near-tied
    neighbours: indices equal in ≥ 99 % of slots, d² within 1e-5 absolute
    (as the K5 tests hold it)."""
    reg = tpu3d_torch.registration
    cloud = tpu3d_torch.PointCloud.from_numpy(_wavy_surface(8000, 3),
                                              capacity=8192, device="cpu")
    on = cloud._replace(points=cloud.points.to(dev),
                        mask=cloud.mask.to(dev))
    ci, cd = reg.surface_neighbors(cloud, 0.02, k=100, mode=mode)
    gi, gd = reg.surface_neighbors(on, 0.02, k=100, mode=mode)
    assert gi.is_cuda and gi.shape == ci.shape == (8192, 100)
    if mode == "brute":
        assert (gi.cpu() == ci).float().mean() >= 0.99
        torch.testing.assert_close(gd.cpu(), cd, rtol=0, atol=1e-5)
    else:
        assert torch.equal(gi.cpu(), ci) and torch.equal(gd.cpu(), cd)


def test_icp_grid_backend_on_card(dev):
    """icp_refine(nn_mode='grid') on the card lands on the CPU pose within
    1e-5 with the same inlier count (float sums in another order)."""
    src, tgt, R, t = make_pair(4096, voxel=0.005)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=0.005)
    reg = tpu3d_torch.registration
    sd = reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(src, device="cpu"), cfg)
    td = reg.prepare_icp_target(
        tpu3d_torch.PointCloud.from_numpy(tgt, device="cpu"), cfg)
    T0 = torch.eye(4)
    T0[:3, :3] = torch.from_numpy(R)
    T0[:3, 3] = torch.from_numpy(t) + torch.tensor([0.002, -0.001, 0.001])
    kw = dict(max_iterations=40, nn_mode="grid")
    cpu = icp.icp_refine(sd, td, T0, 0.002, **kw)

    def on(c):
        return tpu3d_torch.PointCloud(
            points=c.points.to(dev), mask=c.mask.to(dev),
            normals=None if c.normals is None else c.normals.to(dev))

    card = icp.icp_refine(on(sd), on(td), T0.to(dev), 0.002, **kw)
    torch.testing.assert_close(card.transformation.cpu(), cpu.transformation,
                               rtol=0, atol=1e-5)
    n = int(sd.mask.sum())
    assert round(float(card.fitness) * n) == round(float(cpu.fitness) * n)
    assert float(cpu.fitness) > 0.9


@pytest.mark.parametrize("rows,cols", [(8, 256), (5, 33), (3, 1), (64, 1000)])
def test_probe_cumsum_bit_for_bit(dev, rows, cols):
    """The warp-scan cumsum equals its plain version (the same order of
    additions) bit for bit, ragged last pieces and signed zeros
    included."""
    g = torch.Generator().manual_seed(rows * cols)
    x = torch.randn(rows, cols, generator=g)
    x[0, :3] = -0.0
    assert torch.equal(probe.row_cumsum(x.to(dev)).cpu(),
                       probe.row_cumsum_plain(x))
    for n in (1, 31, 32, 33, 128):
        y = torch.rand(n, n, generator=g)
        assert torch.equal(probe.transpose(y.to(dev)).cpu(),
                           probe.transpose_plain(y))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_nn_on_virtual_mesh_equals_one_device(dev, n_shards):
    """K5 per target shard and K8 per shard's walk on a mesh that lists
    the card ``n_shards`` times: the brute indices and d2 equal the
    single-device K5's; the walk's d2 equal bit for bit and its indices
    wherever the minimum is unique; rows duplicated across a shard seam
    go to the lower row."""
    from tpu3d_torch.parallel import make_mesh
    from tpu3d_torch.parallel import sharded_nn

    mesh = make_mesh(devices=[dev] * n_shards)
    g = torch.Generator().manual_seed(n_shards)
    m = 4096
    t = torch.rand(m, 3, generator=g) * 0.2
    sr = m // n_shards
    for s in range(1, n_shards):
        t[s * sr] = t[s * sr - 1]
    mask = torch.rand(m, generator=g) > 0.05
    mask[[s * sr - 1 for s in range(1, n_shards)]] = True
    mask[[s * sr for s in range(1, n_shards)]] = True
    q = torch.cat([t[[s * sr for s in range(1, n_shards)]],
                   torch.rand(1000, 3, generator=g) * 0.2])
    qm = torch.ones(q.shape[0], dtype=torch.bool)
    t, mask, q, qm = (x.to(dev) for x in (t, mask, q, qm))
    i1, d1 = nn.nearest_neighbor(q, t, mask)
    i4, d4 = sharded_nn.nearest_neighbor_sharded(q, t, mask, mesh)
    assert torch.equal(i4, i1) and torch.equal(d4, d1)
    assert i4[:n_shards - 1].tolist() == [s * sr - 1
                                          for s in range(1, n_shards)]
    r = 0.01
    w1, wd1 = nn_walk.slab2_top1(q, qm, t, mask, r)
    sw = sharded_nn.build_walk_sharded(t, mask, r, mesh)
    w4, wd4 = sharded_nn.slab2_top1_sharded(sw, q, qm, r, mesh)
    hit = wd1 < 1e29
    assert torch.equal(hit, wd4 < 1e29) and int(hit.sum()) > 100
    assert torch.equal(wd4[hit], wd1[hit])
    rows = ((w4 != w1) & hit).nonzero()[:, 0]
    assert torch.equal(((t[w4[rows].long()] - q[rows]) ** 2).sum(1),
                       ((t[w1[rows].long()] - q[rows]) ** 2).sum(1))


def test_sharded_prepare_on_virtual_mesh_equals_one_device(dev):
    """The halo-exchange prepare (K2-K4 per shard) on 4 shards of the
    card: ok, every valid row's normal within |cos| >= 0.9999 of the
    single-device prepare's on the same partitioned rows and the
    descriptors' correspondences agreeing on >= 91 %; a K2-K4 launch on
    each shard."""
    from tpu3d_torch.parallel import make_mesh
    from tpu3d_torch.parallel import prepare_sharded as ps

    pts_np, _, _, _ = make_pair(20000, voxel=0.004)
    cloud = tpu3d_torch.PointCloud.from_numpy(pts_np, capacity=20480,
                                              device="cpu")
    r = float(np.float32(0.02))
    p, m, _ = ps.x_partition(cloud.points, cloud.mask, 4)
    before = [f.launches for f in (features.moments_sweep,
                                   features.spfh_sweep, features.fpfh_sweep)]
    card = ps.fused_prepare_sharded(p.to(dev), m.to(dev), r,
                                    make_mesh(devices=[dev] * 4), halo=2048)
    after = [f.launches for f in (features.moments_sweep,
                                  features.spfh_sweep, features.fpfh_sweep)]
    assert bool(card[2])
    assert [a - b for a, b in zip(after, before)] == [4, 4, 4]
    one_c, one_f = fused_features.fused_prepare_features(
        tpu3d_torch.PointCloud(points=p.to(dev), mask=m.to(dev)), r)
    v = m.to(dev)
    cos = (card[0].normals[v] * one_c.normals[v]).sum(1).abs()
    assert float(cos.min()) >= 0.9999
    idx, _ = nn.nearest_neighbor(card[1].descriptors[v], one_f.descriptors[v],
                                 torch.ones(int(v.sum()), dtype=torch.bool,
                                            device=dev))
    agree = (idx == torch.arange(int(v.sum()), device=dev)).float().mean()
    assert float(agree) >= 0.91


def _hyp_inputs(n, count, h, seed, first_id=0, max_it=10**9):
    """A rotation table of ``count`` valid rows in ``n`` (rigid pairs with
    outliers and a few duplicated rows) and one chunk's K10 params."""
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(n, 3, generator=g) * 0.3 - 0.15
    q = p @ torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                          [0.0, 0.0, 1.0]]) + 0.05
    q += 1e-3 * torch.randn(n, 3, generator=g)
    out = torch.rand(n, generator=g) < 0.4
    q[out] = torch.rand(int(out.sum()), 3, generator=g) * 0.3
    p[1:8] = p[0]  # degenerate triples
    mask = torch.zeros(n, dtype=torch.bool)
    mask[torch.randperm(n, generator=g)[:count]] = True
    table = ransac.build_rotation_table(torch.cat([p, q], 1), mask,
                                        max(count, 1))
    draw = ransac.torch_draws(seed)
    params = torch.tensor(ransac.epoch_params(
        lambda e: draw(0, e), -(-h // n), first_id, max(count, 1), max_it),
        dtype=torch.int32)
    return table, params


@pytest.mark.parametrize("n,count,h,first_id,max_it", [
    (8192, 8000, 25600, 0, 10**9), (8192, 8192, 25600, 90000, 100000),
    (3000, 2999, 7000, 5, 6000), (100, 2, 300, 0, 10**9),
    (100, 100, 1, 0, 10**9),
])
def test_ransac_hyp_kernel_matches_plain(dev, n, count, h, first_id,
                                         max_it):
    """K10 against its plain version on the CPU and on the card: the
    disabled flags equal, the w16 columns and ‖t‖² bit for bit (both round
    every operation once and contract the same products), at the main
    path's chunk (8,192 x 25,600), with the budget ending mid-chunk, an
    odd count, and count < 3 (every triple disabled)."""
    table, params = _hyp_inputs(n, count, h, n + h, first_id, max_it)
    pw, pt, pd = ransac.rotation_hypotheses(table, params, h)
    before = ransac.rotation_hypotheses.launches
    kw, kt, kd = ransac.rotation_hypotheses(table.to(dev), params.to(dev), h)
    cw, ct, cd = ransac.rotation_hypotheses_plain(table.to(dev),
                                                  params.to(dev), h)
    torch.cuda.synchronize()
    assert ransac.rotation_hypotheses.launches == before + 1
    assert kw.shape == (16, h) and kd.dtype == torch.bool
    assert torch.equal(kd.cpu(), pd) and torch.equal(cd.cpu(), pd)
    assert torch.equal(kw.cpu(), pw) and torch.equal(kt.cpu(), pt)
    assert torch.equal(cw.cpu(), pw) and torch.equal(ct.cpu(), pt)
    if count < 3:
        assert bool(kd.all())
    assert torch.isfinite(kw).all()


def test_ransac_hyp_kernel_rejects_bad_inputs(dev):
    table, params = _hyp_inputs(256, 200, 512, 0)
    table, params = table.to(dev), params.to(dev)
    with pytest.raises(TypeError):
        ransac.rotation_hypotheses(table.double(), params, 512)
    with pytest.raises(TypeError):
        ransac.rotation_hypotheses(table, params.long(), 512)
    with pytest.raises(ValueError):
        ransac.rotation_hypotheses(table[:, :-1], params, 512)
    with pytest.raises(ValueError):
        ransac.rotation_hypotheses(table, params[:4], 512)


@pytest.mark.parametrize("confidence", [0.999, 0.3])
def test_chunk_graph_equals_eager_on_card(dev, confidence):
    """RANSAC's chunked rotation route on the bucket-8,192 pair with its
    chunks replayed as one CUDA graph against the same chunks run
    eagerly: the same pose and fitness bit for bit, one graph for both
    calls of a shape (a second call, and one with another valid count,
    capture nothing), K10 counted once a chunk in both."""
    src, tgt, _, _ = make_pair(8192, voxel=0.005)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=0.005)
    from tpu3d_torch import registration as reg

    sd = reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(src, device=dev), cfg)
    td = reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(tgt, device=dev), cfg)
    sd, sf = reg.prepare_features(sd, cfg, "fused")
    td, tf = reg.prepare_features(td, cfg, "fused")
    chunks = []

    class Draws(type(ransac.torch_draws(0))):
        def __call__(self, c, e):
            chunks.append(c)
            return super().__call__(c, e)

    def run(graph, mask=None):
        chunks.clear()
        ransac.CHUNK_GRAPH = graph
        try:
            s = sd if mask is None else sd._replace(mask=mask)
            before = ransac.rotation_hypotheses.launches
            res = ransac.ransac_registration(
                s, td, sf, tf, 0.005, confidence=confidence,
                draws=Draws(42))
            torch.cuda.synchronize()
            k10 = ransac.rotation_hypotheses.launches - before
        finally:
            ransac.CHUNK_GRAPH = True
        return res, len(set(chunks)), k10

    eager, n_e, k_e = run(False)
    graph, n_g, k_g = run(True)
    assert n_e == n_g >= 1 and k_e == n_e
    # The first call of a shape runs one eager warm-up chunk, then
    # replays from chunk 0.
    assert k_g in (n_g, n_g + 1)
    assert torch.equal(eager.transformation, graph.transformation)
    assert float(eager.fitness) == float(graph.fitness)
    cached = len(ransac._graphs)
    again, n_a, k_a = run(True)
    assert torch.equal(again.transformation, graph.transformation)
    assert len(ransac._graphs) == cached and k_a == n_a
    fewer = sd.mask.clone()
    fewer[::3] = False
    e2 = run(False, fewer)[0]
    g2, n2, k2 = run(True, fewer)
    assert len(ransac._graphs) == cached and k2 == n2
    assert torch.equal(e2.transformation, g2.transformation)


def test_sharded_ransac_launches_k10_on_card(dev):
    """The sharded RANSAC solves each shard's slice of a round by K10."""
    from tpu3d_torch.parallel import make_mesh
    from tpu3d_torch.parallel.ransac_sharded import (
        ransac_registration_sharded,
    )

    src, tgt, R, t = make_pair(4096, voxel=0.005)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=0.005)
    from tpu3d_torch import registration as reg

    sd, sf = reg.prepare_features(reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(src, device=dev), cfg), cfg,
        "fused")
    td, tf = reg.prepare_features(reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(tgt, device=dev), cfg), cfg,
        "fused")
    before = ransac.rotation_hypotheses.launches
    res = ransac_registration_sharded(sd, td, sf, tf, 0.005,
                                      make_mesh(devices=[dev] * 2),
                                      max_iterations=30000)
    torch.cuda.synchronize()
    assert ransac.rotation_hypotheses.launches >= before + 2
    T = res.transformation.cpu().numpy()
    assert np.abs(T[:3, :3] - R).max() < 0.02


def _gather_inputs(n, count, h, seed, first_id=0, max_it=10**9):
    """``count`` valid rows of ``n`` (rigid pairs with outliers and a few
    coincident rows), valid first in ``perm``, the packed p|q rows, and
    one call's K11 params from the default draw stream."""
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(n, 3, generator=g) * 0.3 - 0.15
    q = p @ torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0],
                          [0.0, 0.0, 1.0]]) + 0.05
    q += 1e-3 * torch.randn(n, 3, generator=g)
    out = torch.rand(n, generator=g) < 0.4
    q[out] = torch.rand(int(out.sum()), 3, generator=g) * 0.3
    p[1:8], q[1:8] = p[0], q[0]  # degenerate samples
    mask = torch.zeros(n, dtype=torch.bool)
    mask[torch.randperm(n, generator=g)[:count]] = True
    perm = torch.sort((~mask).to(torch.int8), stable=True)[1]
    tri = ransac.torch_draws(seed).triples(None, h, max(count, 1))
    params = ransac.gather_params(tri, first_id, max_it, n)
    return params, perm, torch.cat([p, q], 1)


@pytest.mark.parametrize("n,count,h,first_id,max_it", [
    (8192, 5190, 4096, 0, 4096), (8192, 5190, 25600, 51200, 60000),
    (8192, 8192, 100352, 0, 100000), (100, 2, 300, 0, 10**9),
    (1500, 700, 1, 0, 10**9),
])
def test_gather_hyp_kernel_matches_plain(dev, n, count, h, first_id,
                                         max_it):
    """K11 against its plain version on the CPU and on the card: the
    disabled flags equal, the w16 columns and ‖t‖² bit for bit (both round
    every operation once, in one order), at the 64 batch's 4,096, a gather
    chunk's 25,600 with the budget ending inside it, the two-stage route's
    100,352 at 100k, count 2 (every triple repeats a row) and one
    hypothesis."""
    params, perm, pq = _gather_inputs(n, count, h, n + h, first_id, max_it)
    pw, pt, pd = ransac.gather_hypotheses(params, perm, pq, h)
    before = ransac.gather_hypotheses.launches
    args = (params.to(dev), perm.to(dev), pq.to(dev), h)
    kw, kt, kd = ransac.gather_hypotheses(*args)
    cw, ct, cd = ransac.gather_hypotheses_plain(*args)
    torch.cuda.synchronize()
    assert ransac.gather_hypotheses.launches == before + 1
    assert kw.shape == (16, h) and kd.dtype == torch.bool
    assert torch.equal(kd.cpu(), pd) and torch.equal(cd.cpu(), pd)
    assert torch.equal(kw.cpu(), cw.cpu()) and torch.equal(kt.cpu(),
                                                          ct.cpu())
    assert torch.equal(kw.cpu(), pw) and torch.equal(kt.cpu(), pt)
    if count < 3:
        assert bool(kd.all())
    assert torch.isfinite(kw).all()


def test_gather_hyp_kernel_rejects_bad_inputs(dev):
    params, perm, pq = (x.to(dev) for x in _gather_inputs(256, 200, 512, 0))
    with pytest.raises(TypeError):
        ransac.gather_hypotheses(params, perm, pq.double(), 512)
    with pytest.raises(TypeError):
        ransac.gather_hypotheses(params, perm.int(), pq, 512)
    with pytest.raises(TypeError):
        ransac.gather_hypotheses(params.long(), perm, pq, 512)
    with pytest.raises(ValueError):
        ransac.gather_hypotheses(params[:-1], perm, pq, 512)
    with pytest.raises(ValueError):
        ransac.gather_hypotheses(params, perm[:-1], pq, 512)


@pytest.mark.parametrize("confidence", [0.999, 0.3])
def test_gather_chunk_graph_equals_eager_on_card(dev, confidence):
    """RANSAC's chunked gather route (``sampling='gather'``) on the
    bucket-8,192 pair with its chunks replayed as one CUDA graph against
    the same chunks run eagerly: the same pose and fitness bit for bit,
    one graph for both calls of a shape, K11 counted once a chunk."""
    src, tgt, _, _ = make_pair(8192, voxel=0.005)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=0.005)
    from tpu3d_torch import registration as reg

    sd = reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(src, device=dev), cfg)
    td = reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(tgt, device=dev), cfg)
    sd, sf = reg.prepare_features(sd, cfg, "fused")
    td, tf = reg.prepare_features(td, cfg, "fused")
    chunks = []

    class Draws(type(ransac.torch_draws(0))):
        def triples(self, c, h, count):
            chunks.append(c)
            return super().triples(c, h, count)

    def run(graph):
        chunks.clear()
        ransac.CHUNK_GRAPH = graph
        try:
            before = ransac.gather_hypotheses.launches
            res = ransac.ransac_registration(
                sd, td, sf, tf, 0.005, confidence=confidence,
                sampling="gather", draws=Draws(42))
            torch.cuda.synchronize()
            k11 = ransac.gather_hypotheses.launches - before
        finally:
            ransac.CHUNK_GRAPH = True
        return res, len(chunks), k11

    eager, n_e, k_e = run(False)
    graph, n_g, k_g = run(True)
    assert n_e == n_g >= 1 and k_e == n_e
    assert k_g in (n_g, n_g + 1)  # the first call's warm-up chunk
    assert torch.equal(eager.transformation, graph.transformation)
    assert float(eager.fitness) == float(graph.fitness)
    cached = len(ransac._graphs)
    again, n_a, k_a = run(True)
    assert torch.equal(again.transformation, graph.transformation)
    assert len(ransac._graphs) == cached and k_a == n_a


def test_sharded_ransac_launches_k11_on_card(dev):
    """The sharded RANSAC's gather branch solves each shard's slice of a
    round by K11."""
    from tpu3d_torch.parallel import make_mesh
    from tpu3d_torch.parallel.ransac_sharded import (
        ransac_registration_sharded,
    )

    src, tgt, R, t = make_pair(4096, voxel=0.005)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=0.005)
    from tpu3d_torch import registration as reg

    sd, sf = reg.prepare_features(reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(src, device=dev), cfg), cfg,
        "fused")
    td, tf = reg.prepare_features(reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(tgt, device=dev), cfg), cfg,
        "fused")
    before = ransac.gather_hypotheses.launches
    res = ransac_registration_sharded(sd, td, sf, tf, 0.005,
                                      make_mesh(devices=[dev] * 2),
                                      max_iterations=30000,
                                      sampling="gather")
    torch.cuda.synchronize()
    assert ransac.gather_hypotheses.launches >= before + 2
    T = res.transformation.cpu().numpy()
    assert np.abs(T[:3, :3] - R).max() < 0.02


def _select_both(d2, k):
    """K12 and its plain version on the same card tensor; K12 counted once."""
    before = neighbors.knn_select.launches
    kv, ki = neighbors.knn_select(d2, k)
    pv, pi = neighbors.knn_select_plain(d2, k)
    torch.cuda.synchronize()
    assert neighbors.knn_select.launches == before + 1
    assert ki.dtype == pi.dtype == torch.int32 and kv.shape == (d2.shape[0], k)
    return kv, ki, pv, pi


def _assert_same_bits(kv, ki, pv, pi):
    assert torch.equal(ki, pi)
    assert torch.equal(kv.view(torch.int32), pv.view(torch.int32))


def _knn_rows(dev, pts, mask, rows=1024):
    """One chunk of ``knn``'s d2 as it builds it: the matmul expansion plus
    the sentinel of the invalid targets."""
    t = pts.to(dev)
    invalid = torch.where(mask.to(dev), 0.0, 1e30).to(torch.float32)
    return neighbors.pairwise_sqdist(t[:rows], t) + invalid[None, :]


@pytest.mark.parametrize("k", [100, 30])
@pytest.mark.parametrize("valid", [5700, 5190])
def test_knn_select_kernel_at_the_gather_shapes(dev, k, valid):
    """K12 against the stable sort and slice, bit for bit, on knn's
    1,024 x 8,192 chunks at bucket 8,192 (pair_8k's ~5,700 valid rows and
    the fixture pair's 5,190), the first chunk and the one that holds the
    last valid rows and the padding."""
    g = torch.Generator().manual_seed(valid + k)
    pts = torch.zeros(8192, 3)
    pts[:valid] = torch.rand(valid, 3, generator=g) * torch.tensor(
        [0.18, 0.18, 0.01])
    mask = torch.arange(8192) < valid
    t = pts.to(dev)
    invalid = torch.where(mask.to(dev), 0.0, 1e30).to(torch.float32)
    for start in (0, (valid // 1024) * 1024):
        d2 = neighbors.pairwise_sqdist(t[start:start + 1024], t) + invalid
        _assert_same_bits(*_select_both(d2, k))


@pytest.mark.parametrize("m,valid,k", [(256, 40, 100), (256, 256, 128),
                                       (1003, 900, 30), (300, 20, 1),
                                       (16384, 11000, 100)])
def test_knn_select_kernel_ties_sentinels_and_rows(dev, m, valid, k):
    """Duplicated lattice points (equal distances, +0.0 included), fewer
    valid targets than k (the sentinels in column order), a row not a
    multiple of four (unaligned staging), k = 1 and 128, and a row too long
    to stage in shared memory: K12 equals the stable sort and slice."""
    rng = np.random.default_rng(m + valid + k)
    pts = rng.integers(0, 4, (m, 3)).astype(np.float32) * 0.25
    pts[m // 2:] = pts[: m - m // 2]
    pts = torch.from_numpy(pts)
    mask = torch.from_numpy(rng.permutation(m) < valid)
    d2 = _knn_rows(dev, pts, mask, rows=min(m, 512))
    _assert_same_bits(*_select_both(d2, k))
    # Whole rows of one value: every key ties.
    flat = torch.full((4, m), 0.5, device=dev)
    _assert_same_bits(*_select_both(flat, k))


def test_knn_on_card_takes_k12_below_129(dev):
    """``knn`` on the card selects by K12 (one launch a chunk) for k <=
    128 and keeps the stable sort above, with the same neighbours as the
    sort on the same distances."""
    g = torch.Generator().manual_seed(7)
    pts = (torch.rand(3000, 3, generator=g) * 0.1).to(dev)
    mask = (torch.rand(3000, generator=g) > 0.2).to(dev)
    before = neighbors.knn_select.launches
    idx, d2 = neighbors.knn(pts, pts, mask, k=100)
    torch.cuda.synchronize()
    assert neighbors.knn_select.launches == before + 3
    idx2, d22 = neighbors.knn(pts, pts, mask, k=129)
    torch.cuda.synchronize()
    assert neighbors.knn_select.launches == before + 3
    assert torch.equal(idx2[:, :100], idx) and torch.equal(d22[:, :100], d2)


def _gather_clouds(dev, voxel=0.005):
    from tpu3d_torch import registration as reg

    src, tgt, _, _ = make_pair(8192, voxel=voxel)
    cfg = tpu3d_torch.RegistrationConfig(voxel_size=voxel)
    downs = [reg.downsample_bucketed(
        tpu3d_torch.PointCloud.from_numpy(c, device=dev), cfg)
        for c in (src, tgt)]
    assert downs[0].capacity == downs[1].capacity == 8192
    return downs, cfg


def test_gather_graph_equals_eager_on_card(dev, monkeypatch):
    """The brute gather arm replayed as one CUDA graph, source then target
    back to back at one key, against the same arm run eagerly: (idx, d2),
    normals and descriptors bit for bit; one capture, K12 counted 8 times
    a replay; a second replay of the same key captures nothing."""
    from tpu3d_torch import registration as reg

    monkeypatch.setattr(gather_graph, "_graphs", {})
    (sd, td), cfg = _gather_clouds(dev)
    radius = float(np.float32(cfg.voxel_size * 5.0))
    eager = []
    for c in (sd, td):
        (idx, d2), cloud, feat = reg.gather_arm(c, radius)
        eager.append((idx, d2, cloud.normals, feat.descriptors))
    before = neighbors.knn_select.launches
    replayed = []
    for c in (sd, td):
        cloud, feat = reg.prepare_features(c, cfg)
        g = next(iter(gather_graph._graphs.values()))
        replayed.append((g.outputs[0].clone(), g.outputs[1].clone(),
                         cloud.normals, feat.descriptors))
    torch.cuda.synchronize()
    assert len(gather_graph._graphs) == 1 and g.graph is not None
    # The capture's eager warm-up and two replays of 8 chunks each.
    assert neighbors.knn_select.launches == before + 3 * 8
    for e, r in zip(eager, replayed):
        for a, b in zip(e, r):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    graph = g.graph
    again = reg.prepare_features(sd, cfg)
    torch.cuda.synchronize()
    assert g.graph is graph and len(gather_graph._graphs) == 1
    assert torch.equal(again[1].descriptors, replayed[0][3])


def test_gather_graph_second_radius_captures_again(dev, monkeypatch):
    """Another FPFH radius is another key: a second graph, each equal to
    its eager arm."""
    from tpu3d_torch import registration as reg

    monkeypatch.setattr(gather_graph, "_graphs", {})
    (sd, _), cfg = _gather_clouds(dev)
    cfg2 = tpu3d_torch.RegistrationConfig(voxel_size=0.004)
    for c in (cfg, cfg2):
        cloud, feat = reg.prepare_features(sd, c)
        _, eager, eager_feat = reg.gather_arm(
            sd, float(np.float32(c.voxel_size * 5.0)))
        assert torch.equal(cloud.normals, eager.normals)
        assert torch.equal(feat.descriptors, eager_feat.descriptors)
    assert len(gather_graph._graphs) == 2
