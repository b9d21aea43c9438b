"""The port's CUDA kernels (K2-K9 and the probe's) against their plain
PyTorch versions, and the pipeline's routes, on the card. Every test here
needs a CUDA device and skips without one.

This file imports neither jax nor tpu3d, so it runs where they are not
installed: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import tpu3d_torch
from tpu3d_torch.models.fixtures import make_pair
from tpu3d_torch.ops import (
    depth,
    features,
    fused_features,
    icp,
    icp_stats,
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


@pytest.mark.parametrize("sigma_s,radius", [(2.0, 4), (3.0, 5)])
def test_bilateral_kernel_matches_plain(dev, sigma_s, radius):
    """K9 on a frame with holes and a zero border strip, odd sizes so the
    32 x 8 blocks meet the frame's edge part way."""
    g = torch.Generator().manual_seed(radius)
    d = 0.5 + torch.rand(203, 301, generator=g)
    d[torch.rand(203, 301, generator=g) < 0.2] = 0.0
    d[:, :3] = 0.0
    d[40:60, 50:90] += 0.3  # a step well above sigma_range
    assert depth.bf_radius(sigma_s) == radius
    pd = depth.bilateral_filter(d, sigma_s, 0.05)
    before = depth.bilateral_filter.launches
    kd = depth.bilateral_filter(d.to(dev), sigma_s, 0.05)
    torch.cuda.synchronize()
    assert depth.bilateral_filter.launches == before + 1
    assert kd.is_cuda and kd.shape == d.shape
    assert torch.equal(kd.cpu() == 0, pd == 0)
    assert float((kd.cpu() - pd).abs().max()) <= 1e-6


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
    refined, coarse = tpu3d_torch.register_pair(
        tpu3d_torch.PointCloud.from_numpy(src, device=dev),
        tpu3d_torch.PointCloud.from_numpy(tgt, device=dev), cfg)
    T = refined.transformation.cpu().numpy()
    assert float(coarse.fitness) > 0.3
    assert np.abs(T[:3, :3] - R).max() < 0.02
    assert np.abs(T[:3, 3] - t).max() < 0.005
    assert ransac_score.score_hypotheses.launches > before


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


@pytest.mark.parametrize("block", [128, 256, 512])
@pytest.mark.parametrize("k_windows", [3, 8, 10])
def test_nn_walk_kernel_matches_plain(dev, block, k_windows):
    """K8 equals its plain version bit for bit: d2, and the index on every
    row, rows without a match included."""
    args = _walk_inputs(block, k_windows, block + k_windows)
    pd, pi = nn_walk.top1_walk(*args, block)
    before = nn_walk.top1_walk.launches
    kd, ki = nn_walk.top1_walk(*(a.to(dev) for a in args[:4]), args[4],
                               block, sub=block)
    torch.cuda.synchronize()
    assert nn_walk.top1_walk.launches == before + 1
    assert ki.dtype == torch.int32 and kd.dtype == torch.float32
    matched = pd < 1e29
    assert 0 < int(matched.sum()) < matched.numel()
    assert torch.equal(ki.cpu(), pi)
    assert torch.equal(kd.cpu(), pd)


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
