"""The reference (portbench/reference) against direct NumPy loops at tiny
sizes: deprojection, voxel centroids, normals, FPFH on both routes,
descriptor nearest neighbours, the TF32 and bfloat16 rounding of the
control."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import geometry as geo

F64 = geo.Precision("float64")


def cloud(n=300, seed=0, ext=0.03):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-ext, ext, (n, 2))
    z = 0.6 + 0.004 * np.sin(xy[:, 0] * 150) * np.cos(xy[:, 1] * 110)
    return np.column_stack([xy, z]).astype(np.float32)


def np_voxel(p, voxel):
    inv = np.float32(1.0) / np.float32(voxel)
    keys = np.floor(p * inv).astype(np.int64)
    groups = {}
    for k, q in zip(map(tuple, keys), p.astype(np.float64)):
        groups.setdefault(k, []).append(q)
    return np.array([np.mean(groups[k], 0) for k in sorted(groups)])


def np_normal(nb, p):
    c = nb - nb.mean(0)
    w, v = np.linalg.eigh(c.T @ c / len(nb))
    n = v[:, 0]
    return -n if n @ p > 0 else n


def np_spfh(i, nbrs, pts, nrm):
    h = np.zeros(33)
    for j in nbrs:
        d = pts[j] - pts[i]
        dist = np.linalg.norm(d)
        dh = d / dist
        u = nrm[i]
        v = np.cross(u, dh)
        w = np.cross(u, v)
        a = v @ nrm[j]
        ph = u @ dh
        th = math.atan2(w @ nrm[j], u @ nrm[j]) / math.pi
        for off, x in ((0, a), (11, ph), (22, th)):
            h[off + min(max(int(math.floor((x + 1) * 5.5)), 0), 10)] += 1
    return h / h.sum() if h.sum() > 0 else h


def np_fpfh(pts, nrm, nbr_sets):
    spfh = np.array([np_spfh(i, nb, pts, nrm) for i, nb in enumerate(nbr_sets)])
    out = []
    for i, nb in enumerate(nbr_sets):
        f = spfh[i] + sum(spfh[j] / np.linalg.norm(pts[j] - pts[i])
                          for j in nb)
        out.append(f / f.sum() if f.sum() > 0 else f)
    return np.array(out)


def test_voxel_downsample_matches_numpy():
    p = cloud(500)
    mask = np.ones(len(p), bool)
    mask[::7] = False
    got = geo.voxel_downsample(torch.from_numpy(p), torch.from_numpy(mask),
                               0.004, F64).numpy()
    want = np_voxel(p[mask], 0.004)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_radius_features_match_numpy():
    p = cloud(250).astype(np.float64)
    r = 0.012
    nrm, fpfh = geo.radius_features(torch.from_numpy(p), r, F64)
    r2 = geo.f32(np.float32(r) * np.float32(r))
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    want_n = np.array([np_normal(p[d2[i] <= r2], p[i])
                       for i in range(len(p))])
    np.testing.assert_allclose(nrm.numpy(), want_n, atol=1e-9)
    sets = [np.nonzero((d2[i] <= r2) & (d2[i] >= 1e-16))[0]
            for i in range(len(p))]
    want_f = np_fpfh(p, want_n, sets)
    np.testing.assert_allclose(fpfh.numpy(), want_f, atol=1e-9)


def test_knn_features_match_numpy():
    p = cloud(200, seed=1).astype(np.float64)
    r = 0.006
    nrm, fpfh = geo.knn_features(torch.from_numpy(p), r, F64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")
    want_n = np.array([np_normal(p[order[i, :30]], p[i])
                       for i in range(len(p))])
    np.testing.assert_allclose(nrm.numpy(), want_n, atol=1e-9)
    r2 = geo.f32(np.float32(r) * np.float32(r))
    sets = [[j for j in order[i, :100] if d2[i, j] <= r2
             and math.sqrt(d2[i, j]) >= 1e-8] for i in range(len(p))]
    want_f = np_fpfh(p, want_n, sets)
    np.testing.assert_allclose(fpfh.numpy(), want_f, atol=1e-9)


def test_descriptor_nn_and_gap():
    rng = np.random.default_rng(3)
    src, tgt = rng.random((40, 33)), rng.random((90, 33))
    d2 = ((src[:, None] - tgt[None]) ** 2).sum(-1)
    want = d2.argmin(1)
    got = geo.descriptor_nn(torch.from_numpy(src), torch.from_numpy(tgt), F64)
    np.testing.assert_array_equal(got.numpy(), want)
    second = np.argsort(d2, 1)[:, 1]
    gap = geo.descriptor_gap(torch.from_numpy(src), torch.from_numpy(tgt),
                             torch.from_numpy(second)).numpy()
    best = d2.min(1)
    want = (d2[np.arange(40), second] - best) / (src ** 2).sum(1)
    np.testing.assert_allclose(gap, want, rtol=1e-9)


@pytest.mark.parametrize("x", [1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                               0.6 + 1e-4, -3.3e-5])
def test_tf32_round_keeps_ten_mantissa_bits(x):
    x32 = float(np.float32(x))
    y = float(geo.tf32_round(torch.tensor([x32], dtype=torch.float32)))
    m, e = math.frexp(abs(x32))  # 0.5 <= m < 1: 11 significant bits kept
    want = math.copysign(round(m * 2048) / 2048 * 2.0 ** e, x32)
    assert y == want


def test_icp_recovers_a_small_motion():
    p = torch.from_numpy(cloud(800, seed=4, ext=0.05).astype(np.float64))
    mask = torch.ones(len(p), dtype=torch.bool)
    nrm, _ = geo.radius_features(p, 0.01, F64)
    T0 = torch.eye(4, dtype=torch.float64)
    T0[:3, 3] = torch.tensor([0.0004, -0.0003, 0.0002])
    T, fitness, rmse = geo.icp(p, mask, p, mask, nrm, T0, 0.002, 50, F64)
    rad, m = geo.pose_gap(T, torch.eye(4))
    assert m < 1e-6 and rad < 1e-5 and fitness == 1.0


def test_deprojection_matches_numpy_and_its_control_is_bfloat16():
    from portbench.reference.frames import deproject_instance

    rng = np.random.default_rng(3)
    depth = rng.integers(550, 650, (12, 16)).astype(np.uint16)
    depth[0, :4] = 0
    mask = np.zeros((12, 16), np.uint8)
    mask[2:10, 3:14] = 255
    K = np.array([[900.0, 0, 8], [0, 900.0, 6], [0, 0, 1]], np.float32)
    frame = {"depth": depth, "masks": [mask], "K": K, "scale": 1000.0,
             "clip": 1.5, "bilateral": False, "device": "cpu"}
    pts, valid = deproject_instance(frame, 0, F64)
    z = np.where(mask > 10, depth / 1000.0, 0.0)
    u, v = np.meshgrid(np.arange(16.0), np.arange(12.0))
    want = np.stack([(u - 8) * z / 900.0, (v - 6) * z / 900.0, z], -1)
    assert np.array_equal(valid.numpy(), (z > 0).reshape(-1))
    np.testing.assert_allclose(pts.numpy(), want.reshape(-1, 3), atol=1e-15)
    got, _ = deproject_instance(frame, 0, geo.Precision("tf32"))
    gap = (got.double() - pts)[valid].abs().max()
    assert 1e-4 < gap < 5e-3  # bfloat16's 8 bits at 0.6 m
