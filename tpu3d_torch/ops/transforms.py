"""SE(3) helpers and the plane-wise 3-point QCP solve.

Counterpart of ``tpu3d/ops/transforms.py`` (``make_transform``,
``transform_points``, ``invert_transform``, ``euler_xyz_to_matrix``,
``matrix_to_rpy_zyx``, ``kabsch_quat``, ``_qcp_quat_planes``,
``kabsch3_planes``, ``kabsch_from_cross_cov``). Plane functions take
tuples of equally shaped tensors (one per coordinate or matrix entry) and
do elementwise math only, in the same operation order as the JAX package
so results agree to rounding.
"""

from __future__ import annotations

import numpy as np
import torch


def kabsch_from_cross_cov(sw, sp, sq, H) -> tuple[np.ndarray, np.ndarray]:
    """Kabsch (R, t) from sufficient statistics, on the host in numpy fp32
    (the ICP loop solves there after its one readback): sw = Σw, sp/sq the
    weighted coordinate sums, H (3, 3) the centred weighted
    cross-covariance Σ w (p − p̄)(q − q̄)ᵀ. SVD with the reflection fix, as
    the JAX package's ``kabsch_from_cross_cov``. A non-finite H gives a
    non-finite pose, which the loop's finite guard catches."""
    sws = np.maximum(np.float32(sw), np.float32(1e-12))
    src_mean = np.asarray(sp, np.float32) / sws
    tgt_mean = np.asarray(sq, np.float32) / sws
    H = np.asarray(H, np.float32)
    if not np.isfinite(H).all():
        nan = np.float32(np.nan)
        return np.full((3, 3), nan, np.float32), np.full(3, nan, np.float32)
    U, _, Vt = np.linalg.svd(H)
    V = Vt.T
    R = V @ U.T
    if np.linalg.det(R) < 0:
        V = V * np.array([1.0, 1.0, -1.0], np.float32)
        R = V @ U.T
    t = tgt_mean - R @ src_mean
    return R.astype(np.float32), t.astype(np.float32)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 homogeneous transforms from (..., 3, 3) and (..., 3)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transform(s) to (..., N, 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return points @ R.transpose(-1, -2) + t[..., None, :]


def invert_transform(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse [Rᵀ, −Rᵀt] of (..., 4, 4) transforms."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_transform(Rt, -(Rt @ t[..., None])[..., 0])


def euler_xyz_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """R = Rx(a) @ Ry(b) @ Rz(g) for angles (..., 3) — the point-to-plane
    delta-rotation convention, exact trig."""
    a, b, g = angles[..., 0], angles[..., 1], angles[..., 2]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cg, sg = torch.cos(g), torch.sin(g)
    row0 = torch.stack([cb * cg, -cb * sg, sb], dim=-1)
    row1 = torch.stack(
        [ca * sg + sa * sb * cg, ca * cg - sa * sb * sg, -sa * cb], dim=-1
    )
    row2 = torch.stack(
        [sa * sg - ca * sb * cg, sa * cg + ca * sb * sg, ca * cb], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_rpy_zyx(R: torch.Tensor) -> torch.Tensor:
    """(roll, pitch, yaw) in radians, ZYX convention, with the gimbal-lock
    branch where |R[2, 0]| ≥ 0.999."""
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    regular = R[..., 2, 0].abs() < 0.999
    roll = torch.where(
        regular,
        torch.atan2(R[..., 2, 1], R[..., 2, 2]),
        torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
    )
    yaw = torch.where(regular, torch.atan2(R[..., 1, 0], R[..., 0, 0]),
                      torch.zeros_like(pitch))
    return torch.stack([roll, pitch, yaw], dim=-1)


def _qcp_quat_planes(
    sxx, sxy, sxz, syx, syy, syz, szx, szy, szz, e0, newton_iters=12
):
    """Largest-eigenvalue unit quaternion of the Horn matrix built from
    correlation planes: Newton on the characteristic quartic from
    λ₀ = E0, adjugate-column eigenvector with two Rayleigh polishes, then
    an exact renormalisation with an identity fallback for degenerate or
    non-finite solutions (a non-unit quaternion would give a scaled
    rotation and break the rank-16 scoring expansion)."""
    n00 = sxx + syy + szz
    n01 = syz - szy
    n02 = szx - sxz
    n03 = sxy - syx
    n11 = sxx - syy - szz
    n12 = sxy + syx
    n13 = szx + sxz
    n22 = -sxx + syy - szz
    n23 = syz + szy
    n33 = -sxx - syy + szz

    m00 = n00 * n00 + n01 * n01 + n02 * n02 + n03 * n03
    m01 = n00 * n01 + n01 * n11 + n02 * n12 + n03 * n13
    m02 = n00 * n02 + n01 * n12 + n02 * n22 + n03 * n23
    m03 = n00 * n03 + n01 * n13 + n02 * n23 + n03 * n33
    m11 = n01 * n01 + n11 * n11 + n12 * n12 + n13 * n13
    m12 = n01 * n02 + n11 * n12 + n12 * n22 + n13 * n23
    m13 = n01 * n03 + n11 * n13 + n12 * n23 + n13 * n33
    m22 = n02 * n02 + n12 * n12 + n22 * n22 + n23 * n23
    m23 = n02 * n03 + n12 * n13 + n22 * n23 + n23 * n33
    m33 = n03 * n03 + n13 * n13 + n23 * n23 + n33 * n33

    tr2 = m00 + m11 + m22 + m33
    tr3 = (
        n00 * m00 + n11 * m11 + n22 * m22 + n33 * m33
        + 2.0 * (n01 * m01 + n02 * m02 + n03 * m03
                 + n12 * m12 + n13 * m13 + n23 * m23)
    )
    tr4 = (
        m00 * m00 + m11 * m11 + m22 * m22 + m33 * m33
        + 2.0 * (m01 * m01 + m02 * m02 + m03 * m03
                 + m12 * m12 + m13 * m13 + m23 * m23)
    )
    c2 = -0.5 * tr2
    c1 = -tr3 / 3.0
    c0 = -0.25 * (tr4 + c2 * tr2)

    lam = e0  # λ_max ≤ E0: Newton from above converges monotonically
    for _ in range(newton_iters):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        lam = lam - p / torch.where(dp.abs() > 1e-20, dp, 1e-20)

    def _adj_best_col(lam_):
        a00, a11 = n00 - lam_, n11 - lam_
        a22, a33 = n22 - lam_, n33 - lam_
        A = [
            [a00, n01, n02, n03],
            [n01, a11, n12, n13],
            [n02, n12, a22, n23],
            [n03, n13, n23, a33],
        ]

        def det3(r, c):
            (i0, i1, i2), (j0, j1, j2) = r, c
            return (
                A[i0][j0] * (A[i1][j1] * A[i2][j2] - A[i1][j2] * A[i2][j1])
                - A[i0][j1] * (A[i1][j0] * A[i2][j2] - A[i1][j2] * A[i2][j0])
                + A[i0][j2] * (A[i1][j0] * A[i2][j1] - A[i1][j1] * A[i2][j0])
            )

        idx = [0, 1, 2, 3]
        cand = []
        for k in range(4):
            rows = tuple(i for i in idx if i != k)
            col = []
            for i in range(4):
                cs = tuple(j for j in idx if j != i)
                col.append(((-1.0) ** (i + k)) * det3(rows, cs))
            cand.append(col)
        norms = [sum(c[i] * c[i] for i in range(4)) for c in cand]
        best_col = cand[0]
        best_norm = norms[0]
        for k in range(1, 4):
            take = norms[k] > best_norm
            best_col = [
                torch.where(take, cand[k][i], best_col[i]) for i in range(4)
            ]
            best_norm = torch.where(take, norms[k], best_norm)
        inv = torch.rsqrt(torch.clamp_min(best_norm, 1e-60))
        return [c * inv for c in best_col]

    v = _adj_best_col(lam)

    def _rayleigh(v_):
        v0, v1, v2, v3 = v_
        nv0 = n00 * v0 + n01 * v1 + n02 * v2 + n03 * v3
        nv1 = n01 * v0 + n11 * v1 + n12 * v2 + n13 * v3
        nv2 = n02 * v0 + n12 * v1 + n22 * v2 + n23 * v3
        nv3 = n03 * v0 + n13 * v1 + n23 * v2 + n33 * v3
        return v0 * nv0 + v1 * nv1 + v2 * nv2 + v3 * nv3

    for _ in range(2):
        lam = _rayleigh(v)
        v = _adj_best_col(lam)
    v0, v1, v2, v3 = v
    nrm = v0 * v0 + v1 * v1 + v2 * v2 + v3 * v3
    ok = torch.isfinite(nrm) & (nrm > 1e-12)
    inv = torch.rsqrt(torch.where(ok, nrm, 1.0))
    one = torch.ones_like(v0)
    zero = torch.zeros_like(v0)
    return (
        torch.where(ok, v0 * inv, one),
        torch.where(ok, v1 * inv, zero),
        torch.where(ok, v2 * inv, zero),
        torch.where(ok, v3 * inv, zero),
    )


def kabsch3_planes(ps, qs):
    """3-point Kabsch on planes: ``ps[k][c]`` is coordinate c of sample k
    for every hypothesis. Returns (9 rotation planes row-major, 3
    translation planes)."""
    third = 1.0 / 3.0
    pm = [(ps[0][c] + ps[1][c] + ps[2][c]) * third for c in range(3)]
    qm = [(qs[0][c] + qs[1][c] + qs[2][c]) * third for c in range(3)]
    pc = [[ps[k][c] - pm[c] for c in range(3)] for k in range(3)]
    qc = [[qs[k][c] - qm[c] for c in range(3)] for k in range(3)]

    def corr(i, j):
        return (
            pc[0][i] * qc[0][j] + pc[1][i] * qc[1][j] + pc[2][i] * qc[2][j]
        )

    sxx, sxy, sxz = corr(0, 0), corr(0, 1), corr(0, 2)
    syx, syy, syz = corr(1, 0), corr(1, 1), corr(1, 2)
    szx, szy, szz = corr(2, 0), corr(2, 1), corr(2, 2)
    e0 = 0.5 * sum(
        pc[k][c] * pc[k][c] + qc[k][c] * qc[k][c]
        for k in range(3)
        for c in range(3)
    )
    q0, qx, qy, qz = _qcp_quat_planes(
        sxx, sxy, sxz, syx, syy, syz, szx, szy, szz, e0
    )
    r = (
        q0 * q0 + qx * qx - qy * qy - qz * qz,
        2 * (qx * qy - q0 * qz),
        2 * (qx * qz + q0 * qy),
        2 * (qy * qx + q0 * qz),
        q0 * q0 - qx * qx + qy * qy - qz * qz,
        2 * (qy * qz - q0 * qx),
        2 * (qz * qx - q0 * qy),
        2 * (qz * qy + q0 * qx),
        q0 * q0 - qx * qx - qy * qy + qz * qz,
    )
    t = tuple(
        qm[i] - (r[3 * i] * pm[0] + r[3 * i + 1] * pm[1]
                 + r[3 * i + 2] * pm[2])
        for i in range(3)
    )
    return r, t


def _sum3(a: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of size 3, left to right."""
    return (a[..., 0] + a[..., 1]) + a[..., 2]


def kabsch_quat(
    src: torch.Tensor, tgt: torch.Tensor, newton_iters: int = 12
) -> tuple[torch.Tensor, torch.Tensor]:
    """Unweighted Horn/QCP absolute orientation of (..., 3, 3) point
    triples (the gather sampler's solve): (R (..., 3, 3), t (..., 3)).
    Same optimum as an SVD Kabsch with the reflection fix; degenerate
    samples give an arbitrary proper rotation."""
    # A device scalar: PyTorch's CUDA division by a Python number
    # multiplies by its reciprocal, a second rounding.
    three = src.new_tensor(3.0)
    src_mean = torch.stack([_sum3(src[..., c]) for c in range(3)], -1) / three
    tgt_mean = torch.stack([_sum3(tgt[..., c]) for c in range(3)], -1) / three
    src_c = src - src_mean[..., None, :]
    tgt_c = tgt - tgt_mean[..., None, :]

    def corr(i, j):
        return _sum3(src_c[..., i] * tgt_c[..., j])

    sxx, sxy, sxz = corr(0, 0), corr(0, 1), corr(0, 2)
    syx, syy, syz = corr(1, 0), corr(1, 1), corr(1, 2)
    szx, szy, szz = corr(2, 0), corr(2, 1), corr(2, 2)
    e0 = 0.5 * _sum3(_sum3(src_c * src_c) + _sum3(tgt_c * tgt_c))
    q0, qx, qy, qz = _qcp_quat_planes(
        sxx, sxy, sxz, syx, syy, syz, szx, szy, szz, e0, newton_iters
    )
    R = torch.stack([
        torch.stack([q0 * q0 + qx * qx - qy * qy - qz * qz,
                     2 * (qx * qy - q0 * qz), 2 * (qx * qz + q0 * qy)], -1),
        torch.stack([2 * (qy * qx + q0 * qz),
                     q0 * q0 - qx * qx + qy * qy - qz * qz,
                     2 * (qy * qz - q0 * qx)], -1),
        torch.stack([2 * (qz * qx - q0 * qy), 2 * (qz * qy + q0 * qx),
                     q0 * q0 - qx * qx - qy * qy + qz * qz], -1),
    ], -2)
    t = tgt_mean - _sum3(R * src_mean[..., None, :])
    return R, t
