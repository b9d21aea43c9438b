"""Normal estimation: k-NN covariance + closed-form smallest eigenvector.

Counterpart of ``tpu3d/ops/normals.py`` (``smallest_eigvec_3x3``,
``smallest_eigvec_3x3_planes``, ``estimate_normals``): k=30 neighbours
(self included), covariance of the neighbourhood, smallest-eigenvalue
eigenvector by Cardano + spectral projector, flipped toward the origin. Without precomputed neighbours it
runs its own exact self-kNN, as the JAX one does.
"""

from __future__ import annotations

import math

import torch

from tpu3d_torch.ops.neighbors import check_method, knn
from tpu3d_torch.types import PointCloud


def smallest_eigvec_3x3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of batched symmetric
    (..., 3, 3) matrices; sign arbitrary, e_z for A ∝ I."""
    scale = torch.clamp_min(A.abs().amax(dim=(-2, -1), keepdim=True), 1e-30)
    A = A / scale

    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = (A - q[..., None, None] * eye) / p[..., None, None]
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] ** 2)
        - B[..., 0, 1]
        * (B[..., 0, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 0, 2])
        + B[..., 0, 2]
        * (B[..., 0, 1] * B[..., 1, 2] - B[..., 1, 1] * B[..., 0, 2])
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam3 = q + 2.0 * p * torch.cos(phi)  # largest
    lam1 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam2 = 3.0 * q - lam1 - lam3

    P = (A - lam2[..., None, None] * eye) @ (A - lam3[..., None, None] * eye)
    norms = (P * P).sum(-2)  # column norms (..., 3)
    best = torch.argmax(norms, dim=-1)
    v = torch.take_along_dim(
        P, best[..., None, None].expand(P.shape[:-1] + (1,)), dim=-1
    )[..., 0]
    vnorm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ez = torch.zeros_like(v)
    ez[..., 2] = 1.0
    return torch.where(vnorm > 1e-20, v / torch.clamp_min(vnorm, 1e-30), ez)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """√x rounded once, as the kernels' ``__fsqrt_rn``: CUDA's float32
    square root is; the CPU's is not always, so there it goes through
    float64 (53 ≥ 2·24 + 2 bits: rounding twice rounds as once)."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


def div_rn(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once: CUDA divides by a host scalar through its
    reciprocal, so there the divisor goes to the device."""
    if x.is_cuda:
        return x / torch.full((), c, dtype=x.dtype, device=x.device)
    return x / c


def _scaled(a00, a01, a02, a11, a12, a22):
    """The six components divided by their largest magnitude (≥ 1e-30)."""
    scale = a00.abs()
    for c in (a01, a02, a11, a12, a22):
        scale = torch.maximum(scale, c.abs())
    scale = torch.clamp_min(scale, 1e-30)
    return tuple(c / scale for c in (a00, a01, a02, a11, a12, a22))


def _projector_column(a00, a01, a02, a11, a12, a22, s, t, sqrt):
    """The unit column of largest norm (the first on ties) of the spectral
    projector A² − s·A + t·I, s = λ₂ + λ₃ and t = λ₂λ₃; e_z where the
    projector vanishes."""
    P00 = a00 * a00 + a01 * a01 + a02 * a02 - s * a00 + t
    P01 = a00 * a01 + a01 * a11 + a02 * a12 - s * a01
    P02 = a00 * a02 + a01 * a12 + a02 * a22 - s * a02
    P11 = a01 * a01 + a11 * a11 + a12 * a12 - s * a11 + t
    P12 = a01 * a02 + a11 * a12 + a12 * a22 - s * a12
    P22 = a02 * a02 + a12 * a12 + a22 * a22 - s * a22 + t

    n0 = P00 * P00 + P01 * P01 + P02 * P02
    n1 = P01 * P01 + P11 * P11 + P12 * P12
    n2 = P02 * P02 + P12 * P12 + P22 * P22
    m0 = (n0 >= n1) & (n0 >= n2)
    m1 = n1 >= n2
    vx = torch.where(m0, P00, torch.where(m1, P01, P02))
    vy = torch.where(m0, P01, torch.where(m1, P11, P12))
    vz = torch.where(m0, P02, torch.where(m1, P12, P22))
    vn = sqrt(vx * vx + vy * vy + vz * vz)
    ok = vn > 1e-20
    inv = 1.0 / torch.clamp_min(vn, 1e-30)
    return (torch.where(ok, vx * inv, 0.0), torch.where(ok, vy * inv, 0.0),
            torch.where(ok, vz * inv, 1.0))


def smallest_eigvec_3x3_planes(a00, a01, a02, a11, a12, a22):
    """Smallest eigenvector of symmetric 3×3 matrices given as six equally
    shaped component tensors; returns (vx, vy, vz). Cardano's
    trigonometric roots (arccos, cos), then the spectral projector
    (A − λ₂)(A − λ₃), op for op the JAX package's
    ``smallest_eigvec_3x3_planes``. The kernels' epilogue takes the
    trig-free Newton form below instead."""
    a00, a01, a02, a11, a12, a22 = _scaled(a00, a01, a02, a11, a12, a22)
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))
    inv_p = 1.0 / p
    b00, b11, b22 = (a00 - q) * inv_p, (a11 - q) * inv_p, (a22 - q) * inv_p
    b01, b02, b12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam3 = q + 2.0 * p * torch.cos(phi)  # largest
    lam1 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    lam2 = 3.0 * q - lam1 - lam3
    return _projector_column(a00, a01, a02, a11, a12, a22, lam2 + lam3,
                             lam2 * lam3, torch.sqrt)


def smallest_eigvec_3x3_planes_newton(a00, a01, a02, a11, a12, a22,
                                      iters: int = 12):
    """Trig-free smallest eigenvector of symmetric 3×3 matrices given as six
    equally shaped component tensors; returns (vx, vy, vz).

    Newton on the characteristic cubic β³ − 3β − det B = 0 of the scaled
    deviatoric B = (A − qI)/p, from β = −2, clipped to [−2, −1], ``iters``
    steps; then the spectral projector with λ₂+λ₃ and λ₂λ₃ from the traces,
    and its column of largest norm (e_z when it vanishes). Sweep A's CUDA
    epilogue (``csrc/features.cu``) repeats these operations in this
    order, one rounding each (``sqrt_rn``, ``div_rn``)."""
    a00, a01, a02, a11, a12, a22 = _scaled(a00, a01, a02, a11, a12, a22)
    q = div_rn(a00 + a11 + a22, 3.0)
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    d00, d11, d22 = a00 - q, a11 - q, a22 - q
    p2 = d00 * d00 + d11 * d11 + d22 * d22 + 2.0 * p1
    p = sqrt_rn(torch.clamp_min(div_rn(p2, 6.0), 1e-30))
    inv_p = 1.0 / p
    b00, b11, b22 = d00 * inv_p, d11 * inv_p, d22 * inv_p
    b01, b02, b12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    d = torch.clamp(detB, -2.0, 2.0)
    beta = torch.full_like(d, -2.0)
    for _ in range(iters):
        h = (beta * beta - 3.0) * beta - d
        hp = 3.0 * beta * beta - 3.0
        beta = torch.clamp(beta - h / torch.clamp_min(hp, 1e-12), -2.0, -1.0)
    lam1 = q + p * beta

    s = 3.0 * q - lam1
    tra2 = (
        a00 * a00 + a11 * a11 + a22 * a22
        + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    )
    e2 = div_rn(9.0 * q * q - tra2, 2.0)
    t = e2 - lam1 * s
    return _projector_column(a00, a01, a02, a11, a12, a22, s, t, sqrt_rn)


def estimate_normals(
    cloud: PointCloud,
    k: int = 30,
    chunk: int = 1024,
    method: str = "auto",
    neighbors: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> PointCloud:
    """Normals from the k nearest neighbours. ``neighbors``: a precomputed
    ascending self-kNN ``(idx, d2)`` with at least ``k`` columns (the
    first k are used), so that one search serves normals and FPFH; None
    searches with :func:`knn` (``chunk``, ``method``)."""
    check_method(method)
    pts = cloud.points
    if neighbors is None:
        neighbors = knn(pts, pts, cloud.mask, k=k, chunk=chunk, method=method)
    idx, d2 = neighbors[0][:, :k].long(), neighbors[1][:, :k]
    w = (d2 < 1e29).to(torch.float32)  # (N, k)

    nb = pts[idx]  # (N, k, 3)
    wsum = torch.clamp_min(w.sum(1, keepdim=True), 1.0)
    centroid = (nb * w[..., None]).sum(1) / wsum
    diff = (nb - centroid[:, None, :]) * w[..., None]
    diff_u = nb - centroid[:, None, :]
    cov = torch.einsum("nki,nkj->nij", diff, diff_u) / wsum[..., None]

    normals = smallest_eigvec_3x3(cov)
    flip = (normals * (-pts)).sum(-1) < 0
    normals = torch.where(flip[:, None], -normals, normals)
    normals = torch.where(cloud.mask[:, None], normals, 0.0)
    return cloud._replace(normals=normals)
