"""Normal estimation: k-NN covariance + closed-form smallest eigenvector.

Counterpart of ``tpu3d/ops/normals.py`` (``smallest_eigvec_3x3``,
``estimate_normals``): k=30 neighbours (self included), covariance of the
neighbourhood, smallest-eigenvalue eigenvector by Cardano + spectral
projector, flipped toward the origin.
"""

from __future__ import annotations

import math

import torch

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


def estimate_normals(
    cloud: PointCloud,
    neighbors: tuple[torch.Tensor, torch.Tensor],
    k: int = 30,
) -> PointCloud:
    """Normals from a precomputed ascending self-kNN ``(idx, d2)`` with at
    least ``k`` columns (the first k are used)."""
    pts = cloud.points
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
