"""FPFH (Fast Point Feature Histograms), 33-D, from a shared self-kNN.

Counterpart of ``tpu3d/ops/fpfh.py`` (``_bin_index``, ``compute_fpfh``):
the 100 closest neighbours within ``radius`` (self skipped by the
pair-distance gate), Darboux angles with a real ``atan2``, an L1-normalised
3×11-bin SPFH, then the 1/dist-weighted neighbour sum, L1-normalised.
Queries are processed in chunks to bound the (C, K, 33) gather. Without
precomputed neighbours it searches with ``radius_capped_neighbors``, as
the JAX one does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu3d_torch.ops.neighbors import check_method, radius_capped_neighbors
from tpu3d_torch.types import FPFHFeatures, PointCloud

_MAX_NN = 100


def _bin_index(x: torch.Tensor) -> torch.Tensor:
    """clamp(int((x + 1) * 5.5), 0, 10)."""
    return torch.clamp(torch.floor((x + 1.0) * 5.5), 0.0, 10.0).long()


def _normalize_l1(h: torch.Tensor) -> torch.Tensor:
    s = h.sum(-1, keepdim=True)
    return torch.where(s > 0, h / torch.clamp_min(s, 1e-30), h)


def compute_fpfh(
    cloud: PointCloud,
    radius: float,
    max_nn: int = _MAX_NN,
    chunk: int = 1024,
    method: str = "auto",
    neighbors: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> FPFHFeatures:
    """Descriptors over the ``max_nn`` closest neighbours within
    ``radius``. ``neighbors``: a precomputed ascending self-kNN ``(idx,
    d2)`` with ``max_nn`` columns, shared with the normals; None searches
    with :func:`radius_capped_neighbors` (``method``)."""
    check_method(method)
    if cloud.normals is None:
        raise ValueError("compute_fpfh requires normals (run estimate_normals)")
    pts, nrm, mask = cloud.points, cloud.normals, cloud.mask
    n = cloud.capacity
    if neighbors is None:
        idx, d2, in_radius = radius_capped_neighbors(
            pts, mask, radius, max_nn, method=method)
        idx = idx.long()
    else:
        idx = neighbors[0][:, :max_nn].long()
        d2 = neighbors[1][:, :max_nn]
        r2 = float(np.float32(radius) ** 2)  # fp32, as the JAX package rounds
        in_radius = (d2 <= r2) & (d2 < 1e29)
    dist = torch.sqrt(d2)
    contrib = in_radius & (dist >= 1e-8)  # also removes self at distance 0

    spfh = torch.empty((n, 33), dtype=torch.float32, device=pts.device)
    for s in range(0, n, chunk):
        ci, cd, cc = idx[s:s + chunk], dist[s:s + chunk], contrib[s:s + chunk]
        cp, cn = pts[s:s + chunk], nrm[s:s + chunk]
        nbp, nbn = pts[ci], nrm[ci]  # (C, K, 3)
        diff = nbp - cp[:, None, :]
        dhat = diff / torch.clamp_min(cd, 1e-12)[..., None]
        u = cn[:, None, :].expand_as(dhat)
        v = torch.linalg.cross(u, dhat, dim=-1)
        w = torch.linalg.cross(u, v, dim=-1)
        alpha = (v * nbn).sum(-1)
        phi = (u * dhat).sum(-1)
        theta = torch.atan2((w * nbn).sum(-1), (u * nbn).sum(-1))
        bins = torch.stack(
            [
                _bin_index(alpha),
                11 + _bin_index(phi),
                22 + _bin_index(theta / math.pi),
            ],
            dim=-1,
        )  # (C, K, 3)
        weight = cc.to(torch.float32)[..., None].expand(bins.shape)
        hist = torch.zeros((ci.shape[0], 33), dtype=torch.float32,
                           device=pts.device)
        hist.scatter_add_(1, bins.reshape(ci.shape[0], -1),
                          weight.reshape(ci.shape[0], -1))
        spfh[s:s + chunk] = _normalize_l1(hist)

    fpfh = torch.empty_like(spfh)
    for s in range(0, n, chunk):
        ci, cd, cc = idx[s:s + chunk], dist[s:s + chunk], contrib[s:s + chunk]
        wgt = torch.where(cc, 1.0 / torch.clamp_min(cd, 1e-12), 0.0)
        f = spfh[s:s + chunk] + torch.einsum("ck,cko->co", wgt, spfh[ci])
        fpfh[s:s + chunk] = _normalize_l1(f)

    fpfh = torch.where(mask[:, None], fpfh, 0.0)
    return FPFHFeatures(descriptors=fpfh, mask=mask)
