"""Voxel-grid downsampling as sort + segment sum.

Counterpart of ``tpu3d/ops/voxel.py`` (``voxel_downsample``, ``compact``).
The JAX ``lexsort`` becomes three stable sorts (last key first), and
``segment_sum`` becomes ``index_add_``. Output order is ascending voxel
key; valid centroids occupy a prefix of the same capacity.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3d_torch.types import PointCloud

_PAD_COORD = 2**30


def _lexsort_rows(coords: torch.Tensor) -> torch.Tensor:
    """Permutation sorting (N, 3) int rows by (c0, c1, c2), ties kept in
    input order — ``jnp.lexsort((c2, c1, c0))``."""
    order = torch.arange(coords.shape[0], device=coords.device)
    for col in (2, 1, 0):
        _, o = torch.sort(coords[order, col], stable=True)
        order = order[o]
    return order


def voxel_downsample(cloud: PointCloud, voxel_size: float) -> PointCloud:
    """Average points (and colors) per voxel; drops normals."""
    n = cloud.capacity
    inv = float(np.float32(1.0) / np.float32(voxel_size))  # fp32 reciprocal
    coords = torch.floor(cloud.points * inv).to(torch.int32)
    coords = torch.where(cloud.mask[:, None], coords, _PAD_COORD)

    order = _lexsort_rows(coords)
    c_sorted = coords[order]
    p_sorted = cloud.points[order]
    m_sorted = cloud.mask[order]

    prev = torch.roll(c_sorted, 1, dims=0)
    new_seg = torch.any(c_sorted != prev, dim=1)
    new_seg[0] = True
    seg_id = torch.cumsum(new_seg.to(torch.int32), 0) - 1

    w = m_sorted.to(torch.float32)
    zeros = torch.zeros((n,), dtype=torch.float32, device=cloud.device)
    counts = zeros.index_add(0, seg_id, w)
    sums = torch.zeros((n, 3), dtype=torch.float32, device=cloud.device)
    sums = sums.index_add(0, seg_id, p_sorted * w[:, None])
    denom = torch.clamp_min(counts, 1.0)[:, None]

    out_colors = None
    if cloud.colors is not None:
        c = torch.zeros_like(sums).index_add(
            0, seg_id, cloud.colors[order] * w[:, None]
        )
        out_colors = c / denom
    return PointCloud(points=sums / denom, mask=counts > 0, colors=out_colors)


def compact(cloud: PointCloud, capacity: int) -> PointCloud:
    """Re-pack valid rows (stable) into the first ``capacity`` rows."""
    _, order = torch.sort((~cloud.mask).to(torch.int8), stable=True)
    sel = order[:capacity]

    def take(a):
        return None if a is None else a[sel]

    return PointCloud(
        points=cloud.points[sel],
        mask=cloud.mask[sel],
        normals=take(cloud.normals),
        colors=take(cloud.colors),
    )
