"""Voxel-grid downsampling as sort + segment sum.

Counterpart of ``tpu3d/ops/voxel.py`` (``voxel_downsample``, ``compact``).
The JAX ``lexsort`` becomes three stable sorts (last key first), and
``segment_sum`` a sum over each voxel's run of sorted rows
(``torch.segment_reduce``), which adds the rows in order on the CPU and
the card alike. (``index_add_`` adds by atomics on the card, in an order
that changes from run to run: so would the centroids' last bits, and
every registration from them.) Padding rows, which sort last, each
form a segment of their own (weight 0, so an invalid row): on the card a
segment is one thread's loop, and the padding of a masked frame runs to
hundreds of thousands of rows. Output order is ascending voxel key;
valid centroids occupy a prefix of the same capacity.
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
    new_seg = torch.any(c_sorted != prev, dim=1) | ~m_sorted
    new_seg[0] = True
    seg_id = torch.cumsum(new_seg.to(torch.int32), 0) - 1

    w = m_sorted.to(torch.float32)
    lengths = torch.bincount(seg_id, minlength=n)

    def segment_sum(x):
        return torch.segment_reduce(x, "sum", lengths=lengths, axis=0,
                                    unsafe=True)

    counts = segment_sum(w)
    sums = segment_sum(p_sorted * w[:, None])
    denom = torch.clamp_min(counts, 1.0)[:, None]

    out_colors = None
    if cloud.colors is not None:
        out_colors = segment_sum(cloud.colors[order] * w[:, None]) / denom
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
