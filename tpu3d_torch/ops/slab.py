"""Slab index: targets sorted by x, searched one contiguous window per
query block.

Counterpart of ``tpu3d/ops/slab.py`` (``build_slab``, ``_block_slices``)
with ``tpu3d/ops/slab2.py`` ``sorted_positions``, whose exact
``searchsorted`` semantics ``torch.searchsorted`` provides (``right=False``
for side='left', ``right=True`` for side='right').
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_BIG_X = 3e4  # sort key of invalid rows: after every real x


class SlabIndex(NamedTuple):
    sorted_points_t: torch.Tensor  # f32[3, M] sorted by x (invalid last)
    sorted_orig: torch.Tensor  # i64[M] original row of each sorted row
    sorted_x: torch.Tensor  # f32[M] ascending (invalid = 3e4)
    valid_sorted: torch.Tensor  # bool[M]


def build_slab(points: torch.Tensor, mask: torch.Tensor) -> SlabIndex:
    """Stable sort of the rows by x (invalid rows keyed at 3e4), with the
    coordinates, validity and original row gathered in sorted order."""
    pts = points.to(torch.float32)
    x = torch.where(mask, pts[:, 0], _BIG_X)
    _, order = torch.sort(x, stable=True)
    sorted_points = pts[order]
    valid = mask[order]
    return SlabIndex(
        sorted_points_t=sorted_points.T.contiguous(),
        sorted_orig=order,
        sorted_x=torch.where(valid, sorted_points[:, 0], _BIG_X),
        valid_sorted=valid,
    )


def block_slices(slab: SlabIndex, qx_blocks: torch.Tensor, radius: float):
    """(n_blocks,) window starts and lengths covering x in
    [block min − r, block max + r]; the right edge is inclusive, matching
    the inclusive d² ≤ r² gates downstream."""
    r = float(np.float32(radius))  # fp32 arithmetic on the device
    lo = torch.searchsorted(slab.sorted_x, qx_blocks.amin(1) - r)
    hi = torch.searchsorted(slab.sorted_x, qx_blocks.amax(1) + r, right=True)
    return lo.to(torch.int32), (hi - lo).to(torch.int32)
