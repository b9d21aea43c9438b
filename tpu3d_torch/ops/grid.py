"""Spatial-grid neighbour search: targets bucketed into cells of size h and
sorted by cell id; a query scans the 27 cells around its own.

Counterpart of ``tpu3d/ops/grid.py`` (``GridIndex``, ``build_grid``,
``grid_top1``, ``grid_knn``). Every target within h of a query is a
candidate, so the search is exact for threshold-limited semantics (ICP's
correspondence threshold, FPFH's radius) up to cell overflow: a cell
offers at most ``cell_capacity`` rows, the first ones in sorted order.
Grid dims are clamped to 1,290 per axis so that cell ids fit int32; h then
grows to the span over 1,287, which only adds candidates. These are XLA
in the JAX package (sorts, binary searches and gathers), so they are
plain PyTorch here, with no kernel; the arithmetic is fp32 as there, and
candidates keep the JAX order (the 27 offsets in ``meshgrid(indexing=
"ij")`` order, times the slot) so that ties resolve alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu3d_torch.ops.neighbors import smallest_k

_BIG = 1e30
_MAX_DIM = 1290  # 1290³ < 2³¹
_INVALID_CELL = 2**31 - 1  # the far sentinel cell of invalid rows


class GridIndex(NamedTuple):
    sorted_points: torch.Tensor  # f32[M, 3] targets sorted by cell id
    sorted_orig: torch.Tensor  # i64[M] original row of each sorted target
    sorted_cell_ids: torch.Tensor  # i32[M] ascending
    origin: torch.Tensor  # f32[3]
    cell_size: torch.Tensor  # f32[] effective h (≥ requested)
    dims: torch.Tensor  # i32[3] cells per axis, the guard ring included


def build_grid(points: torch.Tensor, mask: torch.Tensor,
               cell_size) -> GridIndex:
    """Bucket and stably sort the target cloud by cell id. Invalid rows
    land in the sentinel cell 2³¹ − 1, which no query neighbourhood
    reaches."""
    dev = points.device
    pts = points.to(torch.float32)
    h_req = torch.tensor(np.float32(cell_size), device=dev)
    m = mask[:, None]
    lo = torch.where(m, pts, 3e4).amin(0)
    hi = torch.where(m, pts, -3e4).amax(0)
    span = torch.clamp_min(hi - lo, 0.0)
    h = torch.maximum(h_req, span.max() / (_MAX_DIM - 3))
    origin = lo - h  # coordinates start at ≥ 1: the -1 offsets stay in range
    dims = torch.clamp_max((span / h).to(torch.int32) + 3, _MAX_DIM)
    coords = torch.floor((torch.where(m, pts, 3e4) - origin) / h)
    # Invalid rows' coordinates are replaced by the sentinel below; clamp
    # before the cast so that no value is out of int32's range.
    coords = torch.minimum(torch.clamp_min(coords, 0.0),
                           (dims - 1).to(torch.float32)).to(torch.int32)
    ids = (coords[:, 0] * dims[1] + coords[:, 1]) * dims[2] + coords[:, 2]
    ids = torch.where(mask, ids, _INVALID_CELL)
    order = torch.argsort(ids, stable=True)
    return GridIndex(
        sorted_points=pts[order],
        sorted_orig=order,
        sorted_cell_ids=ids[order].contiguous(),
        origin=origin,
        cell_size=h,
        dims=dims,
    )


def _offsets(device) -> torch.Tensor:
    r = torch.arange(-1, 2, device=device, dtype=torch.int32)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(27, 3)


def _candidates(grid: GridIndex, qc: torch.Tensor, cell_capacity: int):
    """(CH, 27·C) sorted rows of the candidates of a chunk of queries, in
    the JAX order, and their d² (1e30 past a cell's end)."""
    cell = torch.floor((qc - grid.origin) / grid.cell_size).to(torch.int32)
    nc = cell[:, None, :] + _offsets(qc.device)[None]  # (CH, 27, 3)
    nc = torch.minimum(torch.clamp_min(nc, 0), grid.dims - 1)
    cids = ((nc[..., 0] * grid.dims[1] + nc[..., 1]) * grid.dims[2]
            + nc[..., 2])
    start = torch.searchsorted(grid.sorted_cell_ids, cids, out_int32=True)
    end = torch.searchsorted(grid.sorted_cell_ids, cids, right=True,
                             out_int32=True)
    slot = torch.arange(cell_capacity, device=qc.device, dtype=torch.int32)
    cand = start[..., None] + slot  # (CH, 27, C)
    valid = (cand < end[..., None]).reshape(qc.shape[0], -1)
    m = grid.sorted_points.shape[0]
    flat = cand.clamp(0, m - 1).reshape(qc.shape[0], -1).long()
    pts = grid.sorted_points[flat]  # (CH, 27·C, 3)
    dx = pts[..., 0] - qc[:, None, 0]
    dy = pts[..., 1] - qc[:, None, 1]
    dz = pts[..., 2] - qc[:, None, 2]
    # Rounded in this order on every device (a sum reduction may not be).
    d2 = dx * dx + dy * dy + dz * dz
    return flat, torch.where(valid, d2, _BIG)


def grid_top1(grid: GridIndex, queries: torch.Tensor, cell_capacity: int = 8,
              chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest target within the cell size of each query: (idx i32[Q] into
    the original target rows, d2 f32[Q]); a query with no target in its 27
    cells gets d² ≥ 1e30. The first least candidate wins."""
    q = queries.to(torch.float32)
    idx = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    d2 = torch.empty((q.shape[0],), dtype=torch.float32, device=q.device)
    for s in range(0, q.shape[0], chunk):
        flat, dist = _candidates(grid, q[s:s + chunk], cell_capacity)
        best = torch.argmin(dist, dim=1, keepdim=True)
        idx[s:s + chunk] = grid.sorted_orig[flat.gather(1, best)[:, 0]].to(
            torch.int32)
        d2[s:s + chunk] = dist.gather(1, best)[:, 0]
    return idx, d2


def grid_knn(grid: GridIndex, queries: torch.Tensor, k: int,
             cell_capacity: int = 128,
             chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest candidates of each query, ascending: (idx i32[Q, k],
    d2 f32[Q, k]), empty slots at d² ≥ 1e30. With radius = cell size it is
    the radius-capped search, exact up to cell overflow; ties resolve to
    the earlier candidate (:func:`smallest_k`)."""
    q = queries.to(torch.float32)
    idx = torch.empty((q.shape[0], k), dtype=torch.int32, device=q.device)
    d2 = torch.empty((q.shape[0], k), dtype=torch.float32, device=q.device)
    for s in range(0, q.shape[0], chunk):
        flat, dist = _candidates(grid, q[s:s + chunk], cell_capacity)
        dk, pos = smallest_k(dist, k)
        idx[s:s + chunk] = grid.sorted_orig[flat.gather(1, pos)].to(
            torch.int32)
        d2[s:s + chunk] = dk
    return idx, d2
