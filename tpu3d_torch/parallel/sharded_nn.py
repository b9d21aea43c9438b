"""Nearest-neighbour search with the target rows sharded over a mesh axis.

Counterpart of ``tpu3d/parallel/sharded_nn.py``. Each shard searches its
own rows (K5 brute, the plain 1-D slab, or slab2 windows walked by K8);
the per-shard (d², index) pairs are gathered onto the lead device and the
winner is the argmin over the (n_shards, Q) distances. Global index =
local index + the shard's row offset. ``torch.argmin`` returns the first
minimum, so ties go to the lowest shard, then to the shard's own tie rule
(its lowest row): the single-device answer whenever the minimum is
unique, and for K5 always.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu3d_torch.ops.nn import nearest_neighbor
from tpu3d_torch.ops.nn_walk import (
    WalkTarget,
    build_walk_target,
    slab2_top1_indexed,
)
from tpu3d_torch.ops.slab import build_slab, slab_top1
from tpu3d_torch.parallel.mesh import (
    Mesh,
    all_gather,
    axis_index,
    for_shards,
    shard_rows_of,
)


def global_top1(per_shard, shard_rows: int):
    """(idx i32[Q], d2 f32[Q]) on the lead device from each shard's
    (local idx, d2): the argmin over shards, first minimum."""
    gath_d = all_gather([d for _, d in per_shard])  # (n_shards, Q)
    gath_i = all_gather([i.to(torch.int64) + s * shard_rows
                         for s, (i, _) in enumerate(per_shard)])
    win = torch.argmin(gath_d, dim=0, keepdim=True)
    return (gath_i.gather(0, win)[0].to(torch.int32),
            gath_d.gather(0, win)[0])


def nearest_neighbor_sharded(
    queries: torch.Tensor,
    targets,
    target_mask,
    mesh: Mesh,
    axis: str = "shard",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 NN (K5 per target shard). ``queries`` replicated;
    ``targets``/``target_mask`` tensors (rows divisible by the axis size:
    pad with masked rows) or :class:`ShardedRows`. Returns (idx i32[Q]
    global target rows, d2 f32[Q]) on the lead device."""
    t = shard_rows_of(targets, mesh, axis)
    tm = shard_rows_of(target_mask, mesh, axis)
    per = for_shards(mesh, axis, nearest_neighbor, queries, t, tm)
    return global_top1(per, t.shard_rows)


class ShardedSlab(NamedTuple):
    """One local x-sorted slab per shard over a row-sharded target (built
    once; the target never moves during ICP)."""

    slabs: list  # [ops.slab.SlabIndex] per shard, each on its device
    shard_rows: int


def build_slab_sharded(points, mask, mesh: Mesh,
                       axis: str = "shard") -> ShardedSlab:
    """One local x-sort per shard, no cross-shard traffic."""
    p = shard_rows_of(points, mesh, axis)
    m = shard_rows_of(mask, mesh, axis)
    return ShardedSlab(for_shards(mesh, axis, build_slab, p, m),
                       p.shard_rows)


def slab_top1_sharded(
    sslab: ShardedSlab,
    queries: torch.Tensor,
    radius,
    mesh: Mesh,
    axis: str = "shard",
    slice_cap: int = 4096,
    return_overflow: bool = False,
):
    """Nearest target within ``radius`` per query over per-shard slabs:
    (idx i32[Q] global rows, d2 f32[Q], ≥ 1e30 with no match)[, overflow:
    some shard's window exceeded ``slice_cap``, OR-ed over the shards].
    The legacy 1-D path; :func:`slab2_top1_sharded` has no cap."""

    def run(q):
        return slab_top1(sslab.slabs[axis_index()], q, radius,
                         slice_cap=slice_cap)

    per = for_shards(mesh, axis, run, queries)
    idx, d2 = global_top1([(i, d) for i, d, _ in per], sslab.shard_rows)
    if not return_overflow:
        return idx, d2
    overflow = all_gather([torch.as_tensor(o).to(torch.int32)
                           for _, _, o in per]).max() > 0
    return idx, d2, overflow


class ShardedWalk(NamedTuple):
    """One slab2 walk target per shard over a row-sharded target cloud."""

    targets: list  # [WalkTarget] per shard, each on its device
    shard_rows: int


def build_walk_sharded(points, mask, radius, mesh: Mesh,
                       axis: str = "shard") -> ShardedWalk:
    """One local composite-key sort per shard, no cross-shard traffic."""
    p = shard_rows_of(points, mesh, axis)
    m = shard_rows_of(mask, mesh, axis)
    r = float(np.float32(radius))
    return ShardedWalk(
        for_shards(mesh, axis, lambda pp, mm: build_walk_target(pp, mm, r),
                   p, m),
        p.shard_rows)


def slab2_top1_sharded(
    sw: ShardedWalk,
    queries: torch.Tensor,
    qmask: torch.Tensor,
    radius,
    mesh: Mesh,
    axis: str = "shard",
    block: int = 128,
    sub: int = 256,
    k_windows: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Radius-exact sharded top-1: K8 over each shard's slab2 windows, then
    the global argmin. Returns (idx i32[Q] global original target rows,
    d2 f32[Q], ≥ 1e30 with no in-radius match) on the lead device."""

    def run(q, qm):
        wt: WalkTarget = sw.targets[axis_index()]
        return slab2_top1_indexed(wt, q, qm, radius, block=block, sub=sub,
                                  k_windows=k_windows)

    per = for_shards(mesh, axis, run, queries, qmask)
    return global_top1(per, sw.shard_rows)
