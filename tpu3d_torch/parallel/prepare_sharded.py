"""Sharded surface-feature prepare: normals + FPFH over a mesh.

Counterpart of ``tpu3d/parallel/prepare_sharded.py`` (``x_partition``,
``fused_prepare_sharded``), x-range partition plus halo exchange:

  1. :func:`x_partition` sorts the rows by x (invalid rows last) and pads
     them to a multiple of the shard count, so each shard owns an
     equal-count, x-contiguous slice.
  2. Each shard sends its last ``halo`` rows forward and its first
     ``halo`` rows backward (two ``ppermute`` s each way, points and mask).
     The end shards receive zeros; their halo rows get mask False and the
     3e4 sentinel coordinate.
  3. Each shard runs the fused prepare (K2-K4) on [left | own | right] and
     keeps its own rows.

The ``ok`` flag is False when some shard's halo strip fails to reach
3·radius past its own rows (FPFH reads SPFH within r, SPFH normals within
2r, normals points within 3r), under the JAX package's exact conditions;
a strip that holds an invalid row on the right proves the valid rows end
inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3d_torch.ops.fused_features import fused_prepare_features
from tpu3d_torch.parallel.mesh import (
    Mesh,
    ShardedRows,
    all_concat,
    all_gather,
    axis_index,
    for_shards,
    ppermute,
    shard_rows_of,
)
from tpu3d_torch.types import FPFHFeatures, PointCloud

_SENTINEL = 3.0e4


def x_partition(
    points: torch.Tensor, mask: torch.Tensor, n_shards: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows ascending in x (invalid rows last, stable), padded to a
    multiple of ``n_shards`` with 3e4 rows of mask False: (points, mask,
    orig_rows), orig_rows the input row of each output row (−1 on
    padding)."""
    n = points.shape[0]
    pts = points.to(torch.float32)
    key = torch.where(mask, pts[:, 0], _SENTINEL)
    _, order = torch.sort(key, stable=True)
    pad = (-n) % n_shards
    dev = pts.device
    out_p = torch.cat([pts[order],
                       torch.full((pad, 3), _SENTINEL, device=dev)])
    out_m = torch.cat([mask[order],
                       torch.zeros(pad, dtype=torch.bool, device=dev)])
    orig = torch.cat([order.to(torch.int32),
                      torch.full((pad,), -1, dtype=torch.int32, device=dev)])
    return out_p, out_m, orig


def fused_prepare_sharded(
    points,
    mask,
    radius,
    mesh: Mesh,
    axis: str = "shard",
    halo: int | None = None,
    block: int | None = None,
    sub: int | None = None,
) -> tuple[PointCloud, FPFHFeatures, torch.Tensor]:
    """Radius-exact normals + FPFH with the rows sharded over ``axis``.

    ``points``/``mask`` are x-partitioned (:func:`x_partition`), as tensors
    (placed by rows here) or :class:`ShardedRows`. Returns (cloud with
    normals, features, ok) in the input row order on the lead device;
    ``ok`` a bool tensor, False when some shard's halo did not span
    3·radius past its boundary. ``halo`` defaults to an eighth of the
    shard, at least 1,024 rows, at most the shard."""
    r = float(np.float32(radius))
    p_sh = shard_rows_of(points, mesh, axis)
    m_sh = shard_rows_of(mask, mesh, axis)
    n_shards = p_sh.n_shards
    shard_rows = p_sh.shard_rows
    if halo is None:
        halo = min(shard_rows, max(1024, shard_rows // 8))
    halo = min(halo, shard_rows)
    fwd = [(i, i + 1) for i in range(n_shards - 1)]
    bwd = [(i + 1, i) for i in range(n_shards - 1)]

    # Halo exchange: my last rows become the next shard's left halo, my
    # first rows the previous shard's right halo.
    left_p = ppermute([p[shard_rows - halo:] for p in p_sh.shards], fwd)
    left_m = ppermute([m[shard_rows - halo:] for m in m_sh.shards], fwd)
    right_p = ppermute([p[:halo] for p in p_sh.shards], bwd)
    right_m = ppermute([m[:halo] for m in m_sh.shards], bwd)
    three_r = np.float32(3.0) * np.float32(r)

    def local(pts, msk, lp, lm, rp, rm):
        sid = axis_index()
        lp = torch.where(lm[:, None], lp, _SENTINEL)
        rp = torch.where(rm[:, None], rp, _SENTINEL)
        loc = PointCloud(points=torch.cat([lp, pts, rp]),
                         mask=torch.cat([lm, msk, rm]))
        cloud_l, feat_l = fused_prepare_features(loc, r, block=block,
                                                 sub=sub)
        normals = cloud_l.normals[halo:halo + shard_rows]
        desc = feat_l.descriptors[halo:halo + shard_rows]
        # Exactness check (the JAX package's conditions).
        big = torch.tensor(_SENTINEL, dtype=torch.float32, device=pts.device)
        own_min = torch.where(msk, pts[:, 0], big).min()
        own_max = torch.where(msk, pts[:, 0], -big).max()
        l_min = torch.where(lm, lp[:, 0], big).min()
        r_max = torch.where(rm, rp[:, 0], -big).max()
        ok_l = (sid == 0) | (l_min <= own_min - three_r)
        ok_r = ((sid == n_shards - 1) | (r_max >= own_max + three_r)
                | ~rm.all())
        ok_shard = ~msk.any() | (ok_l & ok_r)
        return normals, desc, ok_shard

    per = for_shards(mesh, axis, local, p_sh, m_sh,
                     *(ShardedRows(x) for x in (left_p, left_m, right_p,
                                                right_m)))
    normals = all_concat([n for n, _, _ in per])
    desc = all_concat([d for _, d, _ in per])
    ok = all_gather([o for _, _, o in per]).all()
    pts_all, msk_all = p_sh.gather(), m_sh.gather()
    cloud = PointCloud(points=pts_all, mask=msk_all, normals=normals)
    return cloud, FPFHFeatures(descriptors=desc, mask=msk_all), ok
