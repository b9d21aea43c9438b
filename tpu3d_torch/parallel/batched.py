"""Batched multi-instance registration (the bin-picking fan-out).

Counterpart of ``tpu3d/parallel/batched.py`` (``stack_clouds``,
``register_batch``). The JAX package vmaps one RANSAC + ICP program over
a leading instance axis. The port's RANSAC and ICP are host-driven loops
(one flag per RANSAC chunk, one readback per ICP iteration), so
``register_batch`` takes the same stacked inputs and registers the
instances member by member through the single-instance RANSAC and ICP,
returning results stacked along the instance axis as ``vmap`` does. Every
instance uses the same seed, which is parity with the reference: it seeds
mt19937(42) per instance (registration.cpp:235).

``shard_instances`` places the instance axis over a mesh's 'inst' axis
(a :class:`~tpu3d_torch.parallel.mesh.ShardedRows` per field); each member
then registers on its own device against a copy of the target there.
With a 2-D ('inst', 'shard') ``mesh``, each member's RANSAC and ICP run
sharded over the 'shard' devices of its 'inst' row
(``register_prepared_sharded``): the instances data-parallel, the shared
target row-sharded.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3d_torch.config import RegistrationConfig
from tpu3d_torch.ops.icp import icp_refine
from tpu3d_torch.ops.ransac import (
    Draws,
    ransac_registration,
    with_target_operand,
)
from tpu3d_torch.parallel.mesh import Mesh, ShardedRows, shard_rows_of
from tpu3d_torch.types import FPFHFeatures, PointCloud, RegistrationResult


def stack_clouds(clouds: list[PointCloud]) -> PointCloud:
    """Stack same-capacity clouds along a new leading instance axis."""
    caps = {c.capacity for c in clouds}
    if len(caps) != 1:
        raise ValueError(f"clouds must share a capacity bucket, got {caps}")

    def stk(field):
        vals = [getattr(c, field) for c in clouds]
        if any(v is None for v in vals):
            return None
        return torch.stack(vals)

    return PointCloud(
        points=stk("points"),
        mask=stk("mask"),
        normals=stk("normals"),
        colors=stk("colors"),
    )


def _row(f, b: int):
    if f is None:
        return None
    return f.row(b) if isinstance(f, ShardedRows) else f[b]


def _member(batch, b: int):
    return type(batch)(*(_row(f, b) for f in batch))


def _on(x, device: torch.device):
    """A cloud or features with every tensor on ``device``."""
    return type(x)(*(None if f is None else f.to(device) for f in x))


def register_batch(
    sources: PointCloud,
    target: PointCloud,
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    voxel_size: float,
    ransac_max_iterations: int = 10000,
    ransac_confidence: float = 0.999,
    icp_distance_factor: float = 0.4,
    icp_max_iterations: int = 200,
    point_to_plane: bool = True,
    seed: int = 42,
    corr_mode: str = "auto",
    src_mode: str = "auto",
    two_stage: str | bool = "auto",
    ransac_sources: PointCloud | None = None,
    draws: Draws | None = None,
    mesh: Mesh | None = None,
) -> tuple[RegistrationResult, RegistrationResult]:
    """RANSAC + ICP for a batch of source instances against one target.

    ``sources``/``source_features`` carry a leading instance axis; the
    target is shared. Returns (refined, coarse), each stacked along the
    instance axis. ``ransac_sources``: optional RANSAC-only subset views
    (the sparse prepare's output), which RANSAC consumes with
    ``corr_mode='exact'`` while ICP refines the full ``sources``.
    ``draws`` replaces the RANSAC draw stream of every instance. A batch
    placed by :func:`shard_instances` registers each member on its
    device; ``mesh`` (2-D, ('inst', 'shard')) runs each member's RANSAC
    and ICP sharded over its 'inst' row (see the module docstring)."""
    # fp32 product, as the JAX batch computes its threshold.
    icp_thr = float(np.float32(voxel_size) * np.float32(icp_distance_factor))
    n_inst = (sources.points.rows if isinstance(sources.points, ShardedRows)
              else sources.points.shape[0])
    targets = {}  # device -> (target, features) there, built once a batch
    cfg = RegistrationConfig(
        voxel_size=voxel_size,
        ransac_max_iterations=ransac_max_iterations,
        ransac_confidence=ransac_confidence,
        icp_distance_factor=icp_distance_factor,
        icp_max_iterations=icp_max_iterations,
        use_point_to_plane=point_to_plane,
        ransac_seed=seed,
    )

    def target_on(device):
        if device not in targets:
            targets[device] = (_on(target, device), with_target_operand(
                _on(target_features, device)))
        return targets[device]

    refined, coarse = [], []
    for b in range(n_inst):
        src = _member(sources, b)
        rsrc = None if ransac_sources is None else _member(ransac_sources, b)
        feat = _member(source_features, b)
        if mesh is not None:
            per_row = -(-n_inst // mesh.shape["inst"])
            r, c = _sharded_member(src, rsrc, feat, target, target_features,
                                   cfg, mesh.take("inst", b // per_row),
                                   corr_mode, draws)
            refined.append(r)
            coarse.append(c)
            continue
        tgt, tgt_feat = target_on(src.points.device)
        c = ransac_registration(
            src if rsrc is None else rsrc,
            tgt,
            feat,
            tgt_feat,
            voxel_size,
            max_iterations=ransac_max_iterations,
            confidence=ransac_confidence,
            seed=seed,
            corr_mode="exact" if rsrc is not None else corr_mode,
            two_stage=two_stage,
            draws=draws,
        )
        r = icp_refine(
            src,
            tgt,
            c.transformation,
            icp_thr,
            max_iterations=icp_max_iterations,
            point_to_plane=point_to_plane,
            src_mode=src_mode,
        )
        refined.append(r)
        coarse.append(c)

    lead = refined[0].transformation.device

    def stack(results):
        return RegistrationResult(*(torch.stack([x.to(lead) for x in f])
                                    for f in zip(*results)))

    return stack(refined), stack(coarse)


def _sharded_member(src, rsrc, feat, target, target_features, cfg, row,
                    corr_mode, draws):
    """One member on its 'inst' row ``row`` (a 1-D 'shard' mesh): RANSAC
    and ICP sharded over its devices."""
    from tpu3d_torch.parallel.register_sharded import (
        register_prepared_sharded,
    )

    lead = row.axis_devices("shard")[0]
    return register_prepared_sharded(
        _on(src if rsrc is None else rsrc, lead), _on(target, lead),
        _on(feat, lead), _on(target_features, lead), cfg, row,
        corr_mode="exact" if rsrc is not None else corr_mode,
        icp_source=_on(src, lead), draws=draws)


def shard_instances(
    sources: PointCloud,
    source_features: FPFHFeatures,
    mesh: Mesh,
    axis: str = "inst",
) -> tuple[PointCloud, FPFHFeatures]:
    """Place the instance axis of a stacked batch across a mesh axis (data
    parallel): every field becomes a :class:`ShardedRows` of instances."""

    def put(a):
        return None if a is None else shard_rows_of(a, mesh, axis)

    return (
        PointCloud(*(put(f) for f in sources)),
        FPFHFeatures(descriptors=put(source_features.descriptors),
                     mask=put(source_features.mask)),
    )
