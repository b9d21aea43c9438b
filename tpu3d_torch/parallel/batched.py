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

``shard_instances`` (placing the instance axis across devices) is not
ported (ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3d_torch.ops.icp import icp_refine
from tpu3d_torch.ops.ransac import (
    Draws,
    ransac_registration,
    with_target_operand,
)
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


def _member(batch: PointCloud, b: int) -> PointCloud:
    return PointCloud(*(None if f is None else f[b] for f in batch))


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
) -> tuple[RegistrationResult, RegistrationResult]:
    """RANSAC + ICP for a batch of source instances against one target.

    ``sources``/``source_features`` carry a leading instance axis; the
    target is shared. Returns (refined, coarse), each stacked along the
    instance axis. ``ransac_sources``: optional RANSAC-only subset views
    (the sparse prepare's output), which RANSAC consumes with
    ``corr_mode='exact'`` while ICP refines the full ``sources``.
    ``draws`` replaces the RANSAC draw stream of every instance."""
    # fp32 product, as the JAX batch computes its threshold.
    icp_thr = float(np.float32(voxel_size) * np.float32(icp_distance_factor))
    target_features = with_target_operand(target_features)  # once a batch
    refined, coarse = [], []
    for b in range(sources.points.shape[0]):
        src = _member(sources, b)
        rsrc = None if ransac_sources is None else _member(ransac_sources, b)
        c = ransac_registration(
            src if rsrc is None else rsrc,
            target,
            FPFHFeatures(source_features.descriptors[b],
                         source_features.mask[b]),
            target_features,
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
            target,
            c.transformation,
            icp_thr,
            max_iterations=icp_max_iterations,
            point_to_plane=point_to_plane,
            src_mode=src_mode,
        )
        refined.append(r)
        coarse.append(c)

    def stack(results):
        return RegistrationResult(*(torch.stack(f) for f in zip(*results)))

    return stack(refined), stack(coarse)
