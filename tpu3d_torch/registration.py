"""High-level registration API: ``register_pair(source, target, config)``.

Counterpart of ``tpu3d/registration.py``. Two routes, chosen once per pair
from the downsampled capacities:

  * reference parity (both below ``FUSED_CAPACITY_THRESHOLD``): one
    self-kNN (k=100, ``surface_neighbors``: brute, slab or grid) shared by
    k=30 normals and radius-capped FPFH;
  * at scale: the fused prepare (``ops/fused_features``, K2-K4). When the
    source lies on a CUDA device (or ``prepare_mode='sparse'``), the target
    gets the dense prepare and the source the sparse one, RANSAC runs on
    the sparse subset view and ICP on a strided source subset, with one
    escalation through the dense arm when the refined fitness falls below
    ``min_fitness`` (``sparse_register_escalated``).

RANSAC uses K5 correspondences and K6 scoring, ICP K7 (K5 below 4,096
target rows). ``register_pair_multiscale`` runs RANSAC once at the
coarsest voxel and ICP level by level on normals-only targets
(``prepare_icp_target``). ``mesh`` (a ``tpu3d_torch.parallel`` mesh of at
least 2 shards) routes every stage through the distributed stack
(``parallel/register_sharded.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpu3d_torch.config import RegistrationConfig
from tpu3d_torch.device import launches_kernel
from tpu3d_torch.ops import gather_graph
from tpu3d_torch.ops.fpfh import compute_fpfh
from tpu3d_torch.ops.fused_features import (
    fused_prepare_features,
    fused_prepare_sparse,
)
from tpu3d_torch.ops.grid import build_grid, grid_knn
from tpu3d_torch.ops.icp import icp_refine
from tpu3d_torch.ops.neighbors import knn
from tpu3d_torch.ops.normals import estimate_normals
from tpu3d_torch.ops.ransac import (
    Draws,
    ransac_registration,
    with_target_operand,
)
from tpu3d_torch.ops.slab import build_slab, slab_knn
from tpu3d_torch.ops.voxel import compact, voxel_downsample
from tpu3d_torch.types import FPFHFeatures, PointCloud, RegistrationResult
from tpu3d_torch.utils.profiling import host_read, span, spanned
from tpu3d_torch.utils.profiling import count as count_event

FUSED_CAPACITY_THRESHOLD = 16384
# The gather route's self-kNN k (FPFH's neighbours) and the normals' k.
NEIGHBOR_K = 100
NORMAL_K = 30


def bucket_capacity(count: int, minimum: int = 256) -> int:
    """Next power-of-two bucket ≥ count (≥ minimum)."""
    cap = minimum
    while cap < count:
        cap *= 2
    return cap


def resolve_neighbor_mode(*capacities: int) -> str:
    """One descriptor route for both clouds of a pair: 'fused' when any is
    at scale, else 'auto' (the gather route)."""
    return "fused" if max(capacities) >= FUSED_CAPACITY_THRESHOLD else "auto"


@spanned("prepare.downsample")
def downsample_bucketed(
    cloud: PointCloud,
    config: RegistrationConfig,
    capacity: Optional[int] = None,
) -> PointCloud:
    """Voxel downsample, then compact to a power-of-two capacity bucket
    (truncating loudly when an explicit ``capacity`` is too small)."""
    down = voxel_downsample(cloud, config.voxel_size)
    # The stage boundary's host sync.
    count = host_read("prepare.count", down.mask.sum(), int)
    if capacity is None:
        capacity = bucket_capacity(max(count, 1))
    elif count > capacity:
        print(
            f"tpu3d_torch: cloud has {count} voxels but capacity={capacity} "
            "— truncating"
        )
    return compact(down, capacity)


def surface_neighbors(cloud: PointCloud, radius: float, k: int = 100,
                      mode: str = "auto"):
    """One self-kNN (idx, d2) shared by normals (first 30 columns) and FPFH
    (all k, radius-gated).

    'slab' sorts the cloud by x once and searches one contiguous window per
    query block (``slab_knn``), the queries being the slab's own sorted
    points, un-permuted by one scatter: exact within ``radius`` wherever a
    block's window fits ``slab_knn``'s slice (the block that holds the
    last valid rows and padding rows does not, as in the JAX package;
    ROADMAP.md §3, faults). 'grid' is the 27-cell bucket search
    (``grid_knn``, same semantics). 'brute' is the full exact scan, the
    reference's findKNN. 'auto': slab from ``FUSED_CAPACITY_THRESHOLD``
    rows, brute below."""
    if mode == "auto":
        mode = "slab" if cloud.capacity >= FUSED_CAPACITY_THRESHOLD else (
            "brute")
    if mode == "slab":
        slab = build_slab(cloud.points, cloud.mask)
        idx, d2, _ = slab_knn(slab, slab.sorted_points_t.T, radius, k=k)
        n = slab.sorted_orig.shape[0]
        inv = torch.empty_like(slab.sorted_orig)
        inv[slab.sorted_orig] = torch.arange(n, device=inv.device)
        return idx[inv], d2[inv]
    if mode == "grid":
        grid = build_grid(cloud.points, cloud.mask, radius)
        return grid_knn(grid, cloud.points, k=k)
    return knn(cloud.points, cloud.points, cloud.mask, k=k, method="exact")


def prepare_cloud(
    cloud: PointCloud,
    config: RegistrationConfig,
    capacity: Optional[int] = None,
    neighbor_mode: str = "auto",
) -> tuple[PointCloud, FPFHFeatures]:
    """Downsample + normals + FPFH (FPFH radius = 5 × voxel_size). When
    registering a pair, resolve ``neighbor_mode`` once for both clouds
    (``resolve_neighbor_mode``), as ``register_pair`` does."""
    down = downsample_bucketed(cloud, config, capacity)
    return prepare_features(down, config, neighbor_mode)


@spanned("prepare.features")
def prepare_features(
    down: PointCloud,
    config: RegistrationConfig,
    neighbor_mode: str = "auto",
) -> tuple[PointCloud, FPFHFeatures]:
    """Normals + FPFH on a downsampled, compacted cloud: the fused sweeps
    at scale (or with ``neighbor_mode='fused'``), else the gather route on
    the ``surface_neighbors`` of that mode ('auto', 'slab', 'grid',
    'brute'). On the card the brute gather route replays one CUDA graph
    per capacity and radius (``ops/gather_graph.py``), with the eager
    route's results."""
    radius = float(np.float32(config.voxel_size * 5.0))
    if neighbor_mode == "fused" or (
        neighbor_mode == "auto" and down.capacity >= FUSED_CAPACITY_THRESHOLD
    ):
        return fused_prepare_features(down, radius)
    # 'auto' is the brute search here (below the threshold).
    if neighbor_mode in ("auto", "brute") and launches_kernel(down.points):
        with span("prepare.gather"):
            return gather_graph.gather_features(down, radius, gather_arm)
    _, down, features = gather_arm(down, radius, neighbor_mode)
    return down, features


def gather_arm(down: PointCloud, radius: float, mode: str = "brute"):
    """The gather route on ``mode``'s neighbours: the self-kNN (idx, d2),
    the cloud with its normals, and its FPFH. ``prepare_features`` runs it
    eagerly, or captures and replays it (``ops/gather_graph.py``), whose
    capture records these spans once."""
    with span("prepare.neighbors"):
        nbrs = surface_neighbors(down, radius, k=NEIGHBOR_K, mode=mode)
    with span("prepare.normals"):
        down = estimate_normals(down, k=NORMAL_K, neighbors=nbrs)
    with span("prepare.fpfh"):
        return nbrs, down, compute_fpfh(down, radius, neighbors=nbrs)


def prepare_icp_target(
    cloud: PointCloud,
    config: RegistrationConfig,
    with_normals: bool = True,
) -> PointCloud:
    """Downsample + normals only: what ICP reads of a target (never its
    FPFH). ``with_normals=False`` (point-to-point) skips the normals too.
    The neighbours are the slab search from ``FUSED_CAPACITY_THRESHOLD``
    rows, brute below."""
    down = downsample_bucketed(cloud, config)
    if not with_normals:
        return down
    radius = float(np.float32(config.voxel_size * 5.0))
    mode = "slab" if down.capacity >= FUSED_CAPACITY_THRESHOLD else "brute"
    nbrs = surface_neighbors(down, radius, k=30, mode=mode)
    return estimate_normals(down, k=30, neighbors=nbrs)


def register_prepared(
    source: PointCloud,
    target: PointCloud,
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    config: RegistrationConfig,
    draws: Draws | None = None,
) -> tuple[RegistrationResult, RegistrationResult]:
    """RANSAC + ICP on prepared clouds. Returns (refined, coarse).
    ``draws`` replaces the RANSAC draw stream (see ops/ransac.py)."""
    two_stage = two_stage_opt(config.two_stage)
    coarse = ransac_registration(
        source,
        target,
        source_features,
        target_features,
        config.voxel_size,
        max_iterations=config.ransac_max_iterations,
        confidence=config.ransac_confidence,
        seed=config.ransac_seed,
        corr_mode=config.corr_mode,
        two_stage=two_stage,
        draws=draws,
    )
    refined = icp_refine(
        source,
        target,
        coarse.transformation,
        config.voxel_size * config.icp_distance_factor,
        max_iterations=config.icp_max_iterations,
        point_to_plane=config.use_point_to_plane,
        src_mode=config.src_mode,
    )
    return refined, coarse


def two_stage_opt(v):
    """Config 'auto'|'on'|'off' (or a bool) → ransac_registration's
    two_stage."""
    if isinstance(v, str):
        return {"on": True, "off": False}.get(v, "auto")
    return v


def sparse_prepare_active(
    config: RegistrationConfig, neighbor_mode: str, source: PointCloud
) -> bool:
    """Should the source take the sparse query-subset prepare? 'sparse'
    forces it; 'auto' enables it on the fused route with corr_mode='auto'
    (which subsamples to the same 8,192 rows), a source of at least twice
    that, lying on a CUDA device."""
    if config.prepare_mode == "sparse":
        return True
    return (
        config.prepare_mode == "auto"
        and neighbor_mode == "fused"
        and config.corr_mode == "auto"
        and source.capacity >= 2 * 8192
        and launches_kernel(source.points)
    )


def sparse_register_escalated(
    src_down: PointCloud,
    tgt_down: PointCloud,
    tgt_feat: FPFHFeatures,
    *,
    voxel: float,
    radius: float,
    corr_cap: int = 8192,
    est_cap: int = 2048,
    src_cap: int = 16384,
    max_iterations: int = 100000,
    confidence: float = 0.999,
    seed: int = 42,
    icp_distance_factor: float = 0.4,
    icp_max_iterations: int = 200,
    point_to_plane: bool = True,
    two_stage="auto",
    src_mode: str = "auto",
    escalate_below: float = 0.3,
    draws: Draws | None = None,
) -> tuple[RegistrationResult, RegistrationResult, bool]:
    """The sparse-prepare arm: source descriptors only for the
    correspondence subset (``fused_prepare_sparse``), RANSAC on the subset
    view with corr_mode='exact', ICP from the downsampled source. When the
    refined fitness is below ``escalate_below``, the coarse and fine stages
    re-run through the dense-prepare corr_mode='auto' arm and the better
    fitness wins. Returns (refined, coarse, escalated); ``draws`` feeds
    both RANSAC runs."""
    ts = two_stage_opt(two_stage)
    tgt_feat = with_target_operand(tgt_feat)  # for both RANSAC runs
    sub_c, sub_f, _ = fused_prepare_sparse(src_down, radius,
                                           corr_cap=corr_cap)
    coarse = ransac_registration(
        sub_c, tgt_down, sub_f, tgt_feat, voxel,
        max_iterations=max_iterations, confidence=confidence, seed=seed,
        corr_mode="exact", est_cap=est_cap, two_stage=ts, draws=draws,
    )
    refined = icp_refine(
        src_down, tgt_down, coarse.transformation,
        voxel * icp_distance_factor, max_iterations=icp_max_iterations,
        point_to_plane=point_to_plane, src_mode=src_mode, src_cap=src_cap,
    )
    if escalate_below > 0 and host_read(
            "registration.fitness", refined.fitness, float) < escalate_below:
        with span("registration.escalate"):
            src_full, src_feat = fused_prepare_features(src_down, radius)
            coarse2 = ransac_registration(
                src_full, tgt_down, src_feat, tgt_feat, voxel,
                max_iterations=max_iterations, confidence=confidence,
                seed=seed, corr_mode="auto", corr_cap=corr_cap,
                est_cap=est_cap, two_stage=ts, draws=draws,
            )
            refined2 = icp_refine(
                src_full, tgt_down, coarse2.transformation,
                voxel * icp_distance_factor,
                max_iterations=icp_max_iterations,
                point_to_plane=point_to_plane, src_mode=src_mode,
                src_cap=src_cap,
            )
            count_event("registration.escalations")
            if (host_read("registration.fitness", refined2.fitness, float)
                    > host_read("registration.fitness", refined.fitness,
                                float)):
                return refined2, coarse2, True
    return refined, coarse, False


@spanned("register_pair", root=True)
def register_pair(
    source: PointCloud,
    target: PointCloud,
    config: Optional[RegistrationConfig] = None,
    mesh=None,
    draws: Draws | None = None,
) -> tuple[RegistrationResult, RegistrationResult]:
    """Full registration of two raw clouds → (refined, coarse), each a
    4×4 pose with fitness and rmse. The clouds' device decides where it
    runs: CUDA tensors launch the port's kernels. ``mesh`` with at least
    2 devices routes through ``register_pair_sharded``."""
    if config is None:
        config = RegistrationConfig()
    if mesh is not None and mesh.devices.size >= 2:
        from tpu3d_torch.parallel.register_sharded import (
            register_pair_sharded,
        )

        return register_pair_sharded(source, target, config, mesh,
                                     draws=draws)
    src_down = downsample_bucketed(source, config)
    tgt_down = downsample_bucketed(target, config)
    # One descriptor variant for both clouds of the pair.
    mode = resolve_neighbor_mode(src_down.capacity, tgt_down.capacity)
    if sparse_prepare_active(config, mode, src_down):
        esc = config.sparse_escalate_fitness
        if esc == "auto":
            esc = config.min_fitness
        tgt_down, tgt_feat = prepare_features(tgt_down, config, "fused")
        refined, coarse, _ = sparse_register_escalated(
            src_down, tgt_down, tgt_feat,
            voxel=config.voxel_size,
            radius=float(np.float32(config.voxel_size * 5.0)),
            max_iterations=config.ransac_max_iterations,
            confidence=config.ransac_confidence,
            seed=config.ransac_seed,
            icp_distance_factor=config.icp_distance_factor,
            icp_max_iterations=config.icp_max_iterations,
            point_to_plane=config.use_point_to_plane,
            two_stage=config.two_stage,
            src_mode=config.src_mode,
            escalate_below=float(esc),
            draws=draws,
        )
        return refined, coarse
    src_down, src_feat = prepare_features(src_down, config, mode)
    tgt_down, tgt_feat = prepare_features(tgt_down, config, mode)
    return register_prepared(src_down, tgt_down, src_feat, tgt_feat, config,
                             draws=draws)


def register_pair_multiscale(
    source: PointCloud,
    target: PointCloud,
    config: Optional[RegistrationConfig] = None,
    levels: int = 2,
    scale_step: float = 3.0,
    draws: Draws | None = None,
) -> tuple[RegistrationResult, RegistrationResult]:
    """Coarse-to-fine registration → (refined at the finest level, coarse).

    RANSAC runs once on the clouds prepared at the coarsest voxel
    (``voxel_size · scale_step^(levels−1)``); ICP then refines level by
    level down to ``voxel_size``, each level warm-starting the next, on the
    source downsampled at that voxel against a normals-only target
    (``prepare_icp_target``). Coarse levels keep matches within one voxel,
    the finest within ``icp_distance_factor`` voxels. ``draws`` replaces
    the RANSAC draw stream (see ops/ransac.py)."""
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    if config is None:
        config = RegistrationConfig()
    voxels = [config.voxel_size * scale_step**i
              for i in reversed(range(levels))]  # coarsest → finest

    coarse_cfg = dataclasses.replace(config, voxel_size=voxels[0])
    src_cd = downsample_bucketed(source, coarse_cfg)
    tgt_cd = downsample_bucketed(target, coarse_cfg)
    mode = resolve_neighbor_mode(src_cd.capacity, tgt_cd.capacity)
    src_c, sf_c = prepare_features(src_cd, coarse_cfg, mode)
    tgt_c, tf_c = prepare_features(tgt_cd, coarse_cfg, mode)
    coarse = ransac_registration(
        src_c, tgt_c, sf_c, tf_c, voxels[0],
        max_iterations=config.ransac_max_iterations,
        confidence=config.ransac_confidence,
        seed=config.ransac_seed,
        draws=draws,
    )
    T = coarse.transformation
    refined = coarse
    for voxel in voxels:
        lvl_cfg = dataclasses.replace(config, voxel_size=voxel)
        src_l = downsample_bucketed(source, lvl_cfg)
        tgt_l = prepare_icp_target(target, lvl_cfg,
                                   with_normals=config.use_point_to_plane)
        factor = config.icp_distance_factor if voxel == voxels[-1] else 1.0
        refined = icp_refine(
            src_l, tgt_l, T, voxel * factor,
            max_iterations=config.icp_max_iterations,
            point_to_plane=config.use_point_to_plane,
        )
        T = refined.transformation
    return refined, coarse
