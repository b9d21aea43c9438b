"""ICP fine registration, point-to-plane.

Counterpart of ``tpu3d/ops/icp.py`` (``build_icp_target``, ``_solve_spd6``,
``icp_loop``, ``gathered_stats_fn``, ``fused_slab_stats_fn``,
``icp_refine``). Per iteration a stats pass reduces the correspondence
problem to the 6×6 normal equations, n_corr and Σd²:

  * slab backend (targets ≥ 4,096 points, :class:`SlabStats`, the
    counterpart of ``fused_slab_stats_fn``): K7, one fused kernel over the
    x-sorted target's per-block windows (:mod:`tpu3d_torch.ops.icp_stats`);
  * brute backend (smaller targets): K5 top-1 matches, then masked sums.

The JAX ``while_loop`` becomes a Python loop. Each iteration reads the
44 floats of the normal equations back to the host, where the 6×6 system
is solved in fp32 by the same unrolled Cholesky; the new pose goes back to
the device for the next pass. That is one device→host sync per iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from tpu3d_torch.ops.icp_stats import icp_p2plane_stats, unpack_partials
from tpu3d_torch.ops.nn import nearest_neighbor
from tpu3d_torch.ops.ransac import decimation_stride
from tpu3d_torch.ops.slab import SlabIndex, block_slices, build_slab
from tpu3d_torch.ops.transforms import (
    euler_xyz_to_matrix,
    make_transform,
    transform_points,
)
from tpu3d_torch.types import PointCloud, RegistrationResult

# Query rows per K7 block: one CUDA thread each. 64 keeps windows narrow
# and gives 128 blocks at the 8,192-row bucket.
BLOCK = 64
# Targets of at least this many rows take the slab backend (K7); smaller
# ones the brute backend (K5), as the JAX package's nn_mode='auto' picks.
SLAB_MIN_TARGET = 4096


class IcpTargetIndex(NamedTuple):
    """Per-target search structure, reusable across registrations."""

    slab: SlabIndex
    nrm_sorted_t: torch.Tensor | None  # f32[3, M] normals in slab order


class IcpStats(NamedTuple):
    """Sufficient statistics of one point-to-plane correspondence pass."""

    ata: torch.Tensor  # (6, 6)
    atb: torch.Tensor  # (6,)
    n_corr: torch.Tensor  # scalar
    sum_d2: torch.Tensor  # scalar


def build_icp_target(target: PointCloud) -> IcpTargetIndex:
    """Slab index plus slab-ordered normals of a target."""
    slab = build_slab(target.points, target.mask)
    nrm = (
        None
        if target.normals is None
        else target.normals[slab.sorted_orig].T.contiguous()
    )
    return IcpTargetIndex(slab=slab, nrm_sorted_t=nrm)


def _solve_spd6(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """x = A⁻¹b for a symmetric positive-(semi)definite 6×6 in fp32:
    unrolled Cholesky and two substitutions, as in the JAX package.
    Rank-deficient systems give inf/nan, which icp_loop's finite guard
    catches."""
    A = A.astype(np.float32)
    b = b.astype(np.float32)
    L = [[None] * 6 for _ in range(6)]
    with np.errstate(all="ignore"):
        for i in range(6):
            for j in range(i + 1):
                s = A[i, j]
                for k in range(j):
                    s = s - L[i][k] * L[j][k]
                L[i][j] = np.sqrt(s) if i == j else s / L[j][j]
        y = [None] * 6
        for i in range(6):
            s = b[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * 6
        for i in reversed(range(6)):
            s = y[i]
            for k in range(i + 1, 6):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
    return np.array(x, dtype=np.float32)


def icp_loop(
    stats_fn: Callable[[torch.Tensor], IcpStats],
    n_valid: float,
    initial_transform: torch.Tensor,
    max_iterations: int,
) -> RegistrationResult:
    """Gauss-Newton driver with the reference's semantics: stop when
    |Δrmse| < 1e-6 (after the first iteration), break before updating when
    n_corr < 3, keep the last finite pose. Reports the post-update pose
    with the pre-update fitness/rmse, as the reference does."""
    device = initial_transform.device
    T = initial_transform.detach().to("cpu", torch.float32)
    fitness = np.float32(0.0)
    rmse = np.float32(0.0)
    n_valid = np.float32(n_valid)
    for it in range(max_iterations):
        s = stats_fn(T.to(device))
        host = torch.cat(
            [s.ata.reshape(-1), s.atb, s.n_corr.reshape(1), s.sum_d2.reshape(1)]
        ).cpu().numpy()  # the iteration's one device→host sync
        ata, atb = host[:36].reshape(6, 6), host[36:42]
        n_corr, sum_d2 = np.float32(host[42]), np.float32(host[43])
        if n_corr < 3.0:
            break  # before updating anything
        x = torch.from_numpy(_solve_spd6(ata, -atb))
        delta = make_transform(euler_xyz_to_matrix(x[:3]), x[3:])
        new_T = delta @ T
        new_rmse = np.sqrt(sum_d2 / np.maximum(n_corr, np.float32(1.0)))
        converged = it > 0 and abs(rmse - new_rmse) < np.float32(1e-6)
        fitness, rmse = n_corr / n_valid, new_rmse
        if not bool(torch.isfinite(new_T).all()):
            break
        T = new_T
        if converged:
            break
    return RegistrationResult(
        transformation=T.to(device),
        fitness=torch.tensor(fitness, dtype=torch.float32, device=device),
        rmse=torch.tensor(rmse, dtype=torch.float32, device=device),
    )


def gathered_stats_fn(
    src_pts: torch.Tensor,
    smask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    target_normals: torch.Tensor,
    thr: float,
) -> Callable[[torch.Tensor], IcpStats]:
    """Brute backend: K5 top-1 matches over all targets, then masked
    sums over the gathered matches."""
    thr_f = np.float32(thr)
    thr2 = float(thr_f * thr_f)

    def stats(T: torch.Tensor) -> IcpStats:
        P = transform_points(T, src_pts)
        idx, d2 = nearest_neighbor(P, target_points, target_mask)
        keep = smask & (d2 <= thr2)  # inclusive
        wf = keep.to(torch.float32)
        idx = idx.long()
        q = target_points[idx]
        nrm = target_normals[idx]
        J = torch.cat([torch.linalg.cross(P, nrm, dim=1), nrm], dim=1)
        r = ((P - q) * nrm).sum(1)
        Jw = J * wf[:, None]
        return IcpStats(
            ata=Jw.T @ J,
            atb=Jw.T @ r,
            n_corr=wf.sum(),
            sum_d2=torch.where(keep, d2, 0.0).sum(),
        )

    return stats


class SlabStats:
    """Slab backend through K7, as a callable ``stats(T) -> IcpStats``.

    ``src_pts`` should be sorted by x at the initial pose so query blocks
    stay window-coherent; every reduction is permutation invariant, so
    nothing is un-sorted."""

    def __init__(self, index: IcpTargetIndex, src_pts: torch.Tensor,
                 smask: torch.Tensor, thr: float, block: int = BLOCK):
        self.slab = index.slab
        self.block = block
        self.thr = float(np.float32(thr))
        self.thr2 = float(np.float32(thr) * np.float32(thr))
        pad = (-src_pts.shape[0]) % block
        self.smask_p = torch.nn.functional.pad(smask, (0, pad))
        self.src_p = torch.nn.functional.pad(src_pts, (0, 0, 0, pad))
        self.qmask = self.smask_p.to(torch.float32)
        valid = self.slab.valid_sorted[None, :]
        # Invalid target rows get sentinel coordinates: the kernel carries
        # no validity mask, and d² ≈ 1e9 keeps them out of every threshold
        # test.
        self.packed = torch.cat(
            [
                torch.where(valid, self.slab.sorted_points_t, 3.0e4),
                torch.where(valid, index.nrm_sorted_t, 0.0),
            ],
            dim=0,
        ).contiguous()

    def kernel_args(self, T: torch.Tensor) -> tuple:
        """K7's arguments at pose ``T``: transformed queries, their mask,
        the packed target, the per-block windows, thr² and the block."""
        P = transform_points(T, self.src_p).contiguous()
        qx = torch.where(self.smask_p, P[:, 0], 2.9e4)
        lo, length = block_slices(self.slab, qx.reshape(-1, self.block),
                                  self.thr)
        return (P, self.qmask, self.packed, lo, length, self.thr2,
                self.block)

    def __call__(self, T: torch.Tensor) -> IcpStats:
        parts = icp_p2plane_stats(*self.kernel_args(T))
        return IcpStats(*unpack_partials(parts))

def _metrics(s: IcpStats, n_valid: float, T: torch.Tensor):
    """(T, n_corr / n_valid, rmse) from one stats pass at pose T."""
    return RegistrationResult(
        transformation=T,
        fitness=s.n_corr / n_valid,
        rmse=torch.where(
            s.n_corr > 0,
            torch.sqrt(s.sum_d2 / torch.clamp_min(s.n_corr, 1.0)),
            0.0,
        ),
    )


def _full_source_stats(index, src_pts, smask, T, thr) -> SlabStats:
    """Slab stats over every source row, sorted by x at pose ``T``."""
    key = torch.where(smask, transform_points(T, src_pts)[:, 0], 3e4)
    skey, order = torch.sort(key, stable=True)
    return SlabStats(index, src_pts[order], skey < 2.9e4, thr)


def icp_refine(
    source: PointCloud,
    target: PointCloud,
    initial_transform: torch.Tensor,
    distance_threshold: float,
    max_iterations: int = 200,
    point_to_plane: bool = True,
    target_index: IcpTargetIndex | None = None,
    src_cap: int = 16384,
    src_mode: str = "auto",
    final_metrics: str = "auto",
    polish: str = "auto",
    polish_iters: int = 8,
    polish_threshold: float = 0.5,
) -> RegistrationResult:
    """Point-to-plane ICP from ``initial_transform``: the slab backend for
    targets of ≥ ``SLAB_MIN_TARGET`` rows (through ``target_index`` when
    given), brute below.

    ``src_mode`` 'auto'/'subsample' on the slab backend with a source of
    ≥ 2·``src_cap`` rows iterates on the strided ``src_cap``-row subset
    (``decimation_stride``); 'exact' always iterates every row. With the
    subset, ``final_metrics`` says what the returned fitness/rmse are:
    'auto' one more subset pass at the returned pose, 'exact' one
    full-source pass there, 'estimate' the loop's own. ``polish`` 'auto'
    then continues with up to ``polish_iters`` full-source iterations when
    that fitness is below ``polish_threshold`` and reports exact metrics at
    the polished pose: the JAX ``lax.cond`` becomes a host ``if`` on the
    fitness, one more device→host read."""
    if not (point_to_plane and target.normals is not None):
        raise NotImplementedError(
            "point-to-point ICP is not ported yet "
            "(ROADMAP.md queue 1, item 7: ICP)"
        )
    slab = target.capacity >= SLAB_MIN_TARGET
    src_pts = source.points.to(torch.float32)
    smask = source.mask
    src_full, smask_full = src_pts, smask
    use_sub = (
        slab
        and src_mode in ("subsample", "auto")
        and src_pts.shape[0] >= 2 * src_cap
    )
    if use_sub:
        stride = decimation_stride(src_pts.shape[0], src_cap)
        src_pts = src_pts[: stride * src_cap : stride]
        smask = smask[: stride * src_cap : stride]
    n_valid = max(float(smask.sum()), 1.0)
    T0 = initial_transform.to(torch.float32)
    if slab:
        index = target_index if target_index is not None else (
            build_icp_target(target))
        x0 = transform_points(T0, src_pts)[:, 0]
        _, order = torch.sort(torch.where(smask, x0, 3e4), stable=True)
        stats = SlabStats(index, src_pts[order], smask[order],
                          distance_threshold)
    else:
        stats = gathered_stats_fn(src_pts, smask, target.points, target.mask,
                                  target.normals, distance_threshold)
    res = icp_loop(stats, n_valid, T0, max_iterations)
    if not use_sub:
        return res

    n_valid_full = max(float(smask_full.sum()), 1.0)
    if final_metrics == "auto":
        res = _metrics(stats(res.transformation), n_valid,
                       res.transformation)
    elif final_metrics == "exact":
        full = _full_source_stats(index, src_full, smask_full,
                                  res.transformation, distance_threshold)
        res = _metrics(full(res.transformation), n_valid_full,
                       res.transformation)
    if (polish == "auto" and polish_iters > 0
            and float(res.fitness) < polish_threshold):
        full = _full_source_stats(index, src_full, smask_full,
                                  res.transformation, distance_threshold)
        r2 = icp_loop(full, n_valid_full, res.transformation, polish_iters)
        res = _metrics(full(r2.transformation), n_valid_full,
                       r2.transformation)
    return res
