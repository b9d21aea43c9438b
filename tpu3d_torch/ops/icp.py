"""ICP fine registration, point-to-plane and point-to-point.

Counterpart of ``tpu3d/ops/icp.py`` (``build_icp_target``, ``_solve_spd6``,
``icp_loop``, ``_p2p_stats``, ``gathered_stats_fn``,
``fused_slab_stats_fn``, ``icp_refine``). Per iteration a stats pass
reduces the correspondence problem to a few sums: the 6×6 normal
equations (point-to-plane) or the Kabsch cross-covariance and weighted
means (point-to-point), with n_corr and Σd²:

  * slab backend (targets ≥ 4,096 points, :class:`SlabStats`, the
    counterpart of ``fused_slab_stats_fn``): K7, one launch over the
    x-sorted target's per-block windows (:mod:`tpu3d_torch.ops.icp_stats`),
    which returns the point-to-plane sums or, for point-to-point, the
    per-query matches that :func:`p2p_stats` reduces;
  * brute backend (smaller targets): K5 top-1 matches, then masked sums.

Point-to-point runs when asked for and wherever the target has no
normals. The JAX ``while_loop`` becomes a Python loop. Each iteration reads
the pass's sums back to the host in one copy, where the 6×6 system is
solved in fp32 by the same unrolled Cholesky, or the 3×3 Kabsch SVD runs in
numpy fp32; the new pose stays on the host, and the slab backend hands it
to the kernel as launch arguments. That is one device→host sync per
iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from tpu3d_torch.ops.icp_stats import icp_matches, icp_p2plane_stats
from tpu3d_torch.ops.nn import nearest_neighbor
from tpu3d_torch.ops.ransac import decimation_stride
from tpu3d_torch.ops.slab import SlabIndex, build_slab
from tpu3d_torch.ops.transforms import (
    euler_xyz_to_matrix,
    kabsch_from_cross_cov,
    make_transform,
    transform_points,
)
from tpu3d_torch.types import PointCloud, RegistrationResult

# Query rows per K7 block (LANES CUDA threads each). 64 keeps windows
# narrow and gives 128 blocks at the 8,192-row bucket.
BLOCK = 64
# Targets of at least this many rows take the slab backend (K7); smaller
# ones the brute backend (K5), as the JAX package's nn_mode='auto' picks.
SLAB_MIN_TARGET = 4096


class IcpTargetIndex(NamedTuple):
    """Per-target search structure, reusable across registrations."""

    slab: SlabIndex
    nrm_sorted_t: torch.Tensor | None  # f32[3, M] normals in slab order


class IcpStats(NamedTuple):
    """Sufficient statistics of one correspondence pass as one f32 vector,
    read back in one copy: point-to-plane [JᵀJ (36) | Jᵀr (6) | n_corr |
    Σd²] (44 values); point-to-point [Σw | Σw·p (3) | Σw·q (3) | H (9) |
    n_corr | Σd²] (18), H the exact-mean-centred weighted
    cross-covariance."""

    vec: torch.Tensor

    @property
    def n_corr(self) -> torch.Tensor:
        return self.vec[-2]

    @property
    def sum_d2(self) -> torch.Tensor:
        return self.vec[-1]


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
    point_to_plane: bool = True,
) -> RegistrationResult:
    """Gauss-Newton (point-to-plane) or Kabsch (point-to-point) loop with
    the reference's semantics: stop when |Δrmse| < 1e-6 (after the first
    iteration), break before updating when n_corr < 3, keep the last finite
    pose. Reports the post-update pose with the pre-update fitness/rmse, as
    the reference does. ``stats_fn`` takes the pose on the host."""
    device = initial_transform.device
    T = initial_transform.detach().to("cpu", torch.float32)
    fitness = np.float32(0.0)
    rmse = np.float32(0.0)
    n_valid = np.float32(n_valid)
    for it in range(max_iterations):
        # The iteration's one device→host sync.
        host = stats_fn(T).vec.cpu().numpy()
        n_corr, sum_d2 = np.float32(host[-2]), np.float32(host[-1])
        if n_corr < 3.0:
            break  # before updating anything
        if point_to_plane:
            x = torch.from_numpy(_solve_spd6(host[:36].reshape(6, 6),
                                             -host[36:42]))
            delta = make_transform(euler_xyz_to_matrix(x[:3]), x[3:])
        else:
            R, t = kabsch_from_cross_cov(host[0], host[1:4], host[4:7],
                                         host[7:16].reshape(3, 3))
            delta = make_transform(torch.from_numpy(R), torch.from_numpy(t))
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


def p2p_stats(P, q, keep, d2) -> IcpStats:
    """Point-to-point statistics over full match arrays, with two-pass
    exact weighted means as the JAX package's ``_p2p_stats`` takes them,
    so both backends give numerically identical updates."""
    wf = keep.to(torch.float32)
    sw = wf.sum()
    sws = torch.clamp_min(sw, 1e-12)
    sp = (P * wf[:, None]).sum(0)
    sq = (q * wf[:, None]).sum(0)
    Pc = (P - sp / sws) * wf[:, None]
    qc = q - sq / sws
    H = Pc.T @ qc
    return IcpStats(torch.cat([
        sw[None], sp, sq, H.reshape(9), sw[None],
        torch.where(keep, d2, 0.0).sum()[None]]))


def gathered_stats_fn(
    src_pts: torch.Tensor,
    smask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    target_normals: torch.Tensor | None,
    thr: float,
    point_to_plane: bool = True,
) -> Callable[[torch.Tensor], IcpStats]:
    """Brute backend: K5 top-1 matches over all targets, then masked
    sums over the gathered matches."""
    thr_f = np.float32(thr)
    thr2 = float(thr_f * thr_f)

    def stats(T: torch.Tensor) -> IcpStats:
        P = transform_points(T.to(src_pts.device), src_pts)
        idx, d2 = nearest_neighbor(P, target_points, target_mask)
        keep = smask & (d2 <= thr2)  # inclusive
        idx = idx.long()
        q = target_points[idx]
        if not point_to_plane:
            return p2p_stats(P, q, keep, d2)
        wf = keep.to(torch.float32)
        nrm = target_normals[idx]
        J = torch.cat([torch.linalg.cross(P, nrm, dim=1), nrm], dim=1)
        r = ((P - q) * nrm).sum(1)
        Jw = J * wf[:, None]
        return IcpStats(torch.cat([
            (Jw.T @ J).reshape(36), Jw.T @ r, wf.sum()[None],
            torch.where(keep, d2, 0.0).sum()[None]]))

    return stats


class SlabStats:
    """Slab backend through K7, as a callable ``stats(T) -> IcpStats``.

    ``src_pts`` should be sorted by x at the initial pose so query blocks
    stay window-coherent; every reduction is permutation invariant, so
    nothing is un-sorted. The kernel's operands are built once here, so a
    call is one launch (point-to-plane), or one launch and the
    point-to-point sums in PyTorch."""

    def __init__(self, index: IcpTargetIndex, src_pts: torch.Tensor,
                 smask: torch.Tensor, thr: float, block: int = BLOCK,
                 point_to_plane: bool = True):
        slab = index.slab
        self.block = block
        self.point_to_plane = point_to_plane
        self.radius = float(np.float32(thr))
        self.thr2 = float(np.float32(thr) * np.float32(thr))
        pad = (-src_pts.shape[0]) % block
        self.src = torch.nn.functional.pad(
            src_pts.to(torch.float32), (0, 0, 0, pad)).contiguous()
        self.qmask = torch.nn.functional.pad(smask, (0, pad)).to(
            torch.float32)
        self.sorted_x = slab.sorted_x.contiguous()
        valid = slab.valid_sorted[None, :]
        # Invalid target rows get sentinel coordinates: the kernel carries
        # no validity mask, and d² ≈ 1e9 keeps them out of every threshold
        # test.
        planes = [torch.where(valid, slab.sorted_points_t, 3.0e4)]
        if point_to_plane:
            planes.append(torch.where(valid, index.nrm_sorted_t, 0.0))
        self.packed = torch.cat(planes).contiguous()

    def kernel_args(self, T: torch.Tensor) -> tuple:
        """K7's arguments at pose ``T``: source rows, their mask, the
        packed target, its x keys, the pose, the window radius, thr² (point
        to plane) and the block."""
        head = (self.src, self.qmask, self.packed, self.sorted_x, T,
                self.radius)
        if self.point_to_plane:
            return head + (self.thr2, self.block)
        return head + (self.block,)

    def __call__(self, T: torch.Tensor) -> IcpStats:
        T = T.detach().to("cpu", torch.float32)
        if self.point_to_plane:
            return IcpStats(icp_p2plane_stats(*self.kernel_args(T)))
        P, d2, row = icp_matches(*self.kernel_args(T))
        keep = (self.qmask > 0.5) & (d2 <= self.thr2)
        q = self.packed[:, row.clamp_min(0).long()].T
        return p2p_stats(P, q, keep, d2)


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


def _full_source_stats(index, src_pts, smask, T, thr,
                       point_to_plane) -> SlabStats:
    """Slab stats over every source row, sorted by x at pose ``T``."""
    key = torch.where(smask, transform_points(T, src_pts)[:, 0], 3e4)
    skey, order = torch.sort(key, stable=True)
    return SlabStats(index, src_pts[order], skey < 2.9e4, thr,
                     point_to_plane=point_to_plane)


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
    """ICP from ``initial_transform``: the slab backend for targets of ≥
    ``SLAB_MIN_TARGET`` rows (through ``target_index`` when given), brute
    below. Point-to-plane when ``point_to_plane`` and the target has
    normals, point-to-point (Kabsch) otherwise.

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
    use_p2l = point_to_plane and target.normals is not None
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
                          distance_threshold, point_to_plane=use_p2l)
    else:
        stats = gathered_stats_fn(src_pts, smask, target.points, target.mask,
                                  target.normals, distance_threshold, use_p2l)
    res = icp_loop(stats, n_valid, T0, max_iterations, use_p2l)
    if not use_sub:
        return res

    n_valid_full = max(float(smask_full.sum()), 1.0)
    if final_metrics == "auto":
        res = _metrics(stats(res.transformation), n_valid,
                       res.transformation)
    elif final_metrics == "exact":
        full = _full_source_stats(index, src_full, smask_full,
                                  res.transformation, distance_threshold,
                                  use_p2l)
        res = _metrics(full(res.transformation), n_valid_full,
                       res.transformation)
    if (polish == "auto" and polish_iters > 0
            and float(res.fitness) < polish_threshold):
        full = _full_source_stats(index, src_full, smask_full,
                                  res.transformation, distance_threshold,
                                  use_p2l)
        r2 = icp_loop(full, n_valid_full, res.transformation, polish_iters,
                      use_p2l)
        res = _metrics(full(r2.transformation), n_valid_full,
                       r2.transformation)
    return res
