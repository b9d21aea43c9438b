"""Plain reference of the registration core, in plain PyTorch.

It imports nothing of the program. Each function takes plain tensors and
a :class:`Precision`: ``float64`` is the reference; ``tf32`` is the
control, float32 arithmetic whose contractions round their operands to
TF32 (10 explicit mantissa bits, as the tensor cores read float32), so
that it runs the same on any device; a stage with no contraction (the
depth front end) rounds each result to bfloat16 in the control.

Semantics, as the deployment states them (``configs/*.json``):

* voxel downsample: keys ``floor(p · fl32(1/voxel))`` in float32, the
  centroid of each voxel's points, rows in ascending (x, y, z) key order;
* radius route (clouds of at least ``RADIUS_ROWS`` rows): normals from the
  covariance of every neighbour within r (self included), SPFH over every
  neighbour with 1e-16 ≤ d² ≤ r², FPFH = own SPFH + Σ SPFH_j / d_ij over
  the same set, L1-normalised;
* k-NN route (smaller clouds): normals from the 30 nearest rows (self
  included), SPFH and FPFH over the 100 nearest within r (self out);
* every normal flipped so that n·p ≤ 0; r = fl32(5 · voxel);
* descriptor correspondences: the nearest target descriptor;
* ICP: point-to-plane Gauss-Newton over matches within the threshold,
  stopping when |Δrmse| < 1e-6, with the strided source subset and the
  final pass of the configuration's ``src_mode``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RADIUS_ROWS = 16384  # capacity from which neighbourhoods are radius-exact
KNN_NORMALS = 30
KNN_FPFH = 100
_KEY_OFF = 1 << 20


class Precision:
    """``float64`` (the reference) or ``tf32`` (the control)."""

    def __init__(self, name: str):
        if name not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as a contraction reads it: cast, and rounded to TF32 in the
        control."""
        x = self.cast(x)
        return tf32_round(x) if self.name == "tf32" else x

    def elementwise(self, x: torch.Tensor) -> torch.Tensor:
        """The result of a float32 operation that is no contraction: the
        control rounds it to bfloat16, the precision below float32's."""
        return x.to(torch.bfloat16).to(self.dtype) if self.name == "tf32" \
            else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A contraction (matmul, batched or not) at this precision."""
        return torch.matmul(self.operand(a), self.operand(b))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at 10 mantissa bits."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & -8192
    return i.view(torch.float32)


def f32(x: float) -> float:
    return float(np.float32(x))


def decimation_stride(n: int, cap: int) -> int:
    """Stride of the strided subsets (RANSAC's correspondences, ICP's
    source rows): n // cap, nudged off multiples of 2 and 5."""
    stride = n // cap
    if stride > 2 and stride % 2 == 0:
        stride -= 1
    if stride > 5 and stride % 5 == 0:
        stride -= 2
    return stride


def strided(n: int, cap: int) -> torch.Tensor:
    st = decimation_stride(n, cap)
    return torch.arange(0, st * cap, st)


# ---------------------------------------------------------------- voxels


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, voxel: float,
                     prec: Precision) -> torch.Tensor:
    """Centroids (V, 3) of the occupied voxels in ascending key order."""
    inv = float(np.float32(1.0) / np.float32(voxel))
    keys = torch.floor(points.to(torch.float32) * inv).to(torch.int64)
    keys, pts = keys[mask] + _KEY_OFF, prec.operand(points[mask])
    flat = (keys[:, 0] << 42) | (keys[:, 1] << 21) | keys[:, 2]
    uniq, inverse, counts = torch.unique(flat, sorted=True,
                                         return_inverse=True,
                                         return_counts=True)
    sums = torch.zeros((uniq.shape[0], 3), dtype=prec.dtype,
                       device=pts.device).index_add_(0, inverse, pts)
    return sums / counts[:, None].to(prec.dtype)


# --------------------------------------------------------- neighbourhoods


def _sqdist(q: torch.Tensor, c: torch.Tensor, prec: Precision):
    """(B, W) squared distances by the expansion ‖q‖² + ‖c‖² − 2 q·c, whose
    contraction runs at ``prec``."""
    d2 = (q * q).sum(-1)[..., :, None] + (c * c).sum(-1)[..., None, :]
    return d2 - 2.0 * prec.mm(q, c.transpose(-1, -2))


class XBlocks:
    """Rows sorted by x, cut into query blocks, each with the window of
    rows whose x lies within ``reach`` of the block's."""

    def __init__(self, pts: torch.Tensor, reach: float, block: int = 1024):
        self.order = torch.argsort(pts[:, 0], stable=True)
        self.pts = pts[self.order]
        self.reach, self.block = reach, block
        xs = self.pts[:, 0].contiguous()
        n = pts.shape[0]
        starts = torch.arange(0, n, block, device=pts.device)
        ends = torch.clamp(starts + block, max=n) - 1
        self.lo = torch.searchsorted(xs, xs[starts] - reach).tolist()
        self.hi = torch.searchsorted(xs, xs[ends] + reach,
                                     right=True).tolist()
        self.starts = starts.tolist()

    def __iter__(self):
        """(sorted query rows b0:b1, window rows lo:hi) per block."""
        n = self.pts.shape[0]
        for b0, lo, hi in zip(self.starts, self.lo, self.hi):
            yield b0, min(b0 + self.block, n), lo, hi


def _smallest_eigvec(cov: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the least eigenvalue of (n, 3, 3) symmetric
    matrices, solved in float64 whatever made them (the precision under
    test is that of the sums)."""
    _, vecs = torch.linalg.eigh(torch.nan_to_num(cov.double()))
    return vecs[..., 0].to(cov.dtype)


def _flip(normals: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    flip = (normals * pts).sum(-1) > 0
    return torch.where(flip[:, None], -normals, normals)


def _bins(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.floor((x + 1.0) * 5.5), 0.0, 10.0).long()


def _spfh_rows(p_i, n_i, p_j, n_j, contrib, d):
    """(B, 33) L1-normalised SPFH of B query rows over (B, W) candidates;
    ``contrib`` marks the pairs that count, ``d`` their distances."""
    dhat = (p_j - p_i[:, None, :]) / torch.clamp_min(d, 1e-12)[..., None]
    u = n_i[:, None, :].expand_as(dhat)
    v = torch.linalg.cross(u, dhat, dim=-1)
    w = torch.linalg.cross(u, v, dim=-1)
    alpha = (v * n_j).sum(-1)
    phi = (u * dhat).sum(-1)
    theta = torch.atan2((w * n_j).sum(-1), (u * n_j).sum(-1))
    hist = torch.zeros((p_i.shape[0], 33), dtype=p_i.dtype,
                       device=p_i.device)
    wt = contrib.to(p_i.dtype)
    for off, x in ((0, alpha), (11, phi), (22, theta / math.pi)):
        hist.scatter_add_(1, off + _bins(x), wt)
    s = hist.sum(-1, keepdim=True)
    return torch.where(s > 0, hist / torch.clamp_min(s, 1e-300), hist)


def _normalise(f: torch.Tensor) -> torch.Tensor:
    s = f.sum(-1, keepdim=True)
    return torch.where(s > 0, f / torch.clamp_min(s, 1e-300), f)


def radius_features(pts: torch.Tensor, r: float, prec: Precision,
                    rows: torch.Tensor | None = None):
    """Radius-route (normals (n, 3), FPFH (n or len(rows), 33)) of the
    dense cloud ``pts`` (n, 3); ``rows`` limits the FPFH to those rows."""
    pts = prec.cast(pts)
    r2 = f32(np.float32(r) * np.float32(r))
    xb = XBlocks(pts, r)
    P = xb.pts
    n = P.shape[0]
    nrm = torch.empty_like(P)
    for b0, b1, lo, hi in xb:
        q, c = P[b0:b1], P[lo:hi]
        w = (_sqdist(q, c, prec) <= r2).to(P.dtype)
        ctr = q.mean(0)  # numerics only: moments about the block's mean
        cc = c - ctr
        outer = (cc[:, :, None] * cc[:, None, :]).reshape(-1, 9)
        cnt = torch.clamp_min(w.sum(1, keepdim=True), 1.0)
        mu = prec.mm(w, cc) / cnt
        m2 = (prec.mm(w, outer) / cnt).reshape(-1, 3, 3)
        cov = m2 - mu[:, :, None] * mu[:, None, :]
        nrm[b0:b1] = _flip(_smallest_eigvec(cov), q)
    spfh = torch.empty((n, 33), dtype=P.dtype, device=P.device)
    for b0, b1, lo, hi in xb:
        q, c = P[b0:b1], P[lo:hi]
        d2 = _sqdist(q, c, prec)
        contrib = (d2 <= r2) & (d2 >= 1e-16)
        d = torch.linalg.vector_norm(c[None] - q[:, None], dim=-1)
        spfh[b0:b1] = _spfh_rows(q, nrm[b0:b1], c[None], nrm[lo:hi][None],
                                 contrib, d)
    fpfh = torch.empty_like(spfh)
    for b0, b1, lo, hi in xb:
        q, c = P[b0:b1], P[lo:hi]
        d2 = _sqdist(q, c, prec)
        contrib = (d2 <= r2) & (d2 >= 1e-16)
        d = torch.linalg.vector_norm(c[None] - q[:, None], dim=-1)
        wgt = torch.where(contrib, 1.0 / torch.clamp_min(d, 1e-12), 0.0)
        fpfh[b0:b1] = _normalise(spfh[b0:b1] + prec.mm(wgt, spfh[lo:hi]))
    inv = torch.empty_like(xb.order)
    inv[xb.order] = torch.arange(n, device=inv.device)
    nrm, fpfh = nrm[inv], fpfh[inv]
    return nrm, (fpfh if rows is None else fpfh[rows])


def knn_features(pts: torch.Tensor, r: float, prec: Precision,
                 block: int = 1024):
    """k-NN-route (normals (n, 3), FPFH (n, 33)) of the dense cloud
    ``pts``: one exact self-kNN of 100 (ties to the lower row)."""
    pts = prec.cast(pts)
    r2 = f32(np.float32(r) * np.float32(r))
    n = pts.shape[0]
    k = min(KNN_FPFH, n)
    idx = torch.empty((n, k), dtype=torch.long, device=pts.device)
    for b0 in range(0, n, block):
        d2 = _sqdist(pts[b0:b0 + block], pts, prec)
        idx[b0:b0 + block] = torch.sort(d2, dim=1, stable=True)[1][:, :k]
    nb = pts[idx[:, :KNN_NORMALS]]
    diff = nb - nb.mean(1, keepdim=True)
    cov = prec.mm(diff.transpose(1, 2), diff) / nb.shape[1]
    nrm = _flip(_smallest_eigvec(cov), pts)
    d = torch.linalg.vector_norm(pts[idx] - pts[:, None], dim=-1)
    d2 = (pts[idx] - pts[:, None]).pow(2).sum(-1)
    contrib = (d2 <= r2) & (d >= 1e-8)
    spfh = torch.empty((n, 33), dtype=pts.dtype, device=pts.device)
    fpfh = torch.empty_like(spfh)
    for b0 in range(0, n, block):
        sl = slice(b0, b0 + block)
        spfh[sl] = _spfh_rows(pts[sl], nrm[sl], pts[idx[sl]], nrm[idx[sl]],
                              contrib[sl], d[sl])
    for b0 in range(0, n, block):
        sl = slice(b0, b0 + block)
        wgt = torch.where(contrib[sl], 1.0 / torch.clamp_min(d[sl], 1e-12),
                          0.0)
        acc = prec.mm(wgt[:, None, :], spfh[idx[sl]])[:, 0]
        fpfh[sl] = _normalise(spfh[sl] + acc)
    return nrm, fpfh


def radius_route(capacity: int, mode: str) -> bool:
    """The route the deployment states for a cloud of ``capacity`` rows:
    radius-exact from ``RADIUS_ROWS`` rows (or ``mode`` 'fused'), k-NN
    below."""
    return mode == "fused" or (mode == "auto" and capacity >= RADIUS_ROWS)


def features(pts: torch.Tensor, capacity: int, radius: float, mode: str,
             prec: Precision, rows: torch.Tensor | None = None):
    """Normals and FPFH on :func:`radius_route`'s route; ``rows`` limits
    the FPFH to those rows."""
    if radius_route(capacity, mode):
        return radius_features(pts, radius, prec, rows)
    nrm, fpfh = knn_features(pts, radius, prec)
    return nrm, (fpfh if rows is None else fpfh[rows])


# -------------------------------------------------------- correspondences


def descriptor_nn(src: torch.Tensor, tgt: torch.Tensor, prec: Precision,
                  block: int = 2048) -> torch.Tensor:
    """Index of the nearest ``tgt`` row (M, 33) for each ``src`` row."""
    src, tgt = prec.cast(src), prec.cast(tgt)
    out = []
    for b0 in range(0, src.shape[0], block):
        out.append(torch.argmin(_sqdist(src[b0:b0 + block], tgt, prec),
                                dim=1))
    return torch.cat(out)


def descriptor_gap(src: torch.Tensor, tgt: torch.Tensor,
                   chosen: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """Per source row, (d²(chosen) − d²(nearest)) / ‖q‖² in float64: how
    far a chosen match lies above the best one, on the scale of the
    descriptor (where the rounding of a distance lies; the nearest one may
    be all but 0, as a scan's own points are)."""
    src, tgt = src.double(), tgt.double()
    prec = Precision("float64")
    best = torch.cat([
        _sqdist(src[b0:b0 + block], tgt, prec).amin(1)
        for b0 in range(0, src.shape[0], block)])
    got = (src - tgt[chosen]).pow(2).sum(1)
    scale = torch.clamp_min(src.pow(2).sum(1), 1e-30)
    return (got - torch.clamp_min(best, 0.0)) / scale


# -------------------------------------------------------------------- ICP


def euler_xyz(a: torch.Tensor) -> torch.Tensor:
    """R = Rx(a0) Ry(a1) Rz(a2)."""
    ca, sa = torch.cos(a[0]), torch.sin(a[0])
    cb, sb = torch.cos(a[1]), torch.sin(a[1])
    cg, sg = torch.cos(a[2]), torch.sin(a[2])
    return torch.stack([
        torch.stack([cb * cg, -cb * sg, sb]),
        torch.stack([ca * sg + sa * sb * cg, ca * cg - sa * sb * sg,
                     -sa * cb]),
        torch.stack([sa * sg - ca * sb * cg, sa * cg + ca * sb * sg,
                     ca * cb]),
    ])


class NearestWithin:
    """Nearest target row of each query, exact wherever it lies within
    ``thr`` (the only matches ICP keeps): x-sorted target windows."""

    def __init__(self, tgt: torch.Tensor, thr: float, prec: Precision,
                 block: int = 512):
        self.order = torch.argsort(tgt[:, 0], stable=True)
        self.tgt = tgt[self.order]
        self.xs = self.tgt[:, 0].contiguous()
        self.thr, self.prec, self.block = thr, prec, block

    def __call__(self, P: torch.Tensor):
        """(target rows, d²) of the queries P (n, 3); d² = inf where the
        window is empty."""
        n, B = P.shape[0], self.block
        order = torch.argsort(P[:, 0], stable=True)
        Ps = P[order]
        pad = (-n) % B
        Pp = torch.cat([Ps, Ps[-1:].expand(pad, 3)]) if pad else Ps
        Q = Pp.reshape(-1, B, 3)
        lo = torch.searchsorted(self.xs, Q[:, 0, 0] - self.thr)
        hi = torch.searchsorted(self.xs, Q[:, -1, 0] + self.thr, right=True)
        W = max(int((hi - lo).max()), 1)
        m = self.tgt.shape[0]
        cand = lo[:, None] + torch.arange(W, device=P.device)[None]
        ok = cand < hi[:, None]
        C = self.tgt[cand.clamp(max=m - 1)]
        d2 = _sqdist(Q, C, self.prec)
        d2 = torch.where(ok[:, None, :], d2, math.inf)
        best, arg = d2.min(2)
        rows = torch.gather(cand, 1, arg).reshape(-1)[:n]
        best = torch.clamp_min(best.reshape(-1)[:n], 0.0)
        out_rows = torch.empty_like(rows)
        out_d2 = torch.empty_like(best)
        out_rows[order] = self.order[rows.clamp(max=m - 1)]
        out_d2[order] = best
        return out_rows, out_d2


def _icp_pass(src, nn, tgt, tnrm, T, thr2, prec):
    """(JᵀJ, Jᵀr, n_corr, Σd²) of one correspondence pass at pose T."""
    P = src @ T[:3, :3].T + T[:3, 3]
    rows, d2 = nn(P)
    keep = d2 <= thr2
    P, q, nr, d2 = P[keep], tgt[rows[keep]], tnrm[rows[keep]], d2[keep]
    J = torch.cat([torch.linalg.cross(P, nr, dim=1), nr], dim=1)
    res = ((P - q) * nr).sum(1)
    return (prec.mm(J.T, J), prec.mm(J.T, res[:, None])[:, 0],
            float(keep.sum()), float(d2.sum()))


def _icp_loop(src, nn, tgt, tnrm, T, thr2, n_valid, max_it, prec):
    fitness, rmse = 0.0, 0.0
    for it in range(max_it):
        A, b, n_corr, sum_d2 = _icp_pass(src, nn, tgt, tnrm, T, thr2, prec)
        if n_corr < 3.0:
            break
        x = torch.linalg.solve(A, -b)
        delta = torch.eye(4, dtype=T.dtype, device=T.device)
        delta[:3, :3] = euler_xyz(x[:3])
        delta[:3, 3] = x[3:]
        new_T = delta @ T
        new_rmse = math.sqrt(sum_d2 / max(n_corr, 1.0))
        converged = it > 0 and abs(rmse - new_rmse) < 1e-6
        fitness, rmse = n_corr / n_valid, new_rmse
        if not bool(torch.isfinite(new_T).all()):
            break
        T = new_T
        if converged:
            break
    return T, fitness, rmse


def icp(src_pts, src_mask, tgt_pts, tgt_mask, tgt_normals, T0, thr: float,
        max_iterations: int, prec: Precision, src_mode: str = "auto",
        src_cap: int = 16384, slab_min_target: int = 4096,
        polish_threshold: float = 0.5, polish_iters: int = 8):
    """Point-to-plane ICP from T0 → (T (4, 4), fitness, rmse). Sources of
    at least 2·``src_cap`` rows against targets of at least
    ``slab_min_target`` rows iterate on the strided subset, then report
    one more subset pass at the result, and continue on every row when
    that fitness is under ``polish_threshold``."""
    dt = prec.dtype
    full_src = prec.cast(src_pts)
    full_mask = src_mask
    use_sub = (tgt_pts.shape[0] >= slab_min_target
               and src_mode in ("auto", "subsample")
               and src_pts.shape[0] >= 2 * src_cap)
    if use_sub:
        sel = strided(src_pts.shape[0], src_cap).to(src_pts.device)
        src, mask = full_src[sel], src_mask[sel]
    else:
        src, mask = full_src, src_mask
    src = src[mask]
    tgt, tnrm = prec.cast(tgt_pts[tgt_mask]), prec.cast(
        tgt_normals[tgt_mask])
    nn = NearestWithin(tgt, thr, prec)
    thr2 = f32(np.float32(thr) * np.float32(thr))
    n_valid = max(float(mask.sum()), 1.0)
    T = T0.to(dt)
    T, fitness, rmse = _icp_loop(src, nn, tgt, tnrm, T, thr2, n_valid,
                                 max_iterations, prec)
    if not use_sub:
        return T, fitness, rmse
    _, _, n_corr, sum_d2 = _icp_pass(src, nn, tgt, tnrm, T, thr2, prec)
    fitness = n_corr / n_valid
    rmse = math.sqrt(sum_d2 / n_corr) if n_corr > 0 else 0.0
    if polish_iters > 0 and fitness < polish_threshold:
        fsrc = full_src[full_mask]
        nv = max(float(full_mask.sum()), 1.0)
        T, _, _ = _icp_loop(fsrc, nn, tgt, tnrm, T, thr2, nv, polish_iters,
                            prec)
        _, _, n_corr, sum_d2 = _icp_pass(fsrc, nn, tgt, tnrm, T, thr2, prec)
        fitness = n_corr / nv
        rmse = math.sqrt(sum_d2 / n_corr) if n_corr > 0 else 0.0
    return T, fitness, rmse


# ------------------------------------------------------------ the gate


def pose_gap(Ta: torch.Tensor, Tb: torch.Tensor) -> tuple[float, float]:
    """(rotation angle in rad, translation distance in m) between poses."""
    Ta, Tb = Ta.double().cpu(), Tb.double().cpu()
    Rd = Ta[:3, :3] @ Tb[:3, :3].T
    s = torch.stack([Rd[2, 1] - Rd[1, 2], Rd[0, 2] - Rd[2, 0],
                     Rd[1, 0] - Rd[0, 1]])
    angle = math.atan2(float(torch.linalg.vector_norm(s)) / 2.0,
                       (float(torch.trace(Rd)) - 1.0) / 2.0)
    return angle, float(torch.linalg.vector_norm(Ta[:3, 3] - Tb[:3, 3]))


def ransac_fitness(p: torch.Tensor, p_mask: torch.Tensor, q: torch.Tensor,
                   T: torch.Tensor, voxel: float,
                   prec: Precision) -> tuple[float, float]:
    """(fitness, rmse) of pose T on correspondences p → q: inliers where
    ‖R p + t − q‖² < (1.5 · voxel)², over the valid rows."""
    v32 = np.float32(voxel)
    thr2 = float((v32 * np.float32(1.5)) ** 2)
    T = prec.cast(T)
    moved = prec.mm(p, T[:3, :3].T) + T[:3, 3]
    err2 = (moved - prec.cast(q)).pow(2).sum(1)
    inl = p_mask & (err2 < thr2)
    cnt = float(inl.sum())
    n_valid = max(float(p_mask.sum()), 1.0)
    rmse = math.sqrt(float(err2[inl].sum()) / cnt) if cnt > 0 else 0.0
    return cnt / n_valid, rmse
