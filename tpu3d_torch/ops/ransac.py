"""RANSAC coarse registration: batches of hypotheses with an exact early exit.

Counterpart of ``tpu3d/ops/ransac.py`` (``decimation_stride``,
``build_scoring_factors``, ``pack_hypotheses``, ``build_rotation_table``,
``solve_rotation_chunk``, ``feature_correspondences`` and the chunked and
one-shot routes of ``ransac_registration``): 33-D descriptor nearest
neighbours (K5), 3-point samples solved by QCP (K10 for the rotation
sampler, K11 for the gather sampler, both ``csrc/ransac_hyp.cu``), and
rank-16 scoring (K6).
Two samplers, as in the JAX package: the gather-free rotation sampler
(chunked route, n ≥ 2,048) and the gather sampler (three independent
valid-row draws per hypothesis, duplicates disabled) below that, on the
one-shot route (``max_iterations`` ≤ the chunk size, or ``early_exit``
off), which scores every hypothesis at once, and where ``sampling`` asks
for it. ``score_w16`` is
:func:`tpu3d_torch.ops.ransac_score.score_hypotheses`.

The JAX ``while_loop`` over chunks becomes a Python loop that reads one
flag back per chunk; the chunk's body (K10 or K11 → K6 estimate → top-32
→ K6 exact → champion) reads nothing back, and on the card either
sampler's route replays it as one CUDA graph per chunk
(:data:`CHUNK_GRAPH`). The random draws come from an injectable
:class:`Draws` stream on the host (:func:`torch_draws` by default; tests
replay the JAX stream): a chunk's epoch offsets reach K10 as a small
int32 tensor (:func:`epoch_params`), the gather sampler's triples reach
K11 as int32 in one copy (:func:`gather_params`).
"""

from __future__ import annotations

import threading
from typing import Protocol

import numpy as np
import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel, on_device
from tpu3d_torch.ops.nn import descriptor_targets, nearest_neighbor
from tpu3d_torch.ops.ransac_score import score_hypotheses
from tpu3d_torch.ops.transforms import kabsch_quat, make_transform
from tpu3d_torch.types import FPFHFeatures, PointCloud, RegistrationResult
from tpu3d_torch.utils.profiling import host_read, span, spanned
from tpu3d_torch.utils.profiling import count as count_event


class Draws(Protocol):
    """The RANSAC draw stream.

    ``draws(chunk, epoch)`` is the rotation sampler's triple (u0, u1, u2),
    each in [0, 2**30). ``draws.triples(chunk, h, count)`` is the gather
    sampler's i64[h, 3] row draws in [0, count) (CPU), ``chunk`` None on
    the one-shot and the two-stage routes. ``draws.rows(n, count)`` is the
    two-stage route's stage-1 draw: i64[n] valid-row ranks in [0, count),
    with replacement (CPU). A plain function serves where only the
    rotation sampler runs. The sharded RANSAC
    (``parallel/ransac_sharded.py``) asks shard s of round c for chunk
    c·n_shards + s, as the JAX package keys it."""

    def __call__(self, chunk: int, epoch: int) -> tuple[int, int, int]: ...

    def triples(self, chunk: int | None, h: int, count: int) -> torch.Tensor:
        ...

    def rows(self, n: int, count: int) -> torch.Tensor: ...


# Rows of the two-stage route's stage-1 estimate.
SUB_N = 16384


def hypothesis_chunk(max_iterations: int) -> int:
    """Hypotheses per chunk: a quarter of the budget, rounded up to 1,024,
    at least 16,384."""
    quarter = -(-max_iterations // 4)
    return max(16384, (quarter + 1023) // 1024 * 1024)


class TorchDraws:
    """Default draw stream: a seeded ``torch.Generator`` per (chunk, epoch),
    and per chunk for the gather sampler (a different stream from
    ``jax.random``, the same class of delta as any reseeding)."""

    def __init__(self, seed: int):
        self.seed = seed

    def _generator(self, chunk: int, epoch: int) -> torch.Generator:
        return torch.Generator().manual_seed(
            (self.seed * 1_000_003 + chunk) * 1_000_003 + epoch
        )

    def __call__(self, chunk: int, epoch: int) -> tuple[int, int, int]:
        u = torch.randint(0, 1 << 30, (3,),
                          generator=self._generator(chunk, epoch))
        return int(u[0]), int(u[1]), int(u[2])

    def triples(self, chunk: int | None, h: int, count: int) -> torch.Tensor:
        # Epoch −1 never occurs on the rotation side.
        g = self._generator(-1 if chunk is None else chunk, -1)
        return torch.randint(0, max(count, 1), (h, 3), generator=g)

    def rows(self, n: int, count: int) -> torch.Tensor:
        # Chunk −2 never occurs on either sampler's side.
        g = self._generator(-2, -1)
        return torch.randint(0, max(count, 1), (n,), generator=g)


def torch_draws(seed: int) -> TorchDraws:
    return TorchDraws(seed)


def decimation_stride(n: int, cap: int) -> int:
    """Stride for strided decimation of ``n`` rows down to ``cap``, nudged
    away from raster-width factors 2 and 5 (only ever shrinks)."""
    stride = n // cap
    if stride > 2 and stride % 2 == 0:
        stride -= 1
    if stride > 5 and stride % 5 == 0:
        stride -= 2
    return stride


def strided_rows(x: torch.Tensor, cap: int) -> torch.Tensor:
    """Rows 0, s, 2s, … (``cap`` of them) with s = decimation_stride."""
    st = decimation_stride(x.shape[0], cap)
    return x[: st * cap : st]


def build_scoring_factors(p_, q_, mask_):
    """Point-side factors for err²[n,h] = F_n·W_h + pq_n + ‖t_h‖²: F as
    (16, N) K-major, pq with 1e30 on invalid rows."""
    px, py, pz = p_[:, 0], p_[:, 1], p_[:, 2]
    qx, qy, qz = q_[:, 0], q_[:, 1], q_[:, 2]
    pq = px * px + py * py + pz * pz + qx * qx + qy * qy + qz * qz
    pq = torch.where(mask_, pq, 1e30)
    ft = torch.stack(
        [
            2.0 * px, 2.0 * py, 2.0 * pz,
            -2.0 * qx, -2.0 * qy, -2.0 * qz,
            -2.0 * qx * px, -2.0 * qx * py, -2.0 * qx * pz,
            -2.0 * qy * px, -2.0 * qy * py, -2.0 * qy * pz,
            -2.0 * qz * px, -2.0 * qz * py, -2.0 * qz * pz,
            torch.zeros_like(px),
        ]
    )
    return ft.contiguous(), pq


def pack_hypotheses(Rs, ts):
    """(h, 3, 3)/(h, 3) solutions → K-major (16, h) scoring factors
    [Rᵀt | t | vec(R) | 0] and ‖t‖²."""
    u = [(Rs[:, 0, j] * ts[:, 0] + Rs[:, 1, j] * ts[:, 1])
         + Rs[:, 2, j] * ts[:, 2] for j in range(3)]
    w16t = torch.stack(
        u + [ts[:, 0], ts[:, 1], ts[:, 2]]
        + [Rs[:, i, j] for i in range(3) for j in range(3)]
        + [torch.zeros_like(ts[:, 0])]
    )
    t_norm = (ts[:, 0] * ts[:, 0] + ts[:, 1] * ts[:, 1]) + ts[:, 2] * ts[:, 2]
    return w16t, t_norm


def solve_gather(triples, first_id, perm, pq_packed, max_iterations):
    """Gather sampling: hypothesis i takes the valid rows ``perm[triples[i]]``
    (three independent draws; a repeated draw disables it, as the
    reference rejects it), solved by QCP. Returns (w16t (16, h), t_norm
    (h,), disabled (h,)). K11 on the card: the triples go there as int32
    through pinned memory, in one copy with ``first_id`` and the budget."""
    h = triples.shape[0]
    params = gather_params(triples, first_id, max_iterations, perm.shape[0],
                           pin=perm.is_cuda)
    return gather_hypotheses(params.to(perm.device, non_blocking=True), perm,
                             pq_packed, h)


# --- K11: the gather sampler's hypotheses (csrc/ransac_hyp.cu) ----------

# Float operations per hypothesis in K11's solve, each arithmetic operation
# (division and 1/sqrt included) one: means and centring 36, correlations
# 45, E0 36, Horn 16, N² 70, traces 43, coefficients 6, 12 Newton steps
# 168, three adjugate columns 783, two Rayleigh quotients 70,
# renormalisation 12, R 45, t 18, Rᵀt 15, ‖t‖² 5.
GATHER_FLOPS_PER_HYPOTHESIS = 1368


def gather_params(triples, first_id: int, max_iterations: int, n: int,
                  pin: bool = False) -> torch.Tensor:
    """K11's int32 parameters on the host: [first_id, max_iterations, then
    the (h, 3) draws row by row], in pinned memory when ``pin``. Raises
    when a draw lies outside [0, n), the rows of ``perm``."""
    tri = torch.as_tensor(triples).reshape(-1, 3).cpu()
    h = tri.shape[0]
    if h:
        lo, hi = torch.aminmax(tri)
        if int(lo) < 0 or int(hi) >= n:
            raise ValueError(f"draws in [{int(lo)}, {int(hi)}], not in "
                             f"[0, {n})")
    out = torch.empty(2 + 3 * h, dtype=torch.int32, pin_memory=pin)
    out[:2] = torch.tensor([first_id, max_iterations], dtype=torch.int32)
    out[2:].view(h, 3).copy_(tri)
    return out


def gather_hypotheses_plain(params, perm, pq_packed, h):
    """K11's plain version: ``solve_gather``'s eager body on the ``h``
    triples that ``params`` (:func:`gather_params`) holds, each operation
    rounded once (``kabsch_quat``), so that K11 equals it bit for bit."""
    tri = params[2:2 + 3 * h].long().reshape(h, 3)
    dup = ((tri[:, 0] == tri[:, 1]) | (tri[:, 1] == tri[:, 2])
           | (tri[:, 0] == tri[:, 2]))
    ids = params[0].long() + torch.arange(h, device=params.device)
    disabled = dup | (ids >= params[1].long())
    s6 = pq_packed[perm[tri]]  # (h, 3, 6)
    Rs, ts = kabsch_quat(s6[..., :3], s6[..., 3:])
    w16t, t_norm = pack_hypotheses(Rs, ts)
    return w16t, t_norm, disabled


def gather_hypotheses(
    params: torch.Tensor,  # i32[2 + 3h] (gather_params)
    perm: torch.Tensor,  # i64[n] rows, valid first
    pq_packed: torch.Tensor,  # f32[n, 6] p|q rows
    h: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11: (w16t f32[16, h], t_norm f32[h], disabled bool[h]) of ``h``
    gather-sampled hypotheses. CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    if params.ndim != 1 or params.shape[0] < 2 + 3 * h:
        raise ValueError("params must hold 2 + 3 per hypothesis")
    if (perm.ndim != 1 or pq_packed.ndim != 2 or pq_packed.shape[1] != 6
            or pq_packed.shape[0] != perm.shape[0]):
        raise ValueError("perm must be (n,) and pq_packed (n, 6)")
    if not launches_kernel(params, perm, pq_packed):
        return gather_hypotheses_plain(params, perm, pq_packed, h)
    if (params.dtype != torch.int32 or perm.dtype != torch.int64
            or pq_packed.dtype != torch.float32):
        raise TypeError("K11 takes int32 params, int64 perm and float32 "
                        "rows")
    params, perm = params.contiguous(), perm.contiguous()
    pq_packed = pq_packed.contiguous()
    dev = pq_packed.device
    w16t = torch.empty((16, h), dtype=torch.float32, device=dev)
    t_norm = torch.empty((h,), dtype=torch.float32, device=dev)
    disabled = torch.empty((h,), dtype=torch.bool, device=dev)
    with on_device(dev):
        rc = build.library().tpu3d_gather_hyp(
            params.data_ptr(), perm.data_ptr(), pq_packed.data_ptr(), h,
            w16t.data_ptr(), t_norm.data_ptr(), disabled.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tpu3d_gather_hyp")
    build.count_launch(gather_hypotheses)
    return w16t, t_norm, disabled


gather_hypotheses.launches = 0


def build_rotation_table(pq_packed, src_mask, count: int):
    """(6, 2n) plane table: valid rows first (stable), then a second copy
    starting at column ``count``, so columns [r, r + n) read row
    (i + r) mod count at position i for any r < count."""
    _, order = torch.sort((~src_mask).to(torch.int8), stable=True)
    pq_sorted_t = pq_packed[order].T
    n = pq_sorted_t.shape[1]
    table = torch.zeros((6, 2 * n), dtype=pq_sorted_t.dtype,
                        device=pq_sorted_t.device)
    table[:, :n] = pq_sorted_t
    table[:, count:count + n] = pq_sorted_t
    return table


# --- K10: the rotation sampler's hypotheses (csrc/ransac_hyp.cu) --------

# Float operations per hypothesis in K10's solve, an fma counted as two,
# every other arithmetic operation (division and 1/sqrt included) as one:
# means and centring 51, correlations 45, E0 36, Horn 14, N² 70, traces
# 43, coefficients 5, 12 Newton steps 168, three adjugate columns 783, two
# Rayleigh quotients 70, renormalisation 12, R 45, t 21, Rᵀt 15, ‖t‖² 5.
FLOPS_PER_HYPOTHESIS = 1383
_THIRD = float(np.float32(1.0 / 3.0))


def _fma(a, b, c):
    """fp32 a·b + c rounded once, as ``__fmaf_rn``: the product is exact in
    float64 and the sum is rounded to odd there (TwoSum), so the one
    rounding to fp32 is the correct one."""
    a, b, c = (x.double() if torch.is_tensor(x) else x for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even & torch.isfinite(s),
                    torch.nextafter(s, away), s)
    return s.float()


def _rsqrt_rn(x):
    """1/√x rounded once (``__frsqrt_rn``), from float64."""
    return (1.0 / torch.sqrt(x.double())).float()


def _dot4(x0, y0, x1, y1, x2, y2, x3, y3):
    """x0·y0 + x1·y1 + x2·y2 + x3·y3 in the JAX sum's order, contracted."""
    return _fma(x3, y3, _fma(x2, y2, _fma(x0, y0, x1 * y1)))


def _det3(A, i0, i1, i2, j0, j1, j2):
    m1 = _fma(A[i1][j1], A[i2][j2], -(A[i1][j2] * A[i2][j1]))
    m2 = _fma(A[i1][j0], A[i2][j2], -(A[i1][j2] * A[i2][j0]))
    m3 = _fma(A[i1][j0], A[i2][j1], -(A[i1][j1] * A[i2][j0]))
    return _fma(A[i0][j2], m3, _fma(A[i0][j0], m1, -(A[i0][j1] * m2)))


def _adj_best_col(N, lam):
    """The largest adjugate column of N − λI, normalised."""
    A = [[N[a][b] - lam if a == b else N[a][b] for b in range(4)]
         for a in range(4)]
    best, best_norm = None, None
    for k in range(4):
        r = [x for x in range(4) if x != k]
        col = []
        for i in range(4):
            c = [x for x in range(4) if x != i]
            d = _det3(A, *r, *c)
            col.append(-d if (i + k) % 2 else d)
        nrm = _dot4(col[0], col[0], col[1], col[1], col[2], col[2],
                    col[3], col[3])
        if best is None:
            best, best_norm = col, nrm
        else:
            take = nrm > best_norm
            best = [torch.where(take, x, y) for x, y in zip(col, best)]
            best_norm = torch.where(take, nrm, best_norm)
    # max(best_norm, 1e-60) in fp32 is max(best_norm, 0); NaN propagates.
    inv = _rsqrt_rn(torch.maximum(best_norm, torch.zeros_like(best_norm)))
    return [x * inv for x in best]


def _rayleigh(N, v):
    nv = [_dot4(N[a][0], v[0], N[a][1], v[1], N[a][2], v[2], N[a][3], v[3])
          for a in range(4)]
    return _dot4(v[0], nv[0], v[1], nv[1], v[2], nv[2], v[3], nv[3])


def qcp3_w16(P, Q):
    """K10's solve on planes: ``P[s][c]``/``Q[s][c]`` are coordinate c of
    slot s's source and target points, (h,) each. Returns (w16t (16, h),
    t_norm (h,)). ``tpu3d/ops/transforms.py`` ``kabsch3_planes`` and the
    w16 packing of ``solve_rotation_chunk``, with each a·b + c of the JAX
    expression one fused multiply-add (the first product of a sum first)
    and every other operation rounded once, 1/√x correctly rounded: the
    kernel's order, line for line."""
    third = _THIRD
    psum = [(P[0][c] + P[1][c]) + P[2][c] for c in range(3)]
    qsum = [(Q[0][c] + Q[1][c]) + Q[2][c] for c in range(3)]
    pm = [x * third for x in psum]
    pc = [[_fma(-psum[c], third, P[s][c]) for c in range(3)]
          for s in range(3)]
    qc = [[_fma(-qsum[c], third, Q[s][c]) for c in range(3)]
          for s in range(3)]
    S = [[_fma(pc[2][a], qc[2][b], _fma(pc[0][a], qc[0][b],
                                         pc[1][a] * qc[1][b]))
          for b in range(3)] for a in range(3)]
    e0 = None
    for s in range(3):
        for c in range(3):
            term = _fma(pc[s][c], pc[s][c], qc[s][c] * qc[s][c])
            e0 = term if e0 is None else e0 + term
    e0 = 0.5 * e0

    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = S
    n01, n02, n03 = syz - szy, szx - sxz, sxy - syx
    n12, n13, n23 = sxy + syx, szx + sxz, syz + szy
    N = [[(sxx + syy) + szz, n01, n02, n03],
         [n01, (sxx - syy) - szz, n12, n13],
         [n02, n12, (syy - sxx) - szz, n23],
         [n03, n13, n23, (-sxx - syy) + szz]]
    M = [[None] * 4 for _ in range(4)]
    for a in range(4):
        for b in range(a, 4):
            M[a][b] = M[b][a] = _dot4(N[a][0], N[0][b], N[a][1], N[1][b],
                                      N[a][2], N[2][b], N[a][3], N[3][b])

    def trace_sum(X, Y):
        """Σ_a X_aa·Y_aa + 2·Σ_{a<b} X_ab·Y_ab in the JAX order."""
        off = X[0][2] * Y[0][2]
        for a, b in ((0, 1), (0, 3), (1, 2), (1, 3), (2, 3)):
            off = _fma(X[a][b], Y[a][b], off)
        diag = _dot4(X[0][0], Y[0][0], X[1][1], Y[1][1], X[2][2], Y[2][2],
                     X[3][3], Y[3][3])
        return _fma(2.0, off, diag)

    tr2 = ((M[0][0] + M[1][1]) + M[2][2]) + M[3][3]
    tr3 = trace_sum(N, M)
    tr4 = trace_sum(M, M)
    c2 = -0.5 * tr2
    c1 = -tr3 * third  # XLA divides by 3 as · (1/3)
    c0 = -0.25 * _fma(c2, tr2, tr4)

    lam = e0  # λ_max ≤ E0: Newton from above
    for _ in range(12):
        p = _fma(_fma(_fma(lam, lam, c2), lam, c1), lam, c0)
        dp = _fma(_fma(4.0 * lam, lam, 2.0 * c2), lam, c1)
        lam = lam - p / torch.where(dp.abs() > 1e-20, dp, 1e-20)

    v = _adj_best_col(N, lam)
    for _ in range(2):
        v = _adj_best_col(N, _rayleigh(N, v))
    nrm = _dot4(v[0], v[0], v[1], v[1], v[2], v[2], v[3], v[3])
    ok = torch.isfinite(nrm) & (nrm > 1e-12)
    inv = _rsqrt_rn(torch.where(ok, nrm, 1.0))
    q0, qx, qy, qz = (torch.where(ok, x * inv, fb)
                      for x, fb in zip(v, (1.0, 0.0, 0.0, 0.0)))

    r = [
        _fma(-qz, qz, _fma(-qy, qy, _fma(q0, q0, qx * qx))),
        2.0 * _fma(qx, qy, -(q0 * qz)),
        2.0 * _fma(qx, qz, q0 * qy),
        2.0 * _fma(qy, qx, q0 * qz),
        _fma(-qz, qz, _fma(qy, qy, _fma(q0, q0, -(qx * qx)))),
        2.0 * _fma(qy, qz, -(q0 * qx)),
        2.0 * _fma(qz, qx, -(q0 * qy)),
        2.0 * _fma(qz, qy, q0 * qx),
        _fma(qz, qz, _fma(-qy, qy, _fma(q0, q0, -(qx * qx)))),
    ]
    t = [_fma(qsum[a], third,
              -_fma(r[3 * a + 2], pm[2],
                    _fma(r[3 * a], pm[0], r[3 * a + 1] * pm[1])))
         for a in range(3)]
    u = [_fma(r[6 + a], t[2], _fma(r[a], t[0], r[3 + a] * t[1]))
         for a in range(3)]
    w16t = torch.stack(u + t + r + [torch.zeros_like(t[0])])
    t_norm = _fma(t[2], t[2], _fma(t[0], t[0], t[1] * t[1]))
    return w16t, t_norm


def rotation_hypotheses_plain(pq2p, params, h):
    """K10's plain version: (w16t (16, h), t_norm (h,), disabled (h,)) of
    the ``h`` rotation-sampler hypotheses that ``params``
    (:func:`epoch_params`, a device tensor) describe."""
    n = pq2p.shape[1] // 2
    dev = pq2p.device
    first_id, count, max_it = (params[k].long() for k in range(3))
    j = torch.arange(h, device=dev)
    e, i = j // n, j % n
    off = params[3:].long().reshape(-1, 3)[e]  # (h, 3)
    slots = [pq2p[:, i + off[:, s]] for s in range(3)]  # 3 × (6, h)
    w16t, t_norm = qcp3_w16([[x[c] for c in range(3)] for x in slots],
                            [[x[3 + c] for c in range(3)] for x in slots])
    disabled = ((i >= count) | (first_id + e * count + i >= max_it)
                | (count < 3))
    return w16t, t_norm, disabled


def rotation_hypotheses(
    pq2p: torch.Tensor,  # f32[6, 2n] plane table (build_rotation_table)
    params: torch.Tensor,  # i32[3 + 3·epochs] (epoch_params)
    h: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10: (w16t f32[16, h], t_norm f32[h], disabled bool[h]) of a
    chunk's rotation-sampler hypotheses. CUDA tensors launch the kernel,
    CPU tensors take the plain version."""
    if pq2p.ndim != 2 or pq2p.shape[0] != 6 or pq2p.shape[1] % 2:
        raise ValueError("pq2p must be (6, 2n)")
    n = pq2p.shape[1] // 2
    if params.ndim != 1 or params.shape[0] < 3 + 3 * -(-h // n):
        raise ValueError("params must hold 3 + 3 per epoch")
    if not launches_kernel(pq2p, params):
        return rotation_hypotheses_plain(pq2p, params, h)
    if pq2p.dtype != torch.float32 or params.dtype != torch.int32:
        raise TypeError("K10 takes a float32 table and int32 params")
    pq2p, params = pq2p.contiguous(), params.contiguous()
    dev = pq2p.device
    w16t = torch.empty((16, h), dtype=torch.float32, device=dev)
    t_norm = torch.empty((h,), dtype=torch.float32, device=dev)
    disabled = torch.empty((h,), dtype=torch.bool, device=dev)
    with on_device(dev):
        rc = build.library().tpu3d_ransac_hyp(
            pq2p.data_ptr(), params.data_ptr(), n, h, w16t.data_ptr(),
            t_norm.data_ptr(), disabled.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "tpu3d_ransac_hyp")
    build.count_launch(rotation_hypotheses)
    return w16t, t_norm, disabled


rotation_hypotheses.launches = 0


def epoch_params(draw, n_ep: int, first_id: int, count: int,
                 max_iterations: int) -> list[int]:
    """K10's int32 parameters for one chunk, on the host: [first_id, count,
    max_iterations] then, per epoch e, the three slot offsets (r0,
    (r0 + r1) mod count, (r0 + r2) mod count) from ``draw(e)``, so that
    slot s of valid row i reads table column i + offset."""
    cm1 = max(count - 1, 1)
    cm2 = max(count - 2, 1)
    out = [first_id, count, max_iterations]
    for e in range(n_ep):
        u0, u1, u2 = draw(e)
        a = u0 % cm1
        r1 = 1 + a
        r2 = 1 + (a + 1 + u1 % cm2) % cm1
        r0 = u2 % max(count, 1)
        out += [r0, (r0 + r1) % count, (r0 + r2) % count]
    return out


def solve_rotation_chunk(draw, h, first_id, pq2p, count, max_iterations):
    """Gather-free 3-point sampling over ceil(h/n) epochs; epoch e pairs
    valid row i with rows (i + r1) mod count and (i + r2) mod count, from
    ``draw(e)`` (host ints, never a device read). Returns (w16t (16, h),
    t_norm (h,), disabled (h,), ids (h,), n_consumed): each valid triple
    consumes one iteration id. K10 on the card."""
    n = pq2p.shape[1] // 2
    n_ep = -(-h // n)
    params = torch.tensor(
        epoch_params(draw, n_ep, first_id, count, max_iterations),
        dtype=torch.int32).to(pq2p.device, non_blocking=True)
    w16t, t_norm, disabled = rotation_hypotheses(pq2p, params, h)
    # first_id + cumsum(valid slots) − 1: e·count + i on valid slot i of
    # epoch e, the epoch's last id on the rest.
    j = torch.arange(h, device=pq2p.device)
    ids = first_id + (j // n) * count + torch.clamp_max(j % n, count - 1)
    n_consumed = (h // n) * count + min(h % n, count)
    return w16t, t_norm, disabled, ids, n_consumed


def with_target_operand(target_features: FPFHFeatures) -> FPFHFeatures:
    """``target_features`` with K5's packed target operand attached when
    they lie on the card, so that every :func:`feature_correspondences`
    against them packs only its queries. Call it once per target model."""
    d, m = target_features.descriptors, target_features.mask
    if target_features.nn_operand is not None or not launches_kernel(d, m):
        return target_features
    return target_features._replace(nn_operand=descriptor_targets(d, m))


def feature_correspondences(
    source_features: FPFHFeatures, target_features: FPFHFeatures
) -> torch.Tensor:
    """Nearest target row in 33-D descriptor space per source row (K5,
    fp32; ties to the lowest index)."""
    idx, _ = nearest_neighbor(
        source_features.descriptors,
        target_features.descriptors,
        target_features.mask,
        packed_targets=target_features.nn_operand,
    )
    return idx


@spanned("ransac")
def ransac_registration(
    source: PointCloud,
    target: PointCloud,
    source_features: FPFHFeatures,
    target_features: FPFHFeatures,
    voxel_size: float,
    max_iterations: int = 100000,
    confidence: float = 0.999,
    seed: int = 42,
    chunk: int = 512,
    two_stage: str | bool = "auto",
    corr_cap: int = 8192,
    corr_mode: str = "auto",
    hyp_chunk: int | str = "auto",
    early_exit: str | bool = "auto",
    est_cap: int = 2048,
    sampling: str = "auto",
    draws: Draws | None = None,
) -> RegistrationResult:
    """Coarse pose: the best hypothesis in the prefix that ends at the first
    one whose fitness exceeds ``confidence``, with fitness/rmse rescored
    directly at the winner.

    Routes, as in the JAX package: with ``max_iterations`` above
    ``hyp_chunk`` (by default :func:`hypothesis_chunk`) and ``early_exit``
    'auto' or True, chunks of ``hyp_chunk`` hypotheses until one exceeds,
    and for n ≥ 2·``est_cap`` the in-chunk estimate stage (every
    hypothesis scored on a strided ``est_cap``-row subset, the top 32
    rescored exactly); otherwise (or with ``early_exit`` False) one shot:
    ⌈max_iterations/``chunk``⌉·``chunk`` gather-sampled hypotheses scored
    at once. ``two_stage`` (True, or 'auto' with n ≥ 32,768 rows) replaces
    both: the one shot's hypotheses estimated on 16,384 rows drawn with
    replacement from the valid ones, the best 1,024 rescored exactly.

    ``sampling`` draws the chunked route's samples: 'rotation' (gather-
    free; needs ``hyp_chunk`` ≥ n), 'gather' (three independent valid-row
    draws per hypothesis), 'auto' rotation for ``hyp_chunk`` ≥ n ≥ 2,048.
    The one-shot and two-stage routes always gather.

    ``corr_mode`` 'auto' or 'subsample' with n ≥ 2·``corr_cap``: exact
    correspondences for the strided ``corr_cap``-row subset of the source
    (row k·stride, ``decimation_stride``), which the hypotheses are drawn
    from and scored on; fitness normalises by the subset's valid count.
    'exact' matches every source row."""
    if draws is None:
        draws = torch_draws(seed)
    v32 = np.float32(voxel_size)
    thr2 = float((v32 * np.float32(1.5)) ** 2)  # strict < on err²
    n = source.capacity
    if hyp_chunk == "auto":
        hyp_chunk = hypothesis_chunk(max_iterations)
    src_pts = source.points
    src_mask = source.mask
    src_desc = source_features.descriptors
    if corr_mode in ("subsample", "auto") and n >= 2 * corr_cap:
        stride = decimation_stride(n, corr_cap)
        src_pts, src_mask, src_desc = (
            x[: stride * corr_cap : stride]
            for x in (src_pts, src_mask, src_desc)
        )
        n = corr_cap
    h_total = -(-max_iterations // chunk) * chunk
    finalists = min(1024, h_total)
    if two_stage == "auto":
        two_stage = n >= 2 * SUB_N and h_total > 4 * finalists
    # 'auto' is truthy: the early exit runs unless early_exit is False.
    use_chunked = (bool(early_exit) and not two_stage
                   and max_iterations > hyp_chunk)
    if sampling == "auto":
        use_rotation = use_chunked and hyp_chunk >= n >= 2048
    elif sampling == "rotation":
        use_rotation = use_chunked and hyp_chunk >= n
    else:
        use_rotation = False

    n_valid = max(host_read("ransac.n_valid", src_mask.sum(), float), 1.0)
    count = max(int(n_valid), 1)
    with span("ransac.correspondences"):
        corr = feature_correspondences(
            FPFHFeatures(src_desc, src_mask), target_features
        )
    p = src_pts.to(torch.float32)
    q = target.points[corr.long()].to(torch.float32)
    feat_t, pq_norm = build_scoring_factors(p, q, src_mask)
    pq_packed = torch.cat([p, q], dim=1)
    with span("ransac.sampler"):
        if use_rotation:
            pq2p = build_rotation_table(pq_packed, src_mask, count)
            # Every chunk consumes the same number of iterations at the
            # cloud's valid fraction: bound the loop by the chunks the
            # budget needs.
            cons = (hyp_chunk // n) * count + min(hyp_chunk % n, count)
            n_chunks_bound = (max_iterations + cons - 1) // max(cons, 1)
        else:
            perm = torch.sort((~src_mask).to(torch.int8), stable=True)[1]
            n_chunks_bound = -(-max_iterations // hyp_chunk)

    def one_shot_sample():
        """(w16t, t_norm, disabled) of the ``h_total`` gather-sampled
        hypotheses of the one-shot draw (chunk None)."""
        return solve_gather(draws.triples(None, h_total, count), 0, perm,
                            pq_packed, max_iterations)

    if two_stage:
        with span("ransac.two_stage"):
            rows = perm[draws.rows(SUB_N, count).to(perm.device)]
            bf, bw = _two_stage(one_shot_sample(), feat_t, pq_norm, rows,
                                thr2, n_valid, confidence, finalists)
        count_event("ransac.runs.two_stage")
        count_event("ransac.hypotheses", h_total)
    elif not use_chunked:
        with span("ransac.one_shot"):
            bf, bw = _one_shot(one_shot_sample(), feat_t, pq_norm, thr2,
                               n_valid, confidence)
        count_event("ransac.runs.one_shot")
        count_event("ransac.hypotheses", h_total)
    else:
        sampler = ((pq2p, cons) if use_rotation else (perm, pq_packed))
        bf, bw = _chunks(draws, use_rotation, sampler, hyp_chunk,
                         n_chunks_bound,
                         max_iterations, confidence, thr2, n, count, n_valid,
                         est_cap, p, q, src_mask, feat_t, pq_norm)
    with span("ransac.rescore"):
        best_R = bw[6:15].reshape(3, 3)
        best_t = bw[3:6]
        return _rescore(p, q, src_mask, best_R, best_t, bf, thr2, n_valid)


def _one_shot(sampled, feat_t, pq_norm, thr2, n_valid, confidence):
    """Every hypothesis scored at once: (best fitness, best w16 column)."""
    w16t, t_norm, disabled = sampled
    h_total = w16t.shape[1]
    cnt, _ = score_hypotheses(feat_t, pq_norm, w16t, t_norm, thr2)
    fitness = torch.where(disabled, -1.0, cnt / n_valid)
    exceed = fitness > confidence
    first = torch.argmax(exceed.to(torch.int8))  # first True
    cutoff = torch.where(exceed.any(), first, h_total - 1)
    h_ids = torch.arange(h_total, device=w16t.device)
    masked = torch.where(h_ids <= cutoff, fitness, -2.0)
    best = torch.argmax(masked, dim=0, keepdim=True)  # first of equals
    return fitness[best][0], w16t[:, best][:, 0]


def _two_stage(sampled, feat_t, pq_norm, rows, thr2, n_valid, confidence,
               finalists):
    """Stage 1 estimates every hypothesis on the drawn ``rows`` (fitness
    over their number), with the early-exit prefix on the estimates;
    stage 2 scores the best ``finalists`` exactly. (best fitness, best w16
    column)."""
    w16t, t_norm, disabled = sampled
    h_total = w16t.shape[1]
    cnt1, _ = score_hypotheses(feat_t[:, rows].contiguous(), pq_norm[rows],
                               w16t, t_norm, thr2)
    fit1 = torch.where(disabled, -1.0, cnt1 / rows.shape[0])
    exceed = fit1 > confidence
    first = torch.argmax(exceed.to(torch.int8))  # first True
    cutoff = torch.where(exceed.any(), first, h_total - 1)
    h_ids = torch.arange(h_total, device=w16t.device)
    fit1 = torch.where(h_ids <= cutoff, fit1, -2.0)
    # lax.top_k order: descending, ties lowest index first.
    top = torch.sort(fit1, descending=True, stable=True)[1][:finalists]
    cnt2, _ = score_hypotheses(feat_t, pq_norm, w16t[:, top].contiguous(),
                               t_norm[top], thr2)
    fit2 = torch.where(fit1[top] <= -1.0, -1.0, cnt2 / n_valid)
    best = torch.argmax(fit2, dim=0, keepdim=True)  # first of equals
    return fit2[best][0], w16t[:, top[best]][:, 0]


# The chunked route on the card replays one CUDA graph a chunk (K10 or
# K11 → K6 estimate → top-32 → K6 exact → champion → exit flag); False
# runs the same body eagerly, launch by launch.
CHUNK_GRAPH = True
_GRAPH_CACHE_SIZE = 8
_graphs: dict = {}
_graphs_lock = threading.Lock()


class _ChunkBody:
    """One chunk of the chunked route on a fixed set of tensors: the
    scoring inputs, the sampler's (the rotation table ``pq2p``, or
    ``perm`` and ``pq_packed``) and its int32 ``params`` (K10's epoch
    offsets, or K11's first id, budget and triples), the running best
    (``bf``, ``br``, ``bw``) and the exit flag ``any_ex``. :meth:`step`
    reads nothing back to the host, so :meth:`chunk_step` can be captured
    in a CUDA graph (:meth:`replay`); the graph's copy keeps static inputs
    and a call copies its own into them. ``rotation`` says which sampler's
    kernel :meth:`chunk_step` launches."""

    def __init__(self, rotation, h, use_est, k_fin, thr2, confidence,
                 device):
        self.rotation = rotation
        self.h, self.use_est, self.k_fin = h, use_est, k_fin
        self.thr2, self.confidence = thr2, confidence
        self.h_ids = torch.arange(h, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.bf = torch.zeros((), **f32)
        self.br = torch.zeros((), **f32)
        self.bw = torch.zeros((16,), **f32)
        self.any_ex = torch.zeros((), dtype=torch.bool, device=device)
        self.inputs: dict[str, torch.Tensor] = {}
        self.graph = None
        self.replay_launches: list = []
        self.lock = threading.Lock()

    def bind(self, **tensors):
        self.inputs = tensors

    def load(self, **tensors):
        """Copy a call's inputs into the static ones (allocated at first)."""
        if not self.inputs:
            self.inputs = {k: torch.empty_like(v) for k, v in tensors.items()}
            self.params_host = torch.empty(
                tensors["params"].shape, dtype=torch.int32, pin_memory=True)
        for k, v in tensors.items():
            if k != "params":
                self.inputs[k].copy_(v)

    def reset(self):
        """bf = br = 0 and bw the identity's column."""
        self.bf.zero_()
        self.br.zero_()
        self.bw.zero_()
        self.bw[6:15:4] = 1.0

    def step(self, w16t, t_norm, disabled):
        """Score a chunk's hypotheses and fold its champion into the
        running best, with no host read."""
        x, h = self.inputs, self.h
        if self.use_est:
            cnt, _ = score_hypotheses(x["feat_e"], x["pq_e"], w16t, t_norm,
                                      self.thr2)
            fitness = torch.where(disabled, -1.0, cnt / x["n_valid"][0])
        else:
            cnt, errsum = score_hypotheses(x["feat_t"], x["pq_norm"], w16t,
                                           t_norm, self.thr2)
            fitness = torch.where(disabled, -1.0, cnt / x["n_valid"][1])
        exceed = fitness > self.confidence
        any_ex = exceed.any()
        first = torch.argmax(exceed.to(torch.int8))  # first True
        cutoff = torch.where(any_ex, first, h - 1)
        mf = torch.where(self.h_ids <= cutoff, fitness, -2.0)
        if self.use_est:
            # lax.top_k order: descending, ties lowest index first.
            topk = torch.sort(mf, descending=True, stable=True)[1][
                :self.k_fin]
            cnt_x, err_x = score_hypotheses(
                x["feat_t"], x["pq_norm"], w16t[:, topk].contiguous(),
                t_norm[topk], self.thr2)
            fit_x = torch.where(mf[topk] <= -1.0, mf[topk],
                                cnt_x / x["n_valid"][1])
            # Indices stay (1,) tensors: indexing with a 0-d tensor would
            # read it back to the host.
            bi = torch.argmax(fit_x, dim=0, keepdim=True)
            lb, lf, lc, le = topk[bi], fit_x[bi], cnt_x[bi], err_x[bi]
        else:
            # first of equals == strict >
            lb = torch.argmax(mf, dim=0, keepdim=True)
            lf, lc, le = mf[lb], cnt[lb], errsum[lb]
        lf, lc, le = lf[0], lc[0], le[0]
        lr = torch.where(
            lc > 0, torch.sqrt(le / torch.clamp_min(lc, 1.0)), 999.0)
        better = lf > self.bf  # strict: the earliest chunk keeps ties
        self.br.copy_(torch.where(better, lr, self.br))
        self.bw.copy_(torch.where(better, w16t[:, lb][:, 0], self.bw))
        self.bf.copy_(torch.where(better, lf, self.bf))
        self.any_ex.copy_(any_ex)

    def rotation_step(self):
        x = self.inputs
        self.step(*rotation_hypotheses(x["pq2p"], x["params"], self.h))

    def gather_step(self):
        x = self.inputs
        self.step(*gather_hypotheses(x["params"], x["perm"], x["pq_packed"],
                                     self.h))

    def chunk_step(self):
        """The chunk's hypotheses by its sampler's kernel, then
        :meth:`step`."""
        if self.rotation:
            self.rotation_step()
        else:
            self.gather_step()

    def replay(self, params):
        """The chunk with these int32 params (a list, or a host tensor), as
        one graph replay (captured at the first call, after one eager
        warm-up chunk)."""
        if torch.is_tensor(params):
            self.params_host.copy_(params)
        else:
            self.params_host.numpy()[:] = params
        self.inputs["params"].copy_(self.params_host, non_blocking=True)
        with on_device(self.bf.device):
            if self.graph is None:
                self._capture()
            self.graph.replay()
        for wrapper, k in self.replay_launches:
            build.count_launch(wrapper, k)

    def _capture(self):
        count_event("ransac.graph_captures")
        # The warm-up is a real chunk (counted); the capture starts from
        # the reset best.
        self.graph, _, self.replay_launches = build.capture_graph(
            self.chunk_step, self.bf.device, prepare=self.reset)


def _graph_body(key, make) -> _ChunkBody:
    with _graphs_lock:
        body = _graphs.pop(key, None) or make()
        _graphs[key] = body  # most recent last
        while len(_graphs) > _GRAPH_CACHE_SIZE:
            _graphs.pop(next(iter(_graphs)))
        return body


def _chunks(draws, rotation, sampler, hyp_chunk, n_chunks_bound,
            max_iterations, confidence, thr2, n, count, n_valid, est_cap, p,
            q, src_mask, feat_t, pq_norm):
    """Chunks of ``hyp_chunk`` hypotheses until one exceeds ``confidence``
    or the budget is spent: (best fitness, best w16 column). ``sampler``
    is (the plane table, ids a chunk consumes) when ``rotation``, else
    (perm, pq_packed) for the gather sampler. The only host read is the
    exit flag, once a chunk; on the card either route replays one CUDA
    graph a chunk (:data:`CHUNK_GRAPH`). Counts the run by its sampler,
    its chunks, the iterations they consumed and whether it stopped on
    ``confidence`` before the budget and the bound."""
    device = p.device
    use_est = n >= 2 * est_cap
    k_fin = min(32, hyp_chunk)
    inputs = dict(feat_t=feat_t, pq_norm=pq_norm)
    n_valid_e = 1.0
    if use_est:
        m_e = strided_rows(src_mask, est_cap)
        inputs["feat_e"], inputs["pq_e"] = build_scoring_factors(
            strided_rows(p, est_cap), strided_rows(q, est_cap), m_e)
        n_valid_e = max(host_read("ransac.n_valid", m_e.sum(), float), 1.0)
    inputs["n_valid"] = torch.tensor([n_valid_e, n_valid],
                                     dtype=torch.float32, device=device)
    use_graph = device.type == "cuda" and CHUNK_GRAPH
    if rotation:
        pq2p, cons = sampler
        inputs["pq2p"] = pq2p
        n_ep = -(-hyp_chunk // (pq2p.shape[1] // 2))
        n_params = 3 + 3 * n_ep
    else:
        inputs["perm"], inputs["pq_packed"] = sampler
        n_params = 2 + 3 * hyp_chunk
    inputs["params"] = torch.empty(n_params, dtype=torch.int32,
                                   device=device)

    def make():
        return _ChunkBody(rotation, hyp_chunk, use_est, k_fin, thr2,
                          confidence, device)

    if use_graph:
        key = (device, rotation, hyp_chunk, use_est, k_fin, thr2,
               confidence,
               *((k, tuple(v.shape)) for k, v in sorted(inputs.items())))
        body = _graph_body(key, make)
        body.lock.acquire()
    else:
        body = make()
    try:
        if use_graph:
            body.load(**inputs)
        else:
            body.bind(**inputs)
        body.reset()
        fid, done, c = 0, False, 0
        # Chunk 1 always runs (the JAX peel); later chunks while the
        # budget, the bound and the early exit allow (count < 3 disables
        # every rotation triple).
        while c == 0 or (
            c < n_chunks_bound and fid < max_iterations and not done
            and (count >= 3 or not rotation)
        ):
            with span("ransac.chunk"):
                if rotation:
                    prm = epoch_params(lambda e: draws(c, e), n_ep, fid,
                                       count, max_iterations)
                    n_cons = cons
                else:
                    # Pinned when copied straight to the card; a replay
                    # copies it into the body's own pinned buffer.
                    prm = gather_params(
                        draws.triples(c, hyp_chunk, count), fid,
                        max_iterations, sampler[0].shape[0],
                        pin=device.type == "cuda" and not use_graph)
                    n_cons = hyp_chunk
                if use_graph:
                    body.replay(prm)
                else:
                    body.inputs["params"] = torch.as_tensor(
                        prm, dtype=torch.int32).to(device, non_blocking=True)
                    body.chunk_step()
                # The chunk's one device→host read.
                done = host_read("ransac.exit_flag", body.any_ex, bool)
            fid += n_cons
            c += 1
        count_event("ransac.runs.chunked."
                    + ("rotation" if rotation else "gather"))
        count_event("ransac.chunks", c)
        count_event("ransac.hypotheses", fid)
        if done and c < n_chunks_bound and fid < max_iterations:
            count_event("ransac.early_exits")
        return body.bf.clone(), body.bw.clone()
    finally:
        if use_graph:
            body.lock.release()


def _rescore(p, q, src_mask, best_R, best_t, bf, thr2, n_valid):
    """The result at the winner; identity with fitness 0 when no hypothesis
    won."""
    device = p.device
    # Direct rescore of the single winner: the reported fitness/rmse come
    # from the plain residual, not the rank-16 expansion.
    dr = p @ best_R.T + best_t - q
    err2_d = (dr * dr).sum(1)
    inl_d = src_mask & (err2_d < thr2)
    cnt_d = inl_d.to(torch.float32).sum()
    won = (bf > 0.0) & (cnt_d > 0)
    fit_d = cnt_d / n_valid
    rmse_d = torch.where(
        cnt_d > 0,
        torch.sqrt(
            torch.where(inl_d, err2_d, 0.0).sum() / torch.clamp_min(cnt_d, 1.0)
        ),
        999.0,
    )
    T = make_transform(best_R, best_t)
    eye = torch.eye(4, dtype=torch.float32, device=device)
    return RegistrationResult(
        transformation=torch.where(won, T, eye),
        fitness=torch.where(won, fit_d, 0.0),
        rmse=torch.where(won, rmse_d, 0.0),
    )
