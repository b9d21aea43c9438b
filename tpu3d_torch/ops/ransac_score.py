"""K6: fused RANSAC hypothesis scoring — CUDA kernel and plain version.

Counterpart of ``tpu3d/ops/ransac_pallas.py`` (``score_hypotheses_pallas``)
and of the chunked XLA path of ``tpu3d/ops/ransac.py`` ``score_w16``. For
hypothesis h: err² = F·W_h + pq + ‖t_h‖² over N rows, inliers by the
strict err² < thr², returning (inlier count, Σ max(err², 0) over inliers)
as f32[H] each. The kernel lives in ``csrc/ransac_score.cu``: 3xTF32 on
the tensor cores, split over hypotheses and row slices (:func:`slice_plan`),
with elements inside the rounding band of thr² (:func:`band_margin`)
queued per lane and recomputed in fp32 as the plain version computes
them, so the inlier sets are the fp32 ones.
"""

from __future__ import annotations

import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel, on_device

# Hypotheses per (N, chunk) err² block in the plain version.
_PLAIN_CHUNK = 512

# The kernel's shapes (csrc/ransac_score.cu).
HYP_TILE = 128  # hypotheses per block
MIN_BLOCKS = 2 * 132  # two waves of blocks on an H100's 132 SMs
# An element whose 3xTF32 err² lies within BAND·(pq + 2)(‖t‖² + 3) of thr²
# is recomputed in fp32: (pq + 2)(‖t‖² + 3) bounds Σ|F_k W_k| + pq + ‖t‖²,
# and 2^-19 is about ten times the largest 3xTF32-against-fp32 difference
# measured on the bench pair's scoring factors (tests/test_torch_ransac.py).
BAND = 2.0 ** -19


def slice_plan(n: int, h: int) -> tuple[int, int]:
    """(rows_per_slice, slices) of the kernel's grid for N rows and H
    hypotheses: slices of 32 to 256 rows (a multiple of 32), as short as
    it takes for the grid of (hypothesis tiles × slices) blocks to reach
    ``MIN_BLOCKS``."""
    h_tiles = max(1, -(-h // HYP_TILE))
    want = -(-MIN_BLOCKS // h_tiles)
    rows = -(-max(n, 1) // want)
    rows = min(256, max(32, -(-rows // 32) * 32))
    return rows, -(-n // rows)


def band_margin(pq_norm: torch.Tensor, t_norm: torch.Tensor) -> torch.Tensor:
    """(N, H) half-width of the band around thr² inside which the kernel
    recomputes err² in fp32: (BAND·(pq + 2))·(‖t‖² + 3), rounded as the
    kernel rounds it."""
    return (BAND * (pq_norm[:, None] + 2.0)) * (t_norm[None, :] + 3.0)


def score_hypotheses_plain(feat_t, pq_norm, w16t, t_norm, thr2):
    """Plain PyTorch scoring, chunked over hypotheses so the err² block
    stays small."""
    cnt_parts, err_parts = [], []
    ft = feat_t.T
    for s in range(0, w16t.shape[1], _PLAIN_CHUNK):
        e = s + _PLAIN_CHUNK
        err2 = ft @ w16t[:, s:e] + pq_norm[:, None]
        err2 = err2 + t_norm[None, s:e]
        inl = err2 < thr2
        cnt_parts.append(inl.to(torch.float32).sum(0))
        err_parts.append(
            torch.where(inl, torch.clamp_min(err2, 0.0), 0.0).sum(0)
        )
    return torch.cat(cnt_parts), torch.cat(err_parts)


def score_hypotheses(
    feat_t: torch.Tensor,  # f32[16, N] point factors, K-major
    pq_norm: torch.Tensor,  # f32[N] ‖p‖²+‖q‖² (1e30 on invalid rows)
    w16t: torch.Tensor,  # f32[16, H] hypothesis factors, K-major
    t_norm: torch.Tensor,  # f32[H] ‖t_h‖²
    thr2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(inlier_count f32[H], err2_sum f32[H]); CUDA tensors launch the
    kernel, CPU tensors take the plain version."""
    if feat_t.ndim != 2 or feat_t.shape[0] != 16 or w16t.shape[0] != 16:
        raise ValueError("feat_t and w16t must be (16, N) and (16, H)")
    n, h = feat_t.shape[1], w16t.shape[1]
    if pq_norm.shape != (n,) or t_norm.shape != (h,):
        raise ValueError("pq_norm must be (N,) and t_norm (H,)")
    if not launches_kernel(feat_t, pq_norm, w16t, t_norm):
        return score_hypotheses_plain(feat_t, pq_norm, w16t, t_norm, thr2)
    ins = [x.contiguous() for x in (feat_t, pq_norm, w16t, t_norm)]
    if any(x.dtype != torch.float32 for x in ins):
        raise TypeError("score_hypotheses kernel takes float32 inputs")
    dev = feat_t.device
    rows, slices = slice_plan(n, h)
    # One allocation: counts, sums, then the (slices, H) partials, i32
    # counts and f32 sums, addressed by offset (fewer host-side views).
    out = torch.empty((2 + 2 * slices) * h, dtype=torch.float32, device=dev)
    base = out.data_ptr()
    with on_device(dev):
        rc = build.library().tpu3d_ransac_score(
            *(x.data_ptr() for x in ins), n, h, rows, slices, float(thr2),
            BAND, base + 4 * (2 + slices) * h, base + 8 * h, base,
            base + 4 * h, torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(rc, "tpu3d_ransac_score")
    build.count_launch(score_hypotheses)
    return out[:h], out[h:2 * h]


score_hypotheses.launches = 0
