"""K6: fused RANSAC hypothesis scoring — CUDA kernel and plain version.

Counterpart of ``tpu3d/ops/ransac_pallas.py`` (``score_hypotheses_pallas``)
and of the chunked XLA path of ``tpu3d/ops/ransac.py`` ``score_w16``. For
hypothesis h: err² = F·W_h + pq + ‖t_h‖² over N rows, inliers by the
strict err² < thr², returning (inlier count, Σ max(err², 0) over inliers)
as f32[H] each. The kernel lives in ``csrc/ransac_score.cu``.
"""

from __future__ import annotations

import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel

# Hypotheses per (N, chunk) err² block in the plain version.
_PLAIN_CHUNK = 512


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
    cnt = torch.empty((h,), dtype=torch.float32, device=feat_t.device)
    err = torch.empty((h,), dtype=torch.float32, device=feat_t.device)
    rc = build.library().tpu3d_ransac_score(
        *(x.data_ptr() for x in ins), n, h, float(thr2),
        cnt.data_ptr(), err.data_ptr(),
        torch.cuda.current_stream(feat_t.device).cuda_stream,
    )
    build.check(rc, "tpu3d_ransac_score")
    build.count_launch(score_hypotheses)
    return cnt, err


score_hypotheses.launches = 0
