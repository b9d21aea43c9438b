"""Torch emulations of the tensor-core kernels' arithmetic, for the CPU
tests: TF32 rounding, the 3xTF32 product, K5's descriptor route (packed
operands, per-split argmin, the split reduction) and K6's scorer (3xTF32
with the fp32 re-check inside the band around thr²).

TF32 keeps 10 explicit mantissa bits: ``cvt.rna.tf32.f32`` rounds to
nearest with ties away from zero, which on the bit pattern is adding half
of the 13 dropped bits' weight and clearing them. The products of two TF32
values are exact in fp32 (22 significant bits), so fp32 matmuls of the
hi/lo planes give what the tensor cores sum, up to the order of the sums.
"""

import torch

from tpu3d_torch.ops import nn, ransac_score


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (nearest, ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32(x - hi)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (R, K) · b (C, K)ᵀ as the kernels form it: hi·hi + (hi·lo + lo·hi)."""
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh.T + (ah @ bl.T + al @ bh.T)


def nn_3xtf32(queries, targets, mask):
    """K5's descriptor route: (idx i32[Q], d2 f32[Q]) over the split plan."""
    qop, top = nn.descriptor_queries(queries), nn.descriptor_targets(targets,
                                                                     mask)
    q, m = queries.shape[0], targets.shape[0]
    per, splits = nn.split_plan(q, m)
    e = product_3xtf32(qop[:q], top)
    span = per * nn.T_TILE
    part_e, part_i = [], []
    for s in range(splits):
        blk = e[:, s * span:(s + 1) * span]
        part_e.append(blk.amin(1))
        part_i.append((blk.argmin(1) + s * span).to(torch.int32))
    qn = (queries.float() * queries.float()).sum(1)
    return nn.reduce_splits_plain(torch.stack(part_e), torch.stack(part_i),
                                  qn)


def fma_sequential(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (R, K) · b (K, C) in fp32, one fused multiply-add per k in order
    (the product is exact in float64; each step rounds once to fp32)."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(a.shape[1]):
        acc = (acc.double() + a[:, k:k + 1].double() * b[k:k + 1].double()
               ).float()
    return acc


def score_3xtf32(feat_t, pq, w16t, tn, thr2, band=True):
    """K6: (count f32[H], err sum f32[H], 3xTF32 err² (N, H), fp32 err²
    (N, H)). With ``band``, elements within ``band_margin`` of thr² take
    the fp32 value, as the kernel recomputes them."""
    e_tc = (product_3xtf32(feat_t.T, w16t.T) + pq[:, None]) + tn[None, :]
    e_32 = (fma_sequential(feat_t.T, w16t) + pq[:, None]) + tn[None, :]
    e = e_tc
    if band:
        near = (e_tc - thr2).abs() <= ransac_score.band_margin(pq, tn)
        e = torch.where(near, e_32, e_tc)
    inl = e < thr2
    cnt = inl.float().sum(0)
    err = torch.where(inl, e.clamp_min(0.0), 0.0).sum(0)
    return cnt, err, e_tc, e_32
