"""Exact k-nearest-neighbour search as chunked matmul + stable sort.

Counterpart of ``tpu3d/ops/neighbors.py`` (``pairwise_sqdist``, ``knn``
with ``method='exact'``). The top-1 search (``nearest_neighbor_xla``) has
its counterpart beside its CUDA kernel, in :mod:`tpu3d_torch.ops.nn`.
"""

from __future__ import annotations

import torch

_BIG = 1e30


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances (Q, D) x (M, D) -> (Q, M) by the expansion
    ‖a‖² − 2a·b + ‖b‖², clamped at 0 to absorb cancellation."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    cross = a @ b.T
    d2 = (a * a).sum(-1)[:, None] - 2.0 * cross + (b * b).sum(-1)[None, :]
    return torch.clamp_min(d2, 0.0)


def knn(
    queries: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    k: int,
    chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest targets per query: (idx i32[Q, k], d2 f32[Q, k]) ascending.

    Ties go to the lowest target index, as ``lax.top_k`` orders them: a
    stable ascending sort, then a slice (``torch.topk`` does not promise
    the tie order). Invalid targets sit at +1e30; with fewer than k
    targets the extra slots are index 0 at 1e30."""
    invalid = torch.where(target_mask, 0.0, _BIG).to(torch.float32)
    m = targets.shape[0]
    k_eff = min(k, m)
    idx_parts, d2_parts = [], []
    for s in range(0, queries.shape[0], chunk):
        d2 = pairwise_sqdist(queries[s:s + chunk], targets) + invalid[None, :]
        d2s, order = torch.sort(d2, dim=1, stable=True)
        idx_parts.append(order[:, :k_eff].to(torch.int32))
        d2_parts.append(d2s[:, :k_eff])
    idx = torch.cat(idx_parts)
    d2 = torch.cat(d2_parts)
    if k_eff < k:
        pad = k - k_eff
        idx = torch.nn.functional.pad(idx, (0, pad))
        d2 = torch.nn.functional.pad(d2, (0, pad), value=_BIG)
    return idx, d2
