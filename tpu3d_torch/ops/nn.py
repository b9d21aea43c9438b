"""K5: top-1 nearest neighbour — CUDA kernel and its plain version.

Counterpart of ``tpu3d/ops/nn_pallas.py`` (``nearest_neighbor``,
``nearest_neighbor_pallas``) and of ``tpu3d/ops/neighbors.py``
``nearest_neighbor_xla``: for each query, the valid target at the least
squared distance, computed as e = ‖t‖² − 2t·s with a running argmin (ties
to the lowest index) and returned as d² = max(e + ‖s‖², 0). Invalid
targets take the 1e6 sentinel coordinate. The kernel lives in
``csrc/nn.cu``.
"""

from __future__ import annotations

import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel

_SENTINEL = 1.0e6
_MAX_D = 36
_PLAIN_CHUNK = 2048  # query rows per matmul in the plain version


def nearest_neighbor_plain(
    queries: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Same selection as the kernel in plain PyTorch (chunked matmul)."""
    tgt = torch.where(target_mask[:, None], targets, _SENTINEL).float()
    tn = (tgt * tgt).sum(1)
    idx_parts, d2_parts = [], []
    for s in range(0, queries.shape[0], _PLAIN_CHUNK):
        qc = queries[s:s + _PLAIN_CHUNK].float()
        e = tn[None, :] + (-2.0 * qc) @ tgt.T
        emin = e.amin(dim=1)
        arg = torch.argmin(e, dim=1)  # first of equal minima
        idx_parts.append(arg.to(torch.int32))
        d2_parts.append(torch.clamp_min(emin + (qc * qc).sum(1), 0.0))
    return torch.cat(idx_parts), torch.cat(d2_parts)


def nearest_neighbor(
    queries: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 nearest valid target per query: (idx i32[Q], d2 f32[Q]).

    queries f32[Q, D], targets f32[M, D], target_mask bool[M], D ≤ 36.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if queries.ndim != 2 or targets.ndim != 2:
        raise ValueError("queries and targets must be 2-D")
    if queries.shape[1] != targets.shape[1]:
        raise ValueError(
            f"dimension mismatch {queries.shape[1]} vs {targets.shape[1]}"
        )
    if target_mask.shape != targets.shape[:1]:
        raise ValueError("target_mask must be (M,)")
    if not launches_kernel(queries, targets, target_mask):
        return nearest_neighbor_plain(queries, targets, target_mask)
    q, d = queries.shape
    m = targets.shape[0]
    if d > _MAX_D:
        raise ValueError(f"nearest_neighbor kernel takes D <= {_MAX_D}, got {d}")
    if queries.dtype != torch.float32 or targets.dtype != torch.float32:
        raise TypeError("nearest_neighbor kernel takes float32 inputs")
    queries = queries.contiguous()
    targets = targets.contiguous()
    mask_u8 = target_mask.to(torch.uint8).contiguous()
    idx = torch.empty((q,), dtype=torch.int32, device=queries.device)
    d2 = torch.empty((q,), dtype=torch.float32, device=queries.device)
    err = build.library().tpu3d_nn_top1(
        queries.data_ptr(), targets.data_ptr(), mask_u8.data_ptr(),
        q, m, d, idx.data_ptr(), d2.data_ptr(),
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    build.check(err, "tpu3d_nn_top1")
    build.count_launch(nearest_neighbor)
    return idx, d2


nearest_neighbor.launches = 0
