"""K5: top-1 nearest neighbour — CUDA kernel and its plain version.

Counterpart of ``tpu3d/ops/nn_pallas.py`` (``nearest_neighbor``,
``nearest_neighbor_pallas``) and of ``tpu3d/ops/neighbors.py``
``nearest_neighbor_xla``: for each query, the valid target at the least
squared distance, computed as e = ‖t‖² − 2t·s with a running argmin (ties
to the lowest index) and returned as d² = max(e + ‖s‖², 0). Invalid
targets take the 1e6 sentinel coordinate. The kernels live in
``csrc/nn.cu``: D ≤ 4 (brute ICP) on the CUDA cores in fp32; 4 < D ≤ 36
(the FPFH descriptors) on the tensor cores in 3xTF32, over the packed
operands of :func:`descriptor_queries` and :func:`descriptor_targets`
(the latter built once per target set by the caller that has one),
split over targets
(:func:`split_plan`) and reduced by the rule of :func:`reduce_splits_plain`.
"""

from __future__ import annotations

import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel, on_device

_SENTINEL = 1.0e6
_MAX_D = 36
_MAX_D_FP32 = 4  # D at most this takes the fp32 kernel
_PLAIN_CHUNK = 2048  # query rows per matmul in the plain version

# The descriptor kernel's shapes (csrc/nn.cu).
PACKED_K = 40  # [t | ‖t‖² | 0] and [−2q | 1 | 0]: five k-steps of 8
PAD_NORM = 1.0e30  # the norm of padded target rows: they never win
Q_TILE = 256  # queries per block
T_TILE = 128  # target rows per pipeline stage
# Splits are picked so the grid holds about this many blocks (16 a SM on
# 132 SMs: two resident blocks per SM, eight waves), each split at least
# MIN_SPLIT_TILES target tiles long.
TARGET_BLOCKS = 16 * 132
MIN_SPLIT_TILES = 4


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


def descriptor_queries(queries: torch.Tensor) -> torch.Tensor:
    """The descriptor kernel's query operand [−2q | 1 | 0] f32[Qp, 40], Qp
    rounding Q up to the query tile (padded rows zero), as the Pallas
    wrapper builds it (``nn_pallas.py``)."""
    q, d = queries.shape
    if d + 1 > PACKED_K:
        raise ValueError(f"D {d} does not fit the packed width {PACKED_K}")
    qop = queries.new_zeros((-(-q // Q_TILE) * Q_TILE, PACKED_K),
                            dtype=torch.float32)
    qop[:q, :d] = -2.0 * queries.float()
    qop[:q, d] = 1.0
    return qop


def descriptor_targets(
    targets: torch.Tensor, target_mask: torch.Tensor
) -> torch.Tensor:
    """The descriptor kernel's target operand [t | ‖t‖² | 0] f32[Mp, 40],
    as the Pallas wrapper builds it, so that one contraction with the
    query operand gives e = ‖t‖² − 2t·q. Masked targets take the 1e6
    sentinel coordinate; padded rows (Mp rounds M up to the target tile)
    are zero with the ``PAD_NORM`` norm. It depends on the targets alone:
    build it once per target set and pass it to every
    :func:`nearest_neighbor` against them (``packed_targets``)."""
    m, d = targets.shape
    if d + 1 > PACKED_K:
        raise ValueError(f"D {d} does not fit the packed width {PACKED_K}")
    # Written in place (168 MB at a million rows), each column once.
    top = targets.new_empty((-(-m // T_TILE) * T_TILE, PACKED_K),
                            dtype=torch.float32)
    tgt = top[:m, :d]
    sentinel = torch.full((), _SENTINEL, device=targets.device)
    torch.where(target_mask[:, None], targets.float(), sentinel, out=tgt)
    torch.sum(tgt * tgt, 1, out=top[:m, d])
    top[:m, d + 1:] = 0.0
    top[m:] = 0.0
    top[m:, d] = PAD_NORM
    return top


def split_plan(q: int, m: int) -> tuple[int, int]:
    """(tiles_per_split, splits) of the descriptor kernel's grid for Q
    queries and M targets: enough splits that the grid of (query tiles ×
    splits) blocks reaches ``TARGET_BLOCKS``, each split at least
    ``MIN_SPLIT_TILES`` target tiles, none empty."""
    q_tiles = max(1, -(-q // Q_TILE))
    m_tiles = -(-m // T_TILE)
    want = min(-(-TARGET_BLOCKS // q_tiles), max(1, m_tiles // MIN_SPLIT_TILES))
    per = -(-m_tiles // max(want, 1))
    return per, -(-m_tiles // per)


def reduce_splits_plain(
    part_e: torch.Tensor,  # f32[S, Q] each split's least e
    part_i: torch.Tensor,  # i32[S, Q] and its row
    q_norm: torch.Tensor,  # f32[Q] ‖q‖²
) -> tuple[torch.Tensor, torch.Tensor]:
    """The descriptor kernel's second pass in plain PyTorch: the splits in
    ascending order, a later split taking over only on a strictly smaller
    e (splits cover ascending target ranges, so ties keep the lower row),
    then d² = max(e + ‖q‖², 0)."""
    best, idx = part_e[0].clone(), part_i[0].clone()
    for s in range(1, part_e.shape[0]):
        better = part_e[s] < best
        best = torch.where(better, part_e[s], best)
        idx = torch.where(better, part_i[s], idx)
    return idx, torch.clamp_min(best + q_norm, 0.0)


def _fp32_kernel(queries, targets, target_mask):
    q, d = queries.shape
    m = targets.shape[0]
    mask_u8 = target_mask.to(torch.uint8).contiguous()
    idx = torch.empty((q,), dtype=torch.int32, device=queries.device)
    d2 = torch.empty((q,), dtype=torch.float32, device=queries.device)
    with on_device(queries.device):
        err = build.library().tpu3d_nn_top1(
            queries.data_ptr(), targets.data_ptr(), mask_u8.data_ptr(),
            q, m, d, idx.data_ptr(), d2.data_ptr(),
            torch.cuda.current_stream(queries.device).cuda_stream,
        )
    build.check(err, "tpu3d_nn_top1")
    return idx, d2


def descriptor_top1(queries, qop, top, m):
    """Launch the descriptor kernel (and its split reduction) on packed
    operands for M targets; returns (idx i32[Q], d2 f32[Q])."""
    queries = queries.contiguous()  # the reduction reads ‖q‖² from it
    q, d = queries.shape
    per, splits = split_plan(q, m)
    dev = queries.device
    qp = qop.shape[0]
    # One allocation: d2, idx, then the (splits, Qp) partials.
    d2, idx, part_e, part_i = torch.empty(
        2 * q + 2 * splits * qp, dtype=torch.float32, device=dev,
    ).split([q, q, splits * qp, splits * qp])
    idx, part_i = idx.view(torch.int32), part_i.view(torch.int32)
    with on_device(dev):
        err = build.library().tpu3d_nn_desc_top1(
            qop.data_ptr(), top.data_ptr(), queries.data_ptr(), q, d,
            qp, top.shape[0] // T_TILE, per, splits,
            part_e.data_ptr(), part_i.data_ptr(), idx.data_ptr(), d2.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(err, "tpu3d_nn_desc_top1")
    return idx, d2


def nearest_neighbor(
    queries: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    packed_targets: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 nearest valid target per query: (idx i32[Q], d2 f32[Q]).

    queries f32[Q, D], targets f32[M, D], target_mask bool[M], D ≤ 36.
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    ``packed_targets``: :func:`descriptor_targets` of these targets, built
    once per target set, which the D > 4 kernel then uses instead of
    packing the targets again (the other routes ignore it)."""
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
    d = queries.shape[1]
    if d > _MAX_D:
        raise ValueError(f"nearest_neighbor kernel takes D <= {_MAX_D}, got {d}")
    if queries.dtype != torch.float32 or targets.dtype != torch.float32:
        raise TypeError("nearest_neighbor kernel takes float32 inputs")
    if targets.shape[0] == 0:
        raise ValueError("nearest_neighbor kernel needs at least one target")
    queries = queries.contiguous()
    targets = targets.contiguous()
    if d <= _MAX_D_FP32:
        out = _fp32_kernel(queries, targets, target_mask)
    else:
        m = targets.shape[0]
        if packed_targets is None:
            packed_targets = descriptor_targets(targets, target_mask)
        elif (packed_targets.shape != (-(-m // T_TILE) * T_TILE, PACKED_K)
              or packed_targets.dtype != torch.float32
              or packed_targets.device != queries.device
              or not packed_targets.is_contiguous()):
            raise ValueError("packed_targets is not descriptor_targets of "
                             "these targets")
        out = descriptor_top1(queries, descriptor_queries(queries),
                              packed_targets, m)
    build.count_launch(nearest_neighbor)
    return out


nearest_neighbor.launches = 0
