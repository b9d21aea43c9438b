"""Exact k-nearest-neighbour search as chunked matmul + a row-wise
k-smallest selection.

Counterpart of ``tpu3d/ops/neighbors.py`` (``pairwise_sqdist``, ``knn``,
``radius_capped_neighbors``). The top-1 search (``nearest_neighbor_xla``)
has its counterpart beside its CUDA kernel, in :mod:`tpu3d_torch.ops.nn`.
The selection on the card is K12 (``csrc/knn_select.cu``,
:func:`knn_select`); its plain version is a stable sort and a slice
(:func:`knn_select_plain`).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu3d_torch import build
from tpu3d_torch.device import launches_kernel, on_device

_BIG = 1e30
# The largest k K12 selects; a larger k keeps the stable sort.
KNN_SELECT_MAX_K = 128


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances (Q, D) x (M, D) -> (Q, M) by the expansion
    ‖a‖² − 2a·b + ‖b‖², clamped at 0 to absorb cancellation."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    cross = a @ b.T
    d2 = (a * a).sum(-1)[:, None] - 2.0 * cross + (b * b).sum(-1)[None, :]
    return torch.clamp_min(d2, 0.0)


METHODS = ("auto", "exact", "approx")


def check_method(method: str) -> None:
    """Raises on a ``method`` that is not one of :data:`METHODS` (what each
    means: :func:`knn`)."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")


def knn(
    queries: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    k: int,
    chunk: int = 1024,
    method: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest targets per query: (idx i32[Q, k], d2 f32[Q, k]) ascending.

    Ties go to the lowest target index, as ``lax.top_k`` orders them: each
    chunk's rows go through :func:`knn_select`, a stable ascending sort
    and a slice or K12's selection of the same pairs (``torch.topk`` does
    not promise the tie order). Invalid targets sit at +1e30; with fewer
    than k targets the extra slots are index 0 at 1e30.

    ``method``: 'auto' and 'exact' are this exact search. 'approx' names
    the TPU's ``approx_max_k`` partial reduction in the JAX package; there
    is none here, so it takes the exact search too. Any other value
    raises ValueError; the searches that take ``method`` pass it here or
    check it the same way."""
    check_method(method)
    invalid = torch.where(target_mask, 0.0, _BIG).to(torch.float32)
    m = targets.shape[0]
    k_eff = min(k, m)
    idx_parts, d2_parts = [], []
    for s in range(0, queries.shape[0], chunk):
        # + invalid also turns clamp_min's -0.0 into +0.0, so every value
        # is >= +0.0, as knn_select requires.
        d2 = pairwise_sqdist(queries[s:s + chunk], targets) + invalid[None, :]
        d2k, idxk = knn_select(d2, k_eff)
        idx_parts.append(idxk)
        d2_parts.append(d2k)
    idx = torch.cat(idx_parts)
    d2 = torch.cat(d2_parts)
    if k_eff < k:
        pad = k - k_eff
        idx = torch.nn.functional.pad(idx, (0, pad))
        d2 = torch.nn.functional.pad(d2, (0, pad), value=_BIG)
    return idx, d2


def knn_select_plain(d2: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest values of each row of ``d2`` f32[Q, M], ascending,
    and their columns (d2 f32[Q, k], idx i32[Q, k]), ties at the lower
    column first: a stable ascending sort of each row, then a slice."""
    d2s, order = torch.sort(d2, dim=1, stable=True)
    return d2s[:, :k], order[:, :k].to(torch.int32)


def knn_select(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn_select_plain`'s (d2, idx), bit for bit. A CUDA ``d2`` with
    ``k`` ≤ :data:`KNN_SELECT_MAX_K` launches K12, which picks the same
    (value, column) pairs without sorting the row: ``d2`` must then be
    ≥ +0.0 everywhere (a squared distance, or the 1e30 sentinel), so that
    its fp32 bits order as its values. Any other ``d2`` takes the plain
    version (a larger ``k``, or none, on the card too)."""
    if d2.ndim != 2 or not 0 <= k <= d2.shape[1]:
        raise ValueError(f"knn_select takes (Q, M) rows and 0 <= k <= M, "
                         f"got {tuple(d2.shape)} and k={k}")
    if not launches_kernel(d2) or not 1 <= k <= KNN_SELECT_MAX_K:
        return knn_select_plain(d2, k)
    if d2.dtype != torch.float32:
        raise TypeError("knn_select kernel takes float32 distances")
    d2 = d2.contiguous()
    q, m = d2.shape
    out_d2 = torch.empty((q, k), dtype=torch.float32, device=d2.device)
    out_idx = torch.empty((q, k), dtype=torch.int32, device=d2.device)
    with on_device(d2.device):
        err = build.library().tpu3d_knn_select(
            d2.data_ptr(), q, m, k, out_d2.data_ptr(), out_idx.data_ptr(),
            torch.cuda.current_stream(d2.device).cuda_stream,
        )
    build.check(err, "tpu3d_knn_select")
    build.count_launch(knn_select)
    return out_d2, out_idx


knn_select.launches = 0


def radius_capped_neighbors(
    points: torch.Tensor,
    mask: torch.Tensor,
    radius: float,
    max_nn: int,
    chunk: int = 1024,
    method: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``findRadiusNN``: the ``max_nn`` closest points
    within ``radius`` of each point (self included, first at distance 0).
    Returns (idx i32[N, max_nn], d2 f32[N, max_nn], valid bool[N, max_nn])."""
    idx, d2 = knn(points, points, mask, k=max_nn, chunk=chunk, method=method)
    r = np.float32(radius)
    valid = (d2 <= float(r * r)) & (d2 < _BIG / 2)
    return idx, d2, valid


def smallest_k(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest values along the last axis, ascending, and their
    positions, with ties at the lower position first, the order
    ``lax.top_k(-d2, k)`` gives. ``d2`` must be non-negative (a distance,
    or the 1e30 sentinel), so its fp32 bits order as its values; each
    element's key is those bits above its position, all keys distinct,
    and ``torch.topk`` of distinct keys has one answer."""
    pos = torch.arange(d2.shape[-1], device=d2.device, dtype=torch.int64)
    key = (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | pos
    keys = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    pos_k = keys & 0xFFFFFFFF
    return d2.gather(-1, pos_k), pos_k
