"""Two-level slab index: x-buckets, y-sorted within each bucket; plain and
bucket-aligned layouts.

Counterpart of ``tpu3d/ops/slab2.py`` (``Slab2Index``, ``_bucket_of``,
``_qy_of``, ``sorted_positions``, ``build_slab2``, ``query_keys``,
``block_windows``, ``AlignedSlab2``, ``aligned_capacity``,
``build_slab2_aligned``, ``aligned_block_windows``). Points are keyed by
the int32 composite ``bucket << 20 | qy`` (qy = y quantised to 20 bits over
the cloud's y-extent) and sorted once, stably.

* Plain layout (``build_slab2``): the sorted rows as they are. A query
  block's windows are the buckets its queries can touch, each trimmed to
  the y-range of those queries ± radius, plus one untrimmed overflow
  window over the buckets past the first K − 1 (``block_windows``).
* Aligned layout (``build_slab2_aligned``): each bucket's run padded to a
  whole number of query blocks, so every block lies inside one bucket and
  its candidate windows are the three neighbouring buckets trimmed to the
  block's y-range ± radius.

Windows are supersets of the radius ball, so the d² ≤ r² gates downstream
stay exact.

Everything here is integer bookkeeping and must equal the JAX package's
values exactly: keys, bucket starts and offsets, the padded layout (with
unique out-of-bounds originals ``n + position`` on padding rows) and the
``(lo, len)`` window tables. Quantisation runs in fp32, multiplying by the
reciprocal width as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_Y_BITS = 20
_Y_MAX = (1 << _Y_BITS) - 1
_NB_MAX = 2047  # bucket ids 0..2046 valid, 2047 = invalid sentinel
_SENTINEL = 3.0e4


def _floor_clip(v: torch.Tensor, hi: int) -> torch.Tensor:
    """clip(floor(v), 0, hi) as int32. Clipping in fp32 before the cast
    gives XLA's saturating float→int conversion for ±inf and huge values."""
    return torch.floor(v).clamp(0, hi).to(torch.int32)


def _bucket_of(x: torch.Tensor, x0, inv_w) -> torch.Tensor:
    return _floor_clip((x - x0) * inv_w, _NB_MAX - 1)


def _qy_of(y: torch.Tensor, y0, y_scale) -> torch.Tensor:
    return _floor_clip((y - y0) * y_scale, _Y_MAX)


def _key(bucket: torch.Tensor, qy) -> torch.Tensor:
    """int32 ``bucket << 20 | qy``, wrapping past int32 as XLA's shift does
    (the overflow window's first key of a block whose first bucket lies
    near the last one; such a window is empty, but its ``lo`` is kept)."""
    k = ((bucket.long() << _Y_BITS) | qy) & 0xFFFFFFFF
    return torch.where(k >= 1 << 31, k - (1 << 32), k).to(torch.int32)


def sorted_positions(skey: torch.Tensor, keys: torch.Tensor,
                     side: str = "left") -> torch.Tensor:
    """Exact ``searchsorted(skey, keys, side)`` as int32."""
    return torch.searchsorted(skey, keys, right=(side == "right")).to(
        torch.int32)


class Slab2Index(NamedTuple):
    sorted_points_t: torch.Tensor  # f32[3, M] key-sorted; invalid rows 3e4
    sorted_orig: torch.Tensor  # i64[M] original row of each sorted row
    sorted_key: torch.Tensor  # i32[M] ascending composite keys
    valid_sorted: torch.Tensor  # bool[M]
    x0: torch.Tensor  # f32 bucket origin (min valid x)
    inv_w: torch.Tensor  # f32 1 / bucket width
    y0: torch.Tensor  # f32 quantisation origin (min valid y)
    y_scale: torch.Tensor  # f32 quantisation scale


def _frame(pts: torch.Tensor, mask: torch.Tensor, bucket_width,
           max_buckets: int):
    """(x0, inv_w, y0, y_scale) of a cloud, in fp32 as the JAX package
    computes them: the width widens so that at most ``max_buckets``
    buckets span the x-extent."""
    x0 = torch.where(mask, pts[:, 0], _SENTINEL).min()
    y0 = torch.where(mask, pts[:, 1], _SENTINEL).min()
    xext = torch.where(mask, pts[:, 0], -_SENTINEL).max() - x0
    yext = torch.where(mask, pts[:, 1], -_SENTINEL).max() - y0
    w = torch.maximum(
        torch.as_tensor(bucket_width, dtype=torch.float32, device=pts.device),
        xext / (max_buckets - 1),
    )
    inv_w = 1.0 / torch.clamp_min(w, 1e-12)
    # One rounded division (``scalar / tensor`` would be a reciprocal
    # and a product).
    y_scale = torch.div(torch.full_like(yext, _Y_MAX - 1),
                        torch.clamp_min(yext, 1e-12))
    return x0, inv_w, y0, y_scale


def build_slab2(points: torch.Tensor, mask: torch.Tensor,
                bucket_width) -> Slab2Index:
    """One stable sort of the composite keys; coordinates (3e4 on invalid
    rows) and original rows gathered by the permutation. ``bucket_width``
    widens so that at most 2,047 buckets exist."""
    pts = points.to(torch.float32)
    x0, inv_w, y0, y_scale = _frame(pts, mask, bucket_width, _NB_MAX)
    key = query_keys_frame(pts, mask, x0, inv_w, y0, y_scale)
    skey, order = torch.sort(key, stable=True)
    planes = torch.where(mask[None, :], pts.T, _SENTINEL)[:, order]
    return Slab2Index(
        sorted_points_t=planes.contiguous(),
        sorted_orig=order,
        sorted_key=skey,
        valid_sorted=skey < (_NB_MAX << _Y_BITS),
        x0=x0,
        inv_w=inv_w,
        y0=y0,
        y_scale=y_scale,
    )


def query_keys_frame(pts, mask, x0, inv_w, y0, y_scale) -> torch.Tensor:
    """Composite keys in the frame (x0, inv_w, y0, y_scale); invalid rows
    key to ``2047 << 20 | Y_MAX``, int32 max, past every valid key."""
    bucket = torch.where(mask, _bucket_of(pts[:, 0], x0, inv_w), _NB_MAX)
    qy = torch.where(mask, _qy_of(pts[:, 1], y0, y_scale), _Y_MAX)
    return ((bucket << _Y_BITS) | qy).to(torch.int32)


def query_keys(index: Slab2Index, points: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Composite keys of query points in the index's bucket and
    quantisation frame (invalid rows key to the end)."""
    return query_keys_frame(points.to(torch.float32), mask, index.x0,
                            index.inv_w, index.y0, index.y_scale)


def block_windows(
    index: Slab2Index,
    q_blocks,
    m_blocks: torch.Tensor,
    radius,
    k_max: int = 6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block candidate windows of the plain layout: (lo i32[nb, K],
    len i32[nb, K]).

    Window k < K−1 covers bucket (b_lo + k) trimmed to the y-range of the
    block's queries that can touch it (± radius, quantisation-widened);
    window K−1 merges the remaining buckets up to b_hi untrimmed. Windows
    are disjoint ascending row ranges. ``q_blocks`` is an (nb, B, 3)
    coordinate tensor or a tuple of (qx, qy) (nb, B) planes; ``m_blocks``
    bool[nb, B]."""
    if isinstance(q_blocks, tuple):
        qx, qy = q_blocks
    else:
        qx, qy = q_blocks[..., 0], q_blocks[..., 1]
    dev = qx.device
    r = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    qb = _bucket_of(qx, index.x0, index.inv_w)  # (nb, B)
    nb_r = torch.ceil(r * index.inv_w).to(torch.int32)

    b_min = torch.where(m_blocks, qb, _NB_MAX).amin(1)
    b_max = torch.where(m_blocks, qb, -1).amax(1)
    b_lo = torch.clamp_min(b_min - nb_r, 0).to(torch.int32)  # (nb,)
    b_hi = torch.clamp_max(b_max + nb_r, _NB_MAX - 1).to(torch.int32)

    ks = torch.arange(k_max - 1, dtype=torch.int32, device=dev)
    cand_raw = b_lo[:, None] + ks[None, :]  # (nb, K-1), may exceed b_hi
    # The shifted key takes the clipped bucket; selection and emptiness the
    # unclipped one, so clipped duplicates of bucket 2046 stay empty.
    cand_b = torch.clamp_max(cand_raw, _NB_MAX - 1)
    sel = m_blocks[:, None, :] & (
        (qb[:, None, :] - cand_raw[:, :, None]).abs() <= nb_r)
    inf = float("inf")
    ylo = torch.where(sel, qy[:, None, :], inf).amin(2) - r
    yhi = torch.where(sel, qy[:, None, :], -inf).amax(2) + r
    key_lo = _key(cand_b, _qy_of(ylo, index.y0, index.y_scale))
    key_hi = _key(cand_b, _qy_of(yhi, index.y0, index.y_scale))
    empty = ~sel.any(2) | (cand_raw > b_hi[:, None])

    # Overflow window: buckets [b_lo + K−1, b_hi] merged, no y trim.
    c0 = b_lo + (k_max - 1)
    of_lo = _key(c0, 0)
    of_hi = _key(b_hi, _Y_MAX)
    of_empty = b_hi < c0

    skey = index.sorted_key
    lo = sorted_positions(skey, key_lo.contiguous())
    hi = sorted_positions(skey, key_hi.contiguous(), side="right")
    length = torch.where(empty, 0, hi - lo)
    lo_of = sorted_positions(skey, of_lo)
    hi_of = sorted_positions(skey, of_hi, side="right")
    len_of = torch.where(of_empty, 0, hi_of - lo_of)
    lo_all = torch.cat([lo, lo_of[:, None]], 1).to(torch.int32)
    len_all = torch.cat([length, len_of[:, None]], 1).to(torch.int32)
    return lo_all.contiguous(), len_all.contiguous()


class AlignedSlab2(NamedTuple):
    padded_points_t: torch.Tensor  # f32[3, Mp] planes; sentinel 3e4 padding
    padded_orig: torch.Tensor  # i64[Mp] original row; n + position on padding
    valid_padded: torch.Tensor  # bool[Mp]
    sorted_key: torch.Tensor  # i32[N] ascending keys of all rows (no padding)
    starts_real: torch.Tensor  # i32[NB+1] sorted start row per bucket
    offsets: torch.Tensor  # i32[NB+1] padded start row per bucket
    x0: torch.Tensor  # f32 bucket origin (min valid x)
    inv_w: torch.Tensor  # f32 1 / bucket width
    y0: torch.Tensor  # f32 quantisation origin (min valid y)
    y_scale: torch.Tensor  # f32 quantisation scale


def aligned_capacity(n: int, block: int, max_buckets: int) -> int:
    """Static padded size: every nonempty bucket pads by < block rows."""
    mp = n + max_buckets * (block - 1)
    return -(-mp // block) * block


def _owning_bucket(offsets: torch.Tensor, blk_start: torch.Tensor):
    """Bucket b with offsets[b] <= start < offsets[b+1] for each block start
    (−1 before the first, NB and past for tail blocks)."""
    return torch.searchsorted(offsets, blk_start, right=True).to(
        torch.int32) - 1


def build_slab2_aligned(
    points: torch.Tensor,
    mask: torch.Tensor,
    bucket_width: float,
    block: int = 128,
    max_buckets: int = 128,
) -> AlignedSlab2:
    """One stable sort of the composite keys, then one gather into the
    padded layout: padded row p of a block owned by bucket b pulls sorted
    row ``starts[b] + (p − offsets[b])`` when that lies inside the bucket's
    run, else a sentinel column."""
    assert max_buckets <= _NB_MAX
    dev = points.device
    pts = points.to(torch.float32)
    n = pts.shape[0]
    mp = aligned_capacity(n, block, max_buckets)
    x0, inv_w, y0, y_scale = _frame(pts, mask, bucket_width, max_buckets)

    bucket = torch.where(
        mask, _floor_clip((pts[:, 0] - x0) * inv_w, max_buckets - 1), _NB_MAX
    ).to(torch.int32)
    qy = torch.where(mask, _qy_of(pts[:, 1], y0, y_scale), _Y_MAX).to(
        torch.int32)
    key = (bucket << _Y_BITS) | qy

    skey, sorig = torch.sort(key, stable=True)
    bounds = torch.arange(max_buckets + 1, dtype=torch.int32,
                          device=dev) << _Y_BITS
    starts = sorted_positions(skey, bounds)  # (NB+1,)
    counts = starts[1:] - starts[:-1]
    pcounts = -(-counts // block) * block
    offsets = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.cumsum(pcounts, 0).to(torch.int32),
    ])

    nbk = mp // block
    blk_start = torch.arange(nbk, dtype=torch.int32, device=dev) * block
    b_blk = _owning_bucket(offsets, blk_start).clamp(0, max_buckets - 1).long()
    p_idx = blk_start[:, None] + torch.arange(block, dtype=torch.int32,
                                              device=dev)[None, :]
    src_row = starts[b_blk][:, None] + (p_idx - offsets[b_blk][:, None])
    in_run = src_row < (starts[b_blk] + counts[b_blk])[:, None]
    src_row = torch.where(in_run, src_row, n).reshape(mp).long()
    valid_padded = in_run.reshape(mp)

    planes = torch.where(mask[None, :], pts.T, _SENTINEL)[:, sorig]
    planes = torch.cat(
        [planes, torch.full((3, 1), _SENTINEL, dtype=torch.float32,
                            device=dev)], dim=1)
    padded_points_t = planes[:, src_row]
    sorig_ext = torch.cat([sorig, torch.zeros(1, dtype=sorig.dtype,
                                              device=dev)])
    pos = torch.arange(mp, dtype=torch.int64, device=dev) + n
    padded_orig = torch.where(valid_padded, sorig_ext[src_row], pos)
    return AlignedSlab2(
        padded_points_t=padded_points_t,
        padded_orig=padded_orig,
        valid_padded=valid_padded,
        sorted_key=skey,
        starts_real=starts,
        offsets=offsets,
        x0=x0,
        inv_w=inv_w,
        y0=y0,
        y_scale=y_scale,
    )


def aligned_block_windows(
    al: AlignedSlab2, radius: float, block: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block candidate windows over the same aligned layout (self-join):
    (lo i32[nbk, 3], len i32[nbk, 3]) in padded-row coordinates, padding
    excluded. Window k covers bucket (b−1+k) trimmed to the block's
    valid-query y-range ± radius (quantisation-widened superset)."""
    dev = al.valid_padded.device
    mp = al.valid_padded.shape[0]
    nbk = mp // block
    nb = al.offsets.shape[0] - 1
    vm = al.valid_padded.reshape(nbk, block)
    qy_b = al.padded_points_t[1].reshape(nbk, block)

    blk_start = torch.arange(nbk, dtype=torch.int32, device=dev) * block
    b_blk = _owning_bucket(al.offsets, blk_start)
    live = vm.any(1) & (b_blk >= 0) & (b_blk < nb)

    inf = float("inf")
    ylo = torch.where(vm, qy_b, inf).amin(1) - radius
    yhi = torch.where(vm, qy_b, -inf).amax(1) + radius
    qy_lo = _qy_of(ylo, al.y0, al.y_scale)
    qy_hi = _qy_of(yhi, al.y0, al.y_scale)

    ks = torch.arange(3, dtype=torch.int32, device=dev) - 1
    cand = b_blk[:, None] + ks[None, :]  # (nbk, 3)
    ok = live[:, None] & (cand >= 0) & (cand < nb)
    cc = cand.clamp(0, nb - 1)
    key_lo = (cc << _Y_BITS) | qy_lo[:, None]
    # A 'right' search of integer key k is a 'left' search of k + 1; no
    # overflow: key_hi <= (2046 << 20) | _Y_MAX.
    key_hi = (cc << _Y_BITS) | qy_hi[:, None]
    skey = al.sorted_key
    lo_r = sorted_positions(skey, key_lo.contiguous())
    hi_r = sorted_positions(skey, (key_hi + 1).contiguous())
    length = torch.where(ok, hi_r - lo_r, 0).to(torch.int32)
    ccl = cc.long()
    lo_p = al.offsets[ccl] + (lo_r - al.starts_real[ccl])
    lo_p = torch.where(ok, lo_p, 0).to(torch.int32)
    return lo_p, length
