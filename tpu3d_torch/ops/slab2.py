"""Bucket-aligned two-level slab index: x-buckets, y-sorted within each
bucket, each bucket's run padded to a whole number of query blocks.

Counterpart of ``tpu3d/ops/slab2.py`` (``_qy_of``, ``sorted_positions``,
``AlignedSlab2``, ``aligned_capacity``, ``build_slab2_aligned``,
``aligned_block_windows``). Points are keyed by the int32 composite
``bucket << 20 | qy`` (qy = y quantised to 20 bits over the cloud's
y-extent) and sorted once, stably; every query block of the padded layout
then lies inside one bucket, and its candidate windows are the three
neighbouring buckets trimmed to the block's y-range ± radius. Windows are
supersets of the radius ball, so the d² ≤ r² gates downstream stay exact.

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


def _qy_of(y: torch.Tensor, y0, y_scale) -> torch.Tensor:
    return _floor_clip((y - y0) * y_scale, _Y_MAX)


def sorted_positions(skey: torch.Tensor, keys: torch.Tensor,
                     side: str = "left") -> torch.Tensor:
    """Exact ``searchsorted(skey, keys, side)`` as int32."""
    return torch.searchsorted(skey, keys, right=(side == "right")).to(
        torch.int32)


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
    xs = torch.where(mask, pts[:, 0], _SENTINEL)
    ys = torch.where(mask, pts[:, 1], _SENTINEL)
    zs = torch.where(mask, pts[:, 2], _SENTINEL)
    x0 = xs.min()
    y0 = ys.min()
    xext = torch.where(mask, pts[:, 0], -_SENTINEL).max() - x0
    yext = torch.where(mask, pts[:, 1], -_SENTINEL).max() - y0
    w = torch.maximum(
        torch.tensor(bucket_width, dtype=torch.float32, device=dev),
        xext / (max_buckets - 1),
    )
    inv_w = 1.0 / torch.clamp_min(w, 1e-12)
    # One rounded division (``scalar / tensor`` would be a reciprocal
    # and a product).
    y_scale = torch.div(torch.full_like(yext, _Y_MAX - 1),
                        torch.clamp_min(yext, 1e-12))

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

    planes = torch.stack([xs, ys, zs])[:, sorig]  # (3, n) key order
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
