// K8: exact top-1 nearest neighbour within a radius over slab2 windows.
//
// Replaces tpu3d/ops/nn_walk.py: slab2_top1_indexed (_top1_kernel, run
// through features_pallas._run_sweep). One CTA per slice of a query block
// of the key-sorted queries (block = 128, 256 or 512 rows; `slices` CTAs a
// block), kQ queries a thread. The block's K windows [lo, lo + len) of the
// key-sorted target are walked in order, in kTile-row tiles staged as one
// float4 a row (x, y, z; the fourth word is unused) by cp.async into a
// two-stage ring, so that the copy of tile t + 1 overlaps the scan of tile
// t. Per query the result is that of a running best over the walk:
//   d2 = (dx*dx + dy*dy) + dz*dz with d = t - q, each operation rounded
//   once (the _rn intrinsics, no FMA contraction); a row replaces the
//   running best only when d2 < bd, so the first least row of the walk
//   wins; idx is that row's payload (the original row, packed row 3),
//   inside the radius or not (0 when no row improved on 1e30); only the
//   distance is gated: out_d2 = (valid && bd <= r2) ? bd : 1e30.
//
// What bounds it on an H100: instruction issue. Every (query, window row)
// pair is evaluated, as the Pallas kernel does: 2.42e9 pairs at the 1M
// self-join (block 512, K 8), eight rounded fp32 operations each, on a
// 16 MB operand that stays in the 50 MB L2. The design cuts the issue
// slots a pair:
//   - a register tile of kQ queries a thread: one broadcast float4 shared
//     load of a row serves all kQ of them;
//   - the running best keeps no payload: bd = fminf(bd, d2) a pair (one
//     instruction where a compare and two selects were), and once per
//     group of kGroup rows, if the group lowered bd, the group's first
//     row and row count are recorded. A group lowers bd strictly only
//     where it holds a row below every earlier row, so the recorded group
//     is the one that holds the first least row; at the end each query
//     evaluates that group's rows again from device memory, with the same
//     arithmetic, and takes the payload of the first row whose d2 equals
//     bd. That is the row, and the payload, of the strict-'<' walk.
// A pair so costs its eight operations, one minimum and 1/kQ of a shared
// load, against about fourteen slots a pair in the earlier design (a
// query a thread, four scalar shared loads a row, a compare and two
// selects a pair, two barriers around every tile and no copy in flight
// during a scan). Rows past a window's end in the last group of a tile
// are staged as +inf, which no minimum takes.
// The blocks' work differs (at the 1M self-join 2,306 window rows a block
// on average, 4,926 at most), so a first one-CTA kernel orders the blocks
// by their window rows, most first, and the walk's CTAs take them in that
// order: the last CTAs on the card are then short ones, where in row order
// a long block could run on alone at the end of the launch (on an H100
// at 700 W, 0.8443 ms against 1.0732 at the 1M self-join: chip_smoke.py,
// medians of six runs, the run PERF.md's section 6 reports).
// nn_walk_plan (ops/nn_walk.py) chooses kQ and the slices from the block
// and the block count.

#include <cuda_runtime.h>

#include "window_walk.cuh"

namespace {

constexpr float kBig = 1.0e30f;
constexpr int kMaxK = 16;
constexpr int kGroup = 8;  // rows a recorded group
static_assert(kGroup == 8, "a group's code keeps its row count in 3 bits");

// The walk over a block's windows, tile by tile: window k, first row
// start. settle() moves past exhausted and empty windows.
struct Cursor {
  int k, start;
  __device__ __forceinline__ void settle(int nk, const int* lo,
                                         const int* hi) {
    while (k < nk && start >= hi[k]) {
      ++k;
      if (k < nk) start = lo[k];
    }
  }
};

template <int kQ, int kTile>
__global__ void __launch_bounds__(512)
nn_walk_top1_kernel(const float* __restrict__ q4,
                    const float* __restrict__ packed,
                    const int* __restrict__ lo, const int* __restrict__ len,
                    const int* __restrict__ order, int qp, int m, int nk,
                    int block, int slices, float r2,
                    float* __restrict__ out_d2, int* __restrict__ out_idx) {
  __shared__ float4 tile[2][kTile];
  __shared__ int wlo[kMaxK], whi[kMaxK];
  const int item = blockIdx.x / slices;
  const int b = order[item];
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int q0 = b * block + (blockIdx.x - item * slices) * (block / slices);
  const size_t qs = static_cast<size_t>(qp);
  const size_t ms = static_cast<size_t>(m);
  if (tid < nk) {
    wlo[tid] = lo[b * nk + tid];
    whi[tid] = wlo[tid] + len[b * nk + tid];
  }
  // Query i of this thread: row q0 + tid + i·nthr, so that query i of a
  // warp's threads are 32 consecutive rows.
  float qx[kQ], qy[kQ], qz[kQ], bd[kQ];
  int grp[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int row = q0 + tid + i * nthr;
    qx[i] = q4[row];
    qy[i] = q4[qs + row];
    qz[i] = q4[2 * qs + row];
    bd[i] = kBig;
    grp[i] = 0;
  }
  __syncthreads();

  // Tile t lands in tile[t & 1]: rows [start, start + nt) by cp.async,
  // then +inf up to the next multiple of kGroup.
  auto stage = [&](int buf, int start, int nt) {
    float* dst = &tile[buf][0].x;
    const float inf = __int_as_float(0x7f800000);
    for (int i = tid; i < 3 * kTile; i += nthr) {
      const int r = i / kTile;
      const int c = i - r * kTile;
      if (c < nt) {
        tpu3d::cp_async4(dst + 4 * c + r, packed + r * ms + start + c);
      } else if (c < ((nt + kGroup - 1) & ~(kGroup - 1))) {
        dst[4 * c + r] = inf;
      }
    }
    tpu3d::cp_async_commit();
  };

  Cursor load{0, wlo[0]};
  load.settle(nk, wlo, whi);
  int cur_start = 0, cur_nt = 0;  // the tile in flight for the next scan
  if (load.k < nk) {
    cur_start = load.start;
    cur_nt = min(kTile, whi[load.k] - load.start);
    stage(0, cur_start, cur_nt);
    load.start += kTile;
    load.settle(nk, wlo, whi);
  }
#pragma unroll 1
  for (int t = 0; cur_nt > 0; ++t) {
    const int start = cur_start;
    const int nt = cur_nt;
    if (load.k < nk) {
      cur_start = load.start;
      cur_nt = min(kTile, whi[load.k] - load.start);
      stage((t + 1) & 1, cur_start, cur_nt);
      load.start += kTile;
      load.settle(nk, wlo, whi);
      tpu3d::cp_async_wait<1>();
    } else {
      cur_nt = 0;
      tpu3d::cp_async_wait<0>();
    }
    __syncthreads();
    const float4* buf = tile[t & 1];
    const int ng = (nt + kGroup - 1) / kGroup;
#pragma unroll 1
    for (int g = 0; g < ng; ++g) {
      float before[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) before[i] = bd[i];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float4 p = buf[g * kGroup + j];
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          bd[i] = fminf(bd[i],
                        tpu3d::dist2(p.x, p.y, p.z, qx[i], qy[i], qz[i]));
        }
      }
      // The group's first row and its row count - 1, in one int (rows are
      // below 2^24).
      const int code = ((start + g * kGroup) << 3) |
                       (min(kGroup, nt - g * kGroup) - 1);
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        if (bd[i] < before[i]) grp[i] = code;
      }
    }
    __syncthreads();  // the buffer is free for tile t + 2
  }

#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int row = q0 + tid + i * nthr;
    float bi = 0.0f;
    if (bd[i] < kBig) {  // some row improved on 1e30: find it in its group
      const int first = grp[i] >> 3;
      const int cnt = (grp[i] & (kGroup - 1)) + 1;
#pragma unroll 1
      for (int j = 0; j < cnt; ++j) {
        const int r = first + j;
        if (tpu3d::dist2(packed[r], packed[ms + r], packed[2 * ms + r],
                         qx[i], qy[i], qz[i]) == bd[i]) {
          bi = packed[3 * ms + r];
          break;
        }
      }
    }
    const bool valid = q4[3 * qs + row] > 0.5f;
    out_d2[row] = (valid && bd[i] <= r2) ? bd[i] : kBig;
    out_idx[row] = static_cast<int>(bi);
  }
}

// The launch order of the blocks, most window rows first (one CTA): a
// counting sort of the blocks' row counts into 256 buckets by the top bits
// of (rows + 1) as a float (its exponent and three mantissa bits, so a
// bucket spans an eighth of an octave), the largest first; within a bucket
// in no fixed order, which changes no result, as every block's rows depend
// on its own windows only. `scratch` (nb ints) keeps each block's bucket
// between the two passes.
constexpr int kOrderThreads = 1024;
constexpr int kOrderBuckets = 256;

__global__ void __launch_bounds__(kOrderThreads)
nn_walk_order_kernel(const int* __restrict__ len, int nb, int nk,
                     int* __restrict__ scratch, int* __restrict__ order) {
  __shared__ int start[kOrderBuckets];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < kOrderBuckets) start[tid] = 0;
  __syncthreads();
  // Whole warps walk the blocks, so that the lanes of one bucket add to
  // its count once (a warp's blocks mostly share a few buckets).
  for (int b0 = tid - lane; b0 < nb; b0 += kOrderThreads) {
    const int b = b0 + lane;
    int bucket = -1;
    if (b < nb) {
      int rows = 1;
      for (int k = 0; k < nk; ++k) rows += len[b * nk + k];
      // rows in [1, 2^31): exponent field 127..157, top in [1016, 1263].
      const int top = __float_as_int(static_cast<float>(rows)) >> 20;
      bucket = (157 << 3) + 7 - top;
      scratch[b] = bucket;
    }
    const unsigned same = __match_any_sync(0xffffffffu, bucket);
    if (bucket >= 0 && lane == __ffs(same) - 1) {
      atomicAdd(&start[bucket], __popc(same));
    }
  }
  // Counts -> first positions: a scan over the buckets (Hillis-Steele).
  __syncthreads();
  const int count = tid < kOrderBuckets ? start[tid] : 0;
  int run = count;
  for (int off = 1; off < kOrderBuckets; off <<= 1) {
    const int add = tid < kOrderBuckets && tid >= off ? start[tid - off] : 0;
    __syncthreads();
    if (tid < kOrderBuckets) start[tid] = run = run + add;
    __syncthreads();
  }
  if (tid < kOrderBuckets) start[tid] = run - count;
  __syncthreads();
  for (int b0 = tid - lane; b0 < nb; b0 += kOrderThreads) {
    const int b = b0 + lane;
    const int bucket = b < nb ? scratch[b] : -1;
    const unsigned same = __match_any_sync(0xffffffffu, bucket);
    const int leader = __ffs(same) - 1;
    int first = 0;
    if (bucket >= 0 && lane == leader) {
      first = atomicAdd(&start[bucket], __popc(same));
    }
    first = __shfl_sync(0xffffffffu, first, leader);
    if (bucket >= 0) order[first + __popc(same & ((1u << lane) - 1u))] = b;
  }
}

struct Args {
  const float* q4;
  const float* packed;
  const int* lo;
  const int* len;
  const int* order;
  int qp, m, nb, nk, block, slices, threads;
  float r2;
  float* out_d2;
  int* out_idx;
  cudaStream_t stream;
};

template <int kQ, int kTile>
void launch_tile(const Args& a) {
  nn_walk_top1_kernel<kQ, kTile>
      <<<a.nb * a.slices, a.threads, 0, a.stream>>>(
          a.q4, a.packed, a.lo, a.len, a.order, a.qp, a.m, a.nk, a.block,
          a.slices, a.r2, a.out_d2, a.out_idx);
}

template <int kQ>
void launch_q(const Args& a, int sub) {
  switch (sub) {
    case 128: launch_tile<kQ, 128>(a); break;
    case 256: launch_tile<kQ, 256>(a); break;
    default: launch_tile<kQ, 512>(a); break;
  }
}

}  // namespace

// q4 f32[4, qp] (key-sorted query x, y, z, validity; qp = nb * block),
// packed f32[4, m] (key-sorted target x, y, z, original row; m < 2^24),
// lo/len i32[nb, k] -> out_d2 f32[qp], out_idx i32[qp]. `order` (i32[nb])
// receives the blocks' launch order, most window rows first. The launch:
// `slices` CTAs a block (1, 2 or 4), `per` queries a thread (1, 2 or 4),
// so block / (slices * per) threads a CTA, a multiple of 32; `sub` (128,
// 256 or 512) rows a tile.
extern "C" int tpu3d_nn_walk_top1(const void* q4, const void* packed,
                                  const void* lo, const void* len,
                                  void* order, int qp, int m, int nb,
                                  int k, int block, int sub, int slices,
                                  int per, float r2, void* out_d2,
                                  void* out_idx, void* stream) {
  const bool shape_ok = (block == 128 || block == 256 || block == 512) &&
                        qp == nb * block && k >= 1 && k <= kMaxK &&
                        m < (1 << 24) && (nb == 0 || order != nullptr);
  const bool plan_ok = (slices == 1 || slices == 2 || slices == 4) &&
                       (per == 1 || per == 2 || per == 4) &&
                       (block / (slices * per)) % 32 == 0 &&
                       (sub == 128 || sub == 256 || sub == 512);
  if (!shape_ok || !plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0) {
    const Args a{static_cast<const float*>(q4),
                 static_cast<const float*>(packed),
                 static_cast<const int*>(lo),
                 static_cast<const int*>(len),
                 static_cast<const int*>(order),
                 qp, m, nb, k, block, slices, block / (slices * per), r2,
                 static_cast<float*>(out_d2),
                 static_cast<int*>(out_idx),
                 static_cast<cudaStream_t>(stream)};
    nn_walk_order_kernel<<<1, kOrderThreads, 0, a.stream>>>(
        a.len, nb, k, a.out_idx, static_cast<int*>(order));
    switch (per) {
      case 1: launch_q<1>(a, sub); break;
      case 2: launch_q<2>(a, sub); break;
      case 4: launch_q<4>(a, sub); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
