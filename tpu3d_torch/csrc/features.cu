// K2, K3, K4: the fused-prepare sweeps (normals, SPFH, FPFH) over each
// query block's three candidate windows of the bucket-aligned layout.
//
// Replaces tpu3d/ops/features_pallas.py: moments_sweep_pallas
// (_moments_kernel, K2), spfh_sweep_pallas (_spfh_kernel, K3) and
// fpfh_sweep_pallas (_fpfh_kernel, K4). What each computes per query row:
//   K2  9 centred moments + an int count over d2 <= r2 (raw coordinates),
//       centred on the block's mean of valid queries (a fixed-order tree);
//       then covariance, the Newton smallest eigenvector and the viewpoint
//       flip -> out (8, m): normal in rows 0-2, count in row 3;
//   K3  the Darboux angles alpha, phi and the diamond surrogate of theta
//       over r2 >= d2 >= 1e-16 (centroid-shifted coordinates), each binned
//       by counting the fp32 thresholds at or below it, into a 33-bin
//       integer histogram, L1-normalised -> out (40, m): rows 0-32 SPFH,
//       row 33 the count;
//   K4  33 fp32 sums of SPFH_j / d over r2 >= d2 >= 1e-16 -> out (m, 36).
// Each design is described above its kernels; the launch plans that choose
// between them (moments_plan, spfh_plan, fpfh_plan) are in ops/features.py.
//
// What bounds them on an H100: fp32 arithmetic, not memory. Every
// (query, candidate) pair of a block's windows costs one distance (8
// operations), and each neighbour within the radius 18 more (K2), about
// 100 (K3: the angles, two divisions, a square root and the bins) or 66
// (K4); 13 % of the pairs are neighbours at the dense 1M shape, and the
// operands are a few MB. One thread per query loses much of that to
// divergence: whenever one lane of a warp has a neighbour, the whole warp
// runs the neighbour's work. K2 runs it as often as the busiest lane has
// neighbours among 32 candidates; K3 queues the neighbours and runs it on
// 32 of them at a time. The TPU ran the bilinear angle terms and the
// weighted SPFH sum as MXU matmuls; here they are per-pair dot products,
// and its +-1 histogram assembly matmul becomes integer bins.
//
// Every operation rounds once (the _rn intrinsics, no FMA contraction),
// float sums run in the walk's fixed order and K3's bins are integers, so
// a block's results depend only on its own windows (the sparse prepare
// equals the dense one bit for bit) and match the plain PyTorch versions'
// arithmetic.

#include <cuda_runtime.h>

#include "window_walk.cuh"

namespace {

using tpu3d::add_rn;
using tpu3d::div_rn;
using tpu3d::mul_rn;
using tpu3d::sub_rn;

constexpr int kWindows = 3;  // the aligned layout's windows per block
constexpr int kMaxBlock = 256;
constexpr int kThresh = 20;

struct Thresh {
  float t[kThresh];  // alpha/phi bin thresholds, then theta's diamond ones
};

// tpu3d_torch/ops/normals.py smallest_eigvec_3x3_planes_newton, operation
// for operation.
__device__ void eigvec_newton(float a00, float a01, float a02, float a11,
                              float a12, float a22, float* v) {
  float scale = fabsf(a00);
  scale = fmaxf(scale, fabsf(a01));
  scale = fmaxf(scale, fabsf(a02));
  scale = fmaxf(scale, fabsf(a11));
  scale = fmaxf(scale, fabsf(a12));
  scale = fmaxf(scale, fabsf(a22));
  scale = fmaxf(scale, 1e-30f);
  a00 = div_rn(a00, scale);
  a01 = div_rn(a01, scale);
  a02 = div_rn(a02, scale);
  a11 = div_rn(a11, scale);
  a12 = div_rn(a12, scale);
  a22 = div_rn(a22, scale);

  const float q = div_rn(add_rn(add_rn(a00, a11), a22), 3.0f);
  const float p1 =
      add_rn(add_rn(mul_rn(a01, a01), mul_rn(a02, a02)), mul_rn(a12, a12));
  const float d00 = sub_rn(a00, q);
  const float d11 = sub_rn(a11, q);
  const float d22 = sub_rn(a22, q);
  const float p2 = add_rn(
      add_rn(add_rn(mul_rn(d00, d00), mul_rn(d11, d11)), mul_rn(d22, d22)),
      mul_rn(2.0f, p1));
  const float p = __fsqrt_rn(fmaxf(div_rn(p2, 6.0f), 1e-30f));
  const float inv_p = div_rn(1.0f, p);
  const float b00 = mul_rn(d00, inv_p);
  const float b11 = mul_rn(d11, inv_p);
  const float b22 = mul_rn(d22, inv_p);
  const float b01 = mul_rn(a01, inv_p);
  const float b02 = mul_rn(a02, inv_p);
  const float b12 = mul_rn(a12, inv_p);
  const float det = add_rn(
      sub_rn(mul_rn(b00, sub_rn(mul_rn(b11, b22), mul_rn(b12, b12))),
             mul_rn(b01, sub_rn(mul_rn(b01, b22), mul_rn(b12, b02)))),
      mul_rn(b02, sub_rn(mul_rn(b01, b12), mul_rn(b11, b02))));
  const float d = fminf(fmaxf(det, -2.0f), 2.0f);
  float beta = -2.0f;
#pragma unroll
  for (int it = 0; it < 12; ++it) {
    const float h = sub_rn(mul_rn(sub_rn(mul_rn(beta, beta), 3.0f), beta), d);
    const float hp = sub_rn(mul_rn(mul_rn(3.0f, beta), beta), 3.0f);
    beta = fminf(fmaxf(sub_rn(beta, div_rn(h, fmaxf(hp, 1e-12f))), -2.0f),
                 -1.0f);
  }
  const float lam1 = add_rn(q, mul_rn(p, beta));
  const float s = sub_rn(mul_rn(3.0f, q), lam1);
  const float tra2 = add_rn(
      add_rn(add_rn(mul_rn(a00, a00), mul_rn(a11, a11)), mul_rn(a22, a22)),
      mul_rn(2.0f, p1));
  const float e2 = div_rn(sub_rn(mul_rn(mul_rn(9.0f, q), q), tra2), 2.0f);
  const float t = sub_rn(e2, mul_rn(lam1, s));

  const float P00 = add_rn(
      sub_rn(add_rn(add_rn(mul_rn(a00, a00), mul_rn(a01, a01)),
                    mul_rn(a02, a02)),
             mul_rn(s, a00)),
      t);
  const float P01 = sub_rn(
      add_rn(add_rn(mul_rn(a00, a01), mul_rn(a01, a11)), mul_rn(a02, a12)),
      mul_rn(s, a01));
  const float P02 = sub_rn(
      add_rn(add_rn(mul_rn(a00, a02), mul_rn(a01, a12)), mul_rn(a02, a22)),
      mul_rn(s, a02));
  const float P11 = add_rn(
      sub_rn(add_rn(add_rn(mul_rn(a01, a01), mul_rn(a11, a11)),
                    mul_rn(a12, a12)),
             mul_rn(s, a11)),
      t);
  const float P12 = sub_rn(
      add_rn(add_rn(mul_rn(a01, a02), mul_rn(a11, a12)), mul_rn(a12, a22)),
      mul_rn(s, a12));
  const float P22 = add_rn(
      sub_rn(add_rn(add_rn(mul_rn(a02, a02), mul_rn(a12, a12)),
                    mul_rn(a22, a22)),
             mul_rn(s, a22)),
      t);

  const float n0 =
      add_rn(add_rn(mul_rn(P00, P00), mul_rn(P01, P01)), mul_rn(P02, P02));
  const float n1 =
      add_rn(add_rn(mul_rn(P01, P01), mul_rn(P11, P11)), mul_rn(P12, P12));
  const float n2 =
      add_rn(add_rn(mul_rn(P02, P02), mul_rn(P12, P12)), mul_rn(P22, P22));
  const bool m0 = (n0 >= n1) && (n0 >= n2);
  const bool m1 = n1 >= n2;
  const float vx = m0 ? P00 : (m1 ? P01 : P02);
  const float vy = m0 ? P01 : (m1 ? P11 : P12);
  const float vz = m0 ? P02 : (m1 ? P12 : P22);
  const float vn = __fsqrt_rn(
      add_rn(add_rn(mul_rn(vx, vx), mul_rn(vy, vy)), mul_rn(vz, vz)));
  const bool ok = vn > 1e-20f;
  const float inv = div_rn(1.0f, fmaxf(vn, 1e-30f));
  v[0] = ok ? mul_rn(vx, inv) : 0.0f;
  v[1] = ok ? mul_rn(vy, inv) : 0.0f;
  v[2] = ok ? mul_rn(vz, inv) : 1.0f;
}

// ---- shared by K2, K3 and K4's lane kernel --------------------------------

// Tile t of a block's three windows cut into kRows-row tiles: its first
// row and its row count.
template <int kRows>
__device__ __forceinline__ void tile_at(int t, const int* ntile,
                                        const int* wlo, const int* whi,
                                        int& start, int& nt) {
  int k = 0;
  if (t >= ntile[0]) {
    t -= ntile[0];
    k = 1;
    if (t >= ntile[1]) {
      t -= ntile[1];
      k = 2;
    }
  }
  start = wlo[k] + t * kRows;
  nt = min(kRows, whi[k] - start);
}

// Block b's three windows [wlo, whi) and their kRows-row tile counts;
// returns the number of tiles.
template <int kRows>
__device__ __forceinline__ int window_tiles(const int* __restrict__ lo,
                                            const int* __restrict__ len,
                                            int b, int* wlo, int* whi,
                                            int* ntile) {
  int total = 0;
#pragma unroll
  for (int k = 0; k < kWindows; ++k) {
    wlo[k] = lo[b * kWindows + k];
    whi[k] = wlo[k] + len[b * kWindows + k];
    ntile[k] = (len[b * kWindows + k] + kRows - 1) / kRows;
    total += ntile[k];
  }
  return total;
}

// cp.async of the kPlanes planes of one tile into buf, plane r of row c at
// buf[r·kPlaneStride + c·kRowStride], then one commit.
template <int kPlanes, int kPlaneStride, int kRowStride, int kRows>
__device__ __forceinline__ void stage_tile(float* buf,
                                           const float* __restrict__ packed,
                                           size_t ms, int start, int nt) {
  for (int i = threadIdx.x; i < kPlanes * kRows; i += blockDim.x) {
    const int r = i / kRows;
    const int c = i - r * kRows;
    if (c < nt) {
      tpu3d::cp_async4(buf + r * kPlaneStride + c * kRowStride,
                       packed + r * ms + start + c);
    }
  }
  tpu3d::cp_async_commit();
}

// Whether block b has a window with rows (lengths are never negative).
__device__ __forceinline__ bool block_live(const int* __restrict__ len,
                                           int b) {
  return (len[kWindows * b] | len[kWindows * b + 1] |
          len[kWindows * b + 2]) != 0;
}

// The thread kernels' tiles: kRowTile window rows, xyz as one float4 a row
// (one wide shared load a candidate; a warp reads one row at a time, a
// broadcast). The lane kernels' tiles: kLaneTile rows a plane, planes
// kLaneStride apart, so that lanes reading 32 consecutive columns of one
// plane, or one column of several planes, meet no bank conflict.
constexpr int kRowTile = 128;
constexpr int kLaneTile = 128;
constexpr int kLaneStride = kLaneTile + 1;

// The work item of this CTA: query block b, its slice's first row q0 and
// size sq.
struct Item {
  int b, q0, sq;
};

__device__ __forceinline__ Item item_of(int block, int slices) {
  const int w = static_cast<int>(blockIdx.x);
  const int b = w / slices;
  const int sq = block / slices;
  return {b, b * block + (w - b * slices) * sq, sq};
}

// ---- K2 ------------------------------------------------------------------
//
// moments_kernel<kQ>: kQ queries a thread (1 or 2 as moments_plan chooses;
// 4 only where chip_smoke.py forces it, to keep measuring the readings
// below), each with its nine sums in registers, one CTA per slice of
// block / slices queries of a block, the tiles double-buffered by cp.async.
// moments_plan (ops/features.py) cuts the sparse prepare's blocks in two, so
// that its few live blocks spread over more SMs, and gives dense layouts of
// more than eight blocks an SM two queries a thread. A CTA whose block has
// no window writes what an empty walk gives its rows and exits at once. A
// thread tests 32 candidates into a bit mask a query, then adds the moments
// of the set bits in ascending order, so a warp runs the 18-operation update
// as often as its busiest lane has neighbours among the 32; the earlier
// design ran it for every candidate that any lane had in its radius. Each
// query's sums keep window order and ascending row order, the order of the
// earlier design and of the plain version; every slice computes its block's
// centre over the whole block in the same tree order.
// The register tile: one float4 shared load a candidate serves kQ queries.
// On an H100 (700 W), device ms per call at one / two / four queries a
// thread: the dense 1M layout (8,700 blocks of 128) 0.5302 / 0.4765 /
// 0.5997, 1,151 blocks 0.0874 / 0.0850 / 0.1169, 911 0.0442 / 0.0455 /
// 0.0797, the batch's 255 and 191 0.0261 / 0.0354 / 0.0618 and 0.0187 /
// 0.0275 / 0.0510; the sparse prepare's, half a block a CTA, one / two,
// 0.0412 / 0.0633 (520 blocks of 256). The tile saves the loads and the
// loop's cost only where the card is full: it halves the warps, and the
// update loop still runs per query, so four queries a thread leave too
// few warps to hide the shared-memory and branch latency.
// Spreading the candidates across the lanes instead (a warp a query, lanes
// 0-8 adding the moments of each neighbour in order) costs the warp about
// ten issue slots a neighbour, as the sums' order serialises them; here
// one pass of the update serves up to 32 queries' neighbours.

// Covariance of a query's neighbour moments and its smallest eigenvector.
__device__ __forceinline__ void moments_normal(const float* mom, int cnt,
                                               float* v) {
  const float c = fmaxf(static_cast<float>(cnt), 1.0f);
  const float mx = div_rn(mom[0], c);
  const float my = div_rn(mom[1], c);
  const float mz = div_rn(mom[2], c);
  eigvec_newton(sub_rn(div_rn(mom[3], c), mul_rn(mx, mx)),
                sub_rn(div_rn(mom[6], c), mul_rn(mx, my)),
                sub_rn(div_rn(mom[7], c), mul_rn(mx, mz)),
                sub_rn(div_rn(mom[4], c), mul_rn(my, my)),
                sub_rn(div_rn(mom[8], c), mul_rn(my, mz)),
                sub_rn(div_rn(mom[5], c), mul_rn(mz, mz)), v);
}

// Row `row` of K2's output: the normal flipped so that n·q <= 0 (zero on
// an invalid row) and the neighbour count.
__device__ __forceinline__ void moments_write(const float* v, int cnt,
                                              const float* __restrict__ q8,
                                              size_t ms, int row,
                                              float* __restrict__ out) {
  const float qx = q8[row];
  const float qy = q8[ms + row];
  const float qz = q8[2 * ms + row];
  const bool flip =
      add_rn(add_rn(mul_rn(v[0], qx), mul_rn(v[1], qy)), mul_rn(v[2], qz)) >
      0.0f;
  const float sgn = q8[3 * ms + row] > 0.5f ? (flip ? -1.0f : 1.0f) : 0.0f;
  out[row] = mul_rn(v[0], sgn);
  out[ms + row] = mul_rn(v[1], sgn);
  out[2 * ms + row] = mul_rn(v[2], sgn);
  out[3 * ms + row] = static_cast<float>(cnt);
#pragma unroll
  for (int r = 4; r < 8; ++r) out[r * ms + row] = 0.0f;
}

// The block's centre over valid queries, (cx, cy, cz): four sums by the
// tree of the plain versions' _tree_sum (halving the block's `block`
// values), taken by the CTA's threads whatever their count. red is
// [4][kMaxBlock].
__device__ __forceinline__ void block_centre(const float* __restrict__ q8,
                                             size_t ms, int b, int block,
                                             float (*red)[kMaxBlock],
                                             float* ctr) {
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const int row = b * block + i;
    const float wq = q8[3 * ms + row] > 0.5f ? 1.0f : 0.0f;
    red[0][i] = wq;
    red[1][i] = mul_rn(q8[row], wq);
    red[2][i] = mul_rn(q8[ms + row], wq);
    red[3][i] = mul_rn(q8[2 * ms + row], wq);
  }
  for (int s = block / 2; s > 0; s >>= 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * s; i += blockDim.x) {
      const int k = i / s;
      const int j = i - k * s;
      red[k][j] = add_rn(red[k][j], red[k][j + s]);
    }
  }
  __syncthreads();
  const float cnt_q = fmaxf(red[0][0], 1.0f);
  ctr[0] = div_rn(red[1][0], cnt_q);
  ctr[1] = div_rn(red[2][0], cnt_q);
  ctr[2] = div_rn(red[3][0], cnt_q);
}

template <int kQ>
__global__ void __launch_bounds__(kMaxBlock)
moments_kernel(const float* __restrict__ q8, const float* __restrict__ packed,
               const int* __restrict__ lo, const int* __restrict__ len, int m,
               int block, int slices, float r2, float* __restrict__ out) {
  __shared__ float4 tile[2][kRowTile];
  __shared__ float red[4][kMaxBlock];
  const Item it = item_of(block, slices);
  const size_t ms = static_cast<size_t>(m);
  // Query i of this thread: row q0 + tid + i·blockDim, so that query i of
  // a warp's threads are 32 consecutive rows, as a warp's queries are with
  // one query a thread.
  int row[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) row[i] = it.q0 + threadIdx.x + i * blockDim.x;
  if (!block_live(len, it.b)) {  // the rows of an empty walk
    const float zero[9] = {};
    float v[3];
    moments_normal(zero, 0, v);
#pragma unroll
    for (int i = 0; i < kQ; ++i) moments_write(v, 0, q8, ms, row[i], out);
    return;
  }
  float ctr[3];
  block_centre(q8, ms, it.b, block, red, ctr);
  const float cx = ctr[0], cy = ctr[1], cz = ctr[2];
  float qx[kQ], qy[kQ], qz[kQ];
  float mom[kQ][9];
  int cnt[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    qx[i] = q8[row[i]];
    qy[i] = q8[ms + row[i]];
    qz[i] = q8[2 * ms + row[i]];
#pragma unroll
    for (int k = 0; k < 9; ++k) mom[i][k] = 0.0f;
    cnt[i] = 0;
  }
  int wlo[kWindows], whi[kWindows], ntile[kWindows];
  const int total = window_tiles<kRowTile>(lo, len, it.b, wlo, whi, ntile);
  auto stage = [&](int t) {
    int start, nt;
    tile_at<kRowTile>(t, ntile, wlo, whi, start, nt);
    // Plane r of row c lands in component r of tile[.][c].
    stage_tile<3, 1, 4, kRowTile>(&tile[t & 1][0].x, packed, ms, start, nt);
  };
  stage(0);  // a live block has a tile
#pragma unroll 1
  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) {
      stage(t + 1);
      tpu3d::cp_async_wait<1>();
    } else {
      tpu3d::cp_async_wait<0>();
    }
    __syncthreads();
    int start, nt;
    tile_at<kRowTile>(t, ntile, wlo, whi, start, nt);
    (void)start;
    const float4* buf = tile[t & 1];
#pragma unroll 1
    for (int j0 = 0; j0 < nt; j0 += 32) {
      // One shared load a candidate serves the thread's kQ queries. Columns
      // past nt hold stale rows; the mask drops them.
      unsigned hit[kQ];
#pragma unroll
      for (int i = 0; i < kQ; ++i) hit[i] = 0u;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float4 p = buf[j0 + k];
#pragma unroll
        for (int i = 0; i < kQ; ++i) {
          if (tpu3d::dist2(p.x, p.y, p.z, qx[i], qy[i], qz[i]) <= r2)
            hit[i] |= 1u << k;
        }
      }
      const unsigned keep = nt - j0 < 32 ? (1u << (nt - j0)) - 1u : ~0u;
#pragma unroll
      for (int i = 0; i < kQ; ++i) {
        unsigned h = hit[i] & keep;
#pragma unroll 1
        while (h != 0u) {
          const float4 p = buf[j0 + __ffs(h) - 1];
          h &= h - 1u;
          const float e0 = sub_rn(p.x, cx);
          const float e1 = sub_rn(p.y, cy);
          const float e2 = sub_rn(p.z, cz);
          float* a = mom[i];
          a[0] = add_rn(a[0], e0);
          a[1] = add_rn(a[1], e1);
          a[2] = add_rn(a[2], e2);
          a[3] = add_rn(a[3], mul_rn(e0, e0));
          a[4] = add_rn(a[4], mul_rn(e1, e1));
          a[5] = add_rn(a[5], mul_rn(e2, e2));
          a[6] = add_rn(a[6], mul_rn(e0, e1));
          a[7] = add_rn(a[7], mul_rn(e0, e2));
          a[8] = add_rn(a[8], mul_rn(e1, e2));
          ++cnt[i];
        }
      }
    }
    __syncthreads();  // the buffer is free for tile t + 2
  }
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    float v[3];
    moments_normal(mom[i], cnt[i], v);
    moments_write(v, cnt[i], q8, ms, row[i], out);
  }
}

// ---- K3 ------------------------------------------------------------------
//
// Two kernels, chosen by spfh_plan (ops/features.py), with K2's slices and
// empty blocks:
//   - spfh_kernel: one thread per query tests kSub candidates at a time
//     into a bit mask (the xyz tile holds a float4 a row, read as a
//     broadcast); the warp queues its neighbours, (query, column) pairs, in
//     a shared-memory ring, and each time 32 have gathered every lane takes
//     one, computes its Darboux angles and their three bins (the number of
//     thresholds at or below each) and adds them to its query's integer
//     histogram in shared memory by atomic adds. The angle work (~100
//     operations, two divisions and a square root) so runs on neighbours
//     only, 32 at a time: one thread per query ran it whenever one lane of
//     its warp had a neighbour (~85 % of the lanes idle at the dense 1M
//     shape), and a loop over each thread's own mask would run it as often
//     as the busiest lane has neighbours. Shared memory (the tiles, the
//     histograms, the rings) bounds its occupancy: six CTAs of 128 queries
//     an SM. So the query data come by shuffles from their lanes, not from
//     shared memory;
//   - spfh_lanes_kernel, for small layouts and the sparse prepare: a warp
//     takes one query at a time and its lanes test 32 candidates at once,
//     so a block's queries spread over 8 warps a 32-query slice; the
//     ballot's neighbours join the same kind of queue as (query, column,
//     d2) and are binned 32 at a time alike.
// Integer counts do not depend on the order in which pairs arrive, and each
// pair's angles are rounded once an operation as before, so the histograms
// equal the earlier design's and the plain version's bit for bit.

constexpr int kSpfhPlanes = 10;
constexpr int kSpfhQueue = 64;  // 31 left over + 32 appended at most

// The Darboux angles of one pair: the query's centred p, its normal n and
// b = p × n; the candidate's column c = (xyz, b, n, a = p·n); d2 their
// squared distance. The earlier kernel's arithmetic, operation for
// operation.
__device__ __forceinline__ void darboux(float px, float py, float pz,
                                        float nx, float ny, float nz,
                                        float bx, float by, float bz,
                                        const float* c, float d2,
                                        float& alpha, float& phi,
                                        float& dth) {
  const float anum = add_rn(
      add_rn(add_rn(add_rn(add_rn(mul_rn(nx, c[3]), mul_rn(ny, c[4])),
                           mul_rn(nz, c[5])),
                    mul_rn(bx, c[6])),
             mul_rn(by, c[7])),
      mul_rn(bz, c[8]));
  const float cn =
      add_rn(add_rn(mul_rn(nx, c[6]), mul_rn(ny, c[7])), mul_rn(nz, c[8]));
  const float pin =
      add_rn(add_rn(mul_rn(px, c[6]), mul_rn(py, c[7])), mul_rn(pz, c[8]));
  // 1/x rounded once, as the plain version's division of 1.
  const float inv_d = __frcp_rn(__fsqrt_rn(fmaxf(d2, 1e-24f)));
  const float dx = sub_rn(c[0], px);
  const float dy = sub_rn(c[1], py);
  const float dz = sub_rn(c[2], pz);
  phi = mul_rn(add_rn(add_rn(mul_rn(nx, dx), mul_rn(ny, dy)), mul_rn(nz, dz)),
               inv_d);
  const float e = mul_rn(sub_rn(c[9], pin), inv_d);
  alpha = mul_rn(anum, inv_d);
  const float s = sub_rn(mul_rn(phi, cn), e);
  const float u = div_rn(s, fmaxf(add_rn(fabsf(s), fabsf(cn)), 1e-30f));
  dth = cn >= 0.0f ? u : sub_rn(s >= 0.0f ? 2.0f : -2.0f, u);
}

// Rows q0 + [0, sq) of K3's output for a block without a window: zeros.
__device__ __forceinline__ void spfh_empty(size_t ms, int q0, int sq,
                                           float* __restrict__ out) {
  for (int i = threadIdx.x; i < 40 * sq; i += blockDim.x) {
    const int r = i / sq;
    out[r * ms + q0 + (i - r * sq)] = 0.0f;
  }
}

// The number of the ten ascending thresholds t at or below x: x's bin (a
// NaN falls in bin 0, as among the cumulative counts).
__device__ __forceinline__ int bin10(float x, const float* t) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) k += x >= t[i] ? 1 : 0;
  return k;
}

// spfh_kernel's queue: the (query, column) pairs of one warp's neighbours,
// a ring of kRing entries. A thread tests kSub candidates before its
// neighbours are queued, so at most 32 · kSub join the 31 left over.
constexpr int kSub = 8;
constexpr int kRing = 512;
static_assert(kRing >= 31 + 32 * kSub + 32, "the ring holds a step's pairs");

// Queued pairs [head, head + cnt) (cnt <= 32): lane k takes pair
// head + k, computes its angles and adds one to each of their bins in its
// query's histogram. The query's p and n come from the lane that owns it
// (a warp queues only its own queries); the candidate from the xyz tile and
// the seven planes beside it; d2 is recomputed as the distance test did.
__device__ __forceinline__ void spfh_flush_rows(
    const int* __restrict__ ring, int head, int cnt,
    const float4* __restrict__ xyz, const float (*pl)[kRowTile],
    const float* q, int sq, int* __restrict__ hist, const float* thr,
    int lane) {
  const int e = lane < cnt ? ring[(head + lane) & (kRing - 1)] : 0;
  const int ql = e >> 7;
  float qv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) qv[i] = __shfl_sync(0xffffffffu, q[i], ql & 31);
  if (lane < cnt) {
    const int j = e & (kRowTile - 1);
    const float px = qv[0], py = qv[1], pz = qv[2];
    const float nx = qv[3], ny = qv[4], nz = qv[5];
    const float bx = sub_rn(mul_rn(py, nz), mul_rn(pz, ny));
    const float by = sub_rn(mul_rn(pz, nx), mul_rn(px, nz));
    const float bz = sub_rn(mul_rn(px, ny), mul_rn(py, nx));
    const float4 p = xyz[j];
    float c[kSpfhPlanes];
    c[0] = p.x;
    c[1] = p.y;
    c[2] = p.z;
#pragma unroll
    for (int r = 3; r < kSpfhPlanes; ++r) c[r] = pl[r - 3][j];
    float alpha, phi, dth;
    darboux(px, py, pz, nx, ny, nz, bx, by, bz, c,
            tpu3d::dist2(p.x, p.y, p.z, px, py, pz), alpha, phi, dth);
    atomicAdd(&hist[bin10(alpha, thr) * sq + ql], 1);
    atomicAdd(&hist[(11 + bin10(phi, thr)) * sq + ql], 1);
    atomicAdd(&hist[(22 + bin10(dth, thr + 10)) * sq + ql], 1);
  }
  __syncwarp();
}

// Rows q0 + [0, sq) of K3's output from their histograms [33][sq]: bin /
// (3 · count), the count (the sum of the α bins, a whole number, so the L1
// norm is exact), six zero rows; coalesced along each output plane.
__device__ __forceinline__ void spfh_store(const int* __restrict__ hist,
                                           size_t ms, int q0, int sq,
                                           float* __restrict__ out) {
  for (int i = threadIdx.x; i < 40 * sq; i += blockDim.x) {
    const int r = i / sq;
    const int ql = i - r * sq;
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < 11; ++k) cnt += hist[k * sq + ql];
    float v = 0.0f;
    if (r < 33) {
      const float hf = static_cast<float>(hist[r * sq + ql]);
      const float norm = static_cast<float>(3 * cnt);
      v = norm > 0.0f ? div_rn(hf, fmaxf(norm, 1e-30f)) : hf;
    } else if (r == 33) {
      v = static_cast<float>(cnt);
    }
    out[r * ms + q0 + ql] = v;
  }
}

__global__ void __launch_bounds__(kMaxBlock)
spfh_kernel(const float* __restrict__ q8n, const float* __restrict__ packed,
            const int* __restrict__ lo, const int* __restrict__ len, int m,
            int block, int slices, float r2, Thresh th,
            float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const Item it = item_of(block, slices);
  const int sq = it.sq;  // one thread a query
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t ms = static_cast<size_t>(m);
  if (!block_live(len, it.b)) {
    spfh_empty(ms, it.q0, sq, out);
    return;
  }
  float4(*txyz)[kRowTile] = reinterpret_cast<float4(*)[kRowTile]>(smem4);
  float(*tpl)[kSpfhPlanes - 3][kRowTile] =
      reinterpret_cast<float(*)[kSpfhPlanes - 3][kRowTile]>(smem4 +
                                                             2 * kRowTile);
  int* hist = reinterpret_cast<int*>(&tpl[2][0][0]);  // [33][sq]
  int* ring = hist + 33 * sq + warp * kRing;
  const int row = it.q0 + tid;
  // This thread's query: centred p, then n.
  const float q[6] = {q8n[row],          q8n[ms + row],
                      q8n[2 * ms + row], q8n[4 * ms + row],
                      q8n[5 * ms + row], q8n[6 * ms + row]};
  const float px = q[0], py = q[1], pz = q[2];
  for (int i = tid; i < 33 * sq; i += sq) hist[i] = 0;
  float thr[kThresh];  // registers, not the parameter space
#pragma unroll
  for (int i = 0; i < kThresh; ++i) thr[i] = th.t[i];

  int wlo[kWindows], whi[kWindows], ntile[kWindows];
  const int total = window_tiles<kRowTile>(lo, len, it.b, wlo, whi, ntile);
  auto stage = [&](int t) {
    int start, nt;
    tile_at<kRowTile>(t, ntile, wlo, whi, start, nt);
    for (int i = tid; i < kSpfhPlanes * kRowTile; i += sq) {
      const int r = i / kRowTile;
      const int c = i - r * kRowTile;
      if (c < nt) {
        float* dst = r < 3 ? &txyz[t & 1][c].x + r : &tpl[t & 1][r - 3][c];
        tpu3d::cp_async4(dst, packed + r * ms + start + c);
      }
    }
    tpu3d::cp_async_commit();
  };
  stage(0);  // a live block has a tile
#pragma unroll 1
  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) {
      stage(t + 1);
      tpu3d::cp_async_wait<1>();
    } else {
      tpu3d::cp_async_wait<0>();
    }
    __syncthreads();
    int start, nt;
    tile_at<kRowTile>(t, ntile, wlo, whi, start, nt);
    (void)start;
    const float4* xyz = txyz[t & 1];
    const float(*pl)[kRowTile] = tpl[t & 1];
    int head = 0;  // the warp's queued pairs: [head, head + n) of the ring
    int n = 0;
#pragma unroll 1
    for (int j0 = 0; j0 < nt; j0 += kSub) {
      // Columns past nt hold stale rows; the mask drops them.
      unsigned hit = 0u;
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        const float4 p = xyz[j0 + k];
        const float d2 = tpu3d::dist2(p.x, p.y, p.z, px, py, pz);
        if (d2 <= r2 && d2 >= 1e-16f) hit |= 1u << k;
      }
      if (nt - j0 < kSub) hit &= (1u << (nt - j0)) - 1u;
      // Append this lane's pairs after those of the lanes below it.
      const int mine = __popc(hit);
      int incl = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int pos = head + n + incl - mine;
      while (hit != 0u) {
        ring[pos & (kRing - 1)] = (tid << 7) | (j0 + __ffs(hit) - 1);
        hit &= hit - 1u;
        ++pos;
      }
      n += __shfl_sync(0xffffffffu, incl, 31);
      while (n >= 32) {
        __syncwarp();
        spfh_flush_rows(ring, head, 32, xyz, pl, q, sq, hist, thr, lane);
        head += 32;
        n -= 32;
      }
    }
    if (n > 0) {  // the pairs left refer to this tile
      __syncwarp();
      spfh_flush_rows(ring, head, n, xyz, pl, q, sq, hist, thr, lane);
    }
    __syncthreads();  // the buffer is free for tile t + 2
  }
  spfh_store(hist, ms, it.q0, sq, out);
}

// The first `cnt` queued pairs: lane k takes pair k, computes its angles
// and adds one to each of their bins in its query's histogram.
__device__ __forceinline__ void spfh_flush(const int2* __restrict__ queue,
                                           int cnt,
                                           const float* __restrict__ buf,
                                           const float* __restrict__ qs,
                                           int sq, int* __restrict__ hist,
                                           const float* thr, int lane) {
  if (lane < cnt) {
    const int2 e = queue[lane];
    const int ql = e.x / kLaneTile;
    const int j = e.x - ql * kLaneTile;
    const float px = qs[ql];
    const float py = qs[sq + ql];
    const float pz = qs[2 * sq + ql];
    const float nx = qs[3 * sq + ql];
    const float ny = qs[4 * sq + ql];
    const float nz = qs[5 * sq + ql];
    const float bx = sub_rn(mul_rn(py, nz), mul_rn(pz, ny));
    const float by = sub_rn(mul_rn(pz, nx), mul_rn(px, nz));
    const float bz = sub_rn(mul_rn(px, ny), mul_rn(py, nx));
    float c[kSpfhPlanes];
#pragma unroll
    for (int r = 0; r < kSpfhPlanes; ++r) c[r] = buf[r * kLaneStride + j];
    float alpha, phi, dth;
    darboux(px, py, pz, nx, ny, nz, bx, by, bz, c, __int_as_float(e.y), alpha,
            phi, dth);
    atomicAdd(&hist[bin10(alpha, thr) * sq + ql], 1);
    atomicAdd(&hist[(11 + bin10(phi, thr)) * sq + ql], 1);
    atomicAdd(&hist[(22 + bin10(dth, thr + 10)) * sq + ql], 1);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kMaxBlock)
spfh_lanes_kernel(const float* __restrict__ q8n,
                  const float* __restrict__ packed,
                  const int* __restrict__ lo, const int* __restrict__ len,
                  int m, int block, int slices, float r2, Thresh th,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  const Item it = item_of(block, slices);
  const int sq = it.sq;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qpw = sq / (nthr >> 5);
  const size_t ms = static_cast<size_t>(m);
  if (!block_live(len, it.b)) {
    spfh_empty(ms, it.q0, sq, out);
    return;
  }
  float* tiles = smem;                                   // [2][10][stride]
  float* qs = tiles + 2 * kSpfhPlanes * kLaneStride;     // [6][sq]: p, n
  int* hist = reinterpret_cast<int*>(qs + 6 * sq);       // [33][sq]
  int2* queue = reinterpret_cast<int2*>(hist + 33 * sq) + warp * kSpfhQueue;
  const unsigned below = (1u << lane) - 1u;
  float thr[kThresh];  // registers, not the parameter space
#pragma unroll
  for (int i = 0; i < kThresh; ++i) thr[i] = th.t[i];
  for (int i = tid; i < 6 * sq; i += nthr) {
    const int r = i / sq;  // q8n rows 0-2 (p), then 4-6 (n)
    qs[i] = q8n[(r < 3 ? r : r + 1) * ms + it.q0 + (i - r * sq)];
  }
  for (int i = tid; i < 33 * sq; i += nthr) hist[i] = 0;

  int wlo[kWindows], whi[kWindows], ntile[kWindows];
  const int total = window_tiles<kLaneTile>(lo, len, it.b, wlo, whi, ntile);
  auto stage = [&](int t) {
    int start, nt;
    tile_at<kLaneTile>(t, ntile, wlo, whi, start, nt);
    stage_tile<kSpfhPlanes, kLaneStride, 1, kLaneTile>(
        tiles + (t & 1) * kSpfhPlanes * kLaneStride, packed, ms, start, nt);
  };
  stage(0);
#pragma unroll 1
  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) {
      stage(t + 1);
      tpu3d::cp_async_wait<1>();
    } else {
      tpu3d::cp_async_wait<0>();
    }
    __syncthreads();
    int start, nt;
    tile_at<kLaneTile>(t, ntile, wlo, whi, start, nt);
    (void)start;
    const float* buf = tiles + (t & 1) * kSpfhPlanes * kLaneStride;
    int n = 0;  // queued pairs, the same on every lane
#pragma unroll 1
    for (int qi = 0; qi < qpw; ++qi) {
      const int ql = warp * qpw + qi;
      const float px = qs[ql];
      const float py = qs[sq + ql];
      const float pz = qs[2 * sq + ql];
#pragma unroll 1
      for (int j0 = 0; j0 < nt; j0 += 32) {
        const int j = j0 + lane;
        bool in = false;
        float d2 = 0.0f;
        if (j < nt) {
          d2 = tpu3d::dist2(buf[j], buf[kLaneStride + j],
                            buf[2 * kLaneStride + j], px, py, pz);
          in = d2 <= r2 && d2 >= 1e-16f;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, in);
        if (in) {
          queue[n + __popc(mask & below)] =
              make_int2(ql * kLaneTile + j, __float_as_int(d2));
        }
        n += __popc(mask);
        if (n >= 32) {
          __syncwarp();
          spfh_flush(queue, 32, buf, qs, sq, hist, thr, lane);
          n -= 32;
          int2 rest = make_int2(0, 0);
          if (lane < n) rest = queue[32 + lane];
          __syncwarp();
          if (lane < n) queue[lane] = rest;
        }
      }
    }
    if (n > 0) {
      __syncwarp();
      spfh_flush(queue, n, buf, qs, sq, hist, thr, lane);
    }
    __syncthreads();  // the buffer is free for tile t + 2
  }
  __syncthreads();
  spfh_store(hist, ms, it.q0, sq, out);
}

// ---- K4 ------------------------------------------------------------------
//
// What bounds it: the bin updates, 33 products and sums for each neighbour
// in the radius, beside the distance test of every (query, candidate) pair:
// 72.4 M of the 558.8 M pairs at the dense 1M shape, 115 k of 3.9 M at the
// sparse 100k one. Two kernels, chosen by the launch plan (fpfh_plan in
// ops/features.py), both timed by chip_smoke.py on every dense layout it
// runs, on an NVIDIA H100 80GB HBM3 at 700 W:
//   - a dense layout of more than five blocks per SM keeps the earlier
//     design, one thread per query with its 33 sums in registers, now with
//     the tiles double-buffered by cp.async. Spreading the bins across the
//     lanes measured 1.2x slower at 911 blocks, 1.5x at 1,151 and 1.8x at
//     the dense 1M shape (8,700): with 13 % of the pairs in the radius, a
//     warp step of 32 queries already feeds several neighbours to each of
//     its 33-sum updates, and the lane design pays a shuffle, two shared
//     loads and loop control for every neighbour on top of them;
//   - a block list (the sparse prepare: 32 query blocks whose windows run
//     long), or a layout of at most five blocks per SM (the 64-instance
//     batch's: 191 and 255 blocks, where it measured twice as fast), takes
//     fpfh_lanes_kernel, with the bins spread across the lanes. The
//     earlier design launched every block of the sparse layout, 24-32 of
//     them with windows, one thread a query: 24-32 of 132 SMs busy. Now:
//   - a warp takes one query at a time: its lanes compute the distances to
//     32 window rows, a ballot marks the rows in the radius, and those
//     lanes queue (row, d2) in shared memory in ascending row order; once
//     32 neighbours are queued (and at the end of each tile) the lanes take
//     one each for w = 1/d, and then for each queued neighbour in order
//     lane k adds w·SPFH_k[row] to the query's bin k (lane 0 also bin 32):
//     the reciprocal square root runs once per 32 neighbours, every lane
//     does useful work in the bin updates, and each sum keeps the plain
//     version's order;
//   - the query's 33 sums stay in registers for a tile and in shared
//     memory between tiles; the 36-plane tiles (plane stride 129, so lane
//     k reads plane 3 + k without bank conflicts) are double-buffered with
//     cp.async;
//   - each block gets a CTA per 32-query slice, 8 warps each, every slice
//     walking the block's windows (from L2), so the sparse prepare's 32
//     blocks become 256 CTAs of 8 warps.

constexpr int kFpfhTile = 128;
constexpr int kFpfhStride = kFpfhTile + 1;
constexpr int kFpfhPlanes = 36;
constexpr int kFpfhMaxThreads = 256;

// Queued neighbours a warp holds for its current query: (tile column, d2)
// pairs appended in ascending row order, turned into 32-wide bin updates
// once 32 have gathered (and at the end of each tile).
constexpr int kFpfhQueue = 64;

// The bin updates of the first `cnt` queued neighbours, in order: lanes
// compute w = 1/sqrt(d2) for one neighbour each (one reciprocal square root
// per 32 neighbours), then for each neighbour lane k adds w·SPFH_k (lane 0
// also bin 32).
__device__ __forceinline__ void fpfh_flush(int2* __restrict__ queue, int cnt,
                                           const float* __restrict__ buf,
                                           int lane, float& a, float& a32) {
  if (lane < cnt) {
    const float d2 = __int_as_float(queue[lane].y);
    // Each step rounded once: the reciprocal rounds as the plain version's
    // division of 1 does.
    queue[lane].y = __float_as_int(__frcp_rn(__fsqrt_rn(fmaxf(d2, 1e-24f))));
  }
  __syncwarp();
  const float* sp = buf + (3 + lane) * kFpfhStride;
  const float* s32 = buf + 35 * kFpfhStride;
#pragma unroll 4
  for (int i = 0; i < cnt; ++i) {
    const int2 e = queue[i];
    const float w = __int_as_float(e.y);
    a = add_rn(a, mul_rn(w, sp[e.x]));
    if (lane == 0) a32 = add_rn(a32, mul_rn(w, s32[e.x]));
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kFpfhMaxThreads)
fpfh_lanes_kernel(const float* __restrict__ q8,
                  const float* __restrict__ packed, const int* __restrict__ lo,
                  const int* __restrict__ len, const int* __restrict__ blocks,
                  int m, int block, int slices, float r2,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  float* tiles = smem;  // [2][36][kFpfhStride]
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sq = block / slices;
  float* acc = smem + 2 * kFpfhPlanes * kFpfhStride;  // [sq][33]
  float* qs = acc + sq * 33;  // [3][sq] query coordinates
  int2* queue = reinterpret_cast<int2*>(qs + 3 * sq) + warp * kFpfhQueue;
  const int qpw = sq / (nthr >> 5);
  const int bi = blockIdx.x / slices;
  const int b = blocks != nullptr ? blocks[bi] : bi;
  const int q0 = b * block + (blockIdx.x - bi * slices) * sq;
  const size_t ms = static_cast<size_t>(m);
  const unsigned below = (1u << lane) - 1u;

  for (int i = tid; i < sq * 33; i += nthr) acc[i] = 0.0f;
  for (int i = tid; i < 3 * sq; i += nthr) {
    const int r = i / sq;
    qs[i] = q8[r * ms + q0 + (i - r * sq)];
  }
  int wlo[kWindows], whi[kWindows], ntile[kWindows];
  const int total = window_tiles<kFpfhTile>(lo, len, b, wlo, whi, ntile);
  auto stage = [&](int t) {
    int start, nt;
    tile_at<kFpfhTile>(t, ntile, wlo, whi, start, nt);
    stage_tile<kFpfhPlanes, kFpfhStride, 1, kFpfhTile>(
        tiles + (t & 1) * kFpfhPlanes * kFpfhStride, packed, ms, start, nt);
  };
  if (total > 0) stage(0);
#pragma unroll 1
  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) {
      stage(t + 1);
      tpu3d::cp_async_wait<1>();
    } else {
      tpu3d::cp_async_wait<0>();
    }
    __syncthreads();
    int start, nt;
    tile_at<kFpfhTile>(t, ntile, wlo, whi, start, nt);
    (void)start;
    const float* buf = tiles + (t & 1) * kFpfhPlanes * kFpfhStride;
#pragma unroll 1
    for (int qi = 0; qi < qpw; ++qi) {
      const int ql = warp * qpw + qi;
      const float qx = qs[ql];
      const float qy = qs[sq + ql];
      const float qz = qs[2 * sq + ql];
      float a = acc[ql * 33 + lane];
      float a32 = lane == 0 ? acc[ql * 33 + 32] : 0.0f;
      int n = 0;  // queued neighbours, the same on every lane
#pragma unroll 1
      for (int c0 = 0; c0 < nt; c0 += 32) {
        const int j = c0 + lane;
        bool in = false;
        float d2 = 0.0f;
        if (j < nt) {
          d2 = tpu3d::dist2(buf[j], buf[kFpfhStride + j],
                            buf[2 * kFpfhStride + j], qx, qy, qz);
          in = d2 <= r2 && d2 >= 1e-16f;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, in);
        if (in) queue[n + __popc(mask & below)] = make_int2(j, __float_as_int(d2));
        n += __popc(mask);
        if (n >= 32) {
          __syncwarp();
          fpfh_flush(queue, 32, buf, lane, a, a32);
          n -= 32;
          int2 rest = make_int2(0, 0);
          if (lane < n) rest = queue[32 + lane];
          __syncwarp();
          if (lane < n) queue[lane] = rest;
        }
      }
      if (n > 0) {
        __syncwarp();
        fpfh_flush(queue, n, buf, lane, a, a32);
      }
      acc[ql * 33 + lane] = a;
      if (lane == 0) acc[ql * 33 + 32] = a32;
    }
    __syncthreads();  // the buffer is free for tile t + 2
  }
  __syncthreads();
  for (int i = tid; i < sq * 36; i += nthr) {
    const int ql = i / 36;
    const int c = i - ql * 36;
    out[static_cast<size_t>(q0 + ql) * 36 + c] =
        c < 33 ? acc[ql * 33 + c] : 0.0f;
  }
}

// The dense layout's K4: one thread per query and its 33 sums in
// registers, as the earlier design, the tiles now double-buffered with
// cp.async in 64-row halves (the same shared memory as one 128-row tile, so
// the same number of blocks stays resident on an SM).
constexpr int kDenseTile = 64;

__global__ void __launch_bounds__(kMaxBlock)
fpfh_kernel(const float* __restrict__ q8, const float* __restrict__ packed,
            const int* __restrict__ lo, const int* __restrict__ len, int m,
            float r2, float* __restrict__ out) {
  __shared__ float tile[2][kFpfhPlanes][kDenseTile];
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b = blockIdx.x;
  const int row = b * nthr + tid;
  const size_t ms = static_cast<size_t>(m);
  const float qx = q8[row];
  const float qy = q8[ms + row];
  const float qz = q8[2 * ms + row];

  float acc[33];
#pragma unroll
  for (int k = 0; k < 33; ++k) acc[k] = 0.0f;
  int wlo[kWindows], whi[kWindows], ntile[kWindows];
  const int total = window_tiles<kDenseTile>(lo, len, b, wlo, whi, ntile);
  auto stage = [&](int t) {
    int start, nt;
    tile_at<kDenseTile>(t, ntile, wlo, whi, start, nt);
    stage_tile<kFpfhPlanes, kDenseTile, 1, kDenseTile>(&tile[t & 1][0][0],
                                                       packed, ms, start, nt);
  };
  if (total > 0) stage(0);
#pragma unroll 1
  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) {
      stage(t + 1);
      tpu3d::cp_async_wait<1>();
    } else {
      tpu3d::cp_async_wait<0>();
    }
    __syncthreads();
    int start, nt;
    tile_at<kDenseTile>(t, ntile, wlo, whi, start, nt);
    (void)start;
    const float(*buf)[kDenseTile] = tile[t & 1];
#pragma unroll 1
    for (int j = 0; j < nt; ++j) {
      const float d2 = tpu3d::dist2(buf[0][j], buf[1][j], buf[2][j], qx, qy,
                                    qz);
      if (d2 <= r2 && d2 >= 1e-16f) {
        const float w = div_rn(1.0f, __fsqrt_rn(fmaxf(d2, 1e-24f)));
#pragma unroll
        for (int k = 0; k < 33; ++k)
          acc[k] = add_rn(acc[k], mul_rn(w, buf[3 + k][j]));
      }
    }
    __syncthreads();  // the buffer is free for tile t + 2
  }
  float* o = out + static_cast<size_t>(row) * 36;
#pragma unroll
  for (int k = 0; k < 33; ++k) o[k] = acc[k];
  o[33] = 0.0f;
  o[34] = 0.0f;
  o[35] = 0.0f;
}

bool bad_block(int block) { return block != 128 && block != 256; }

// A plan of K2's or K3's kernels: `slices` CTAs a block of `block` queries,
// `warps` warps a CTA; the thread kernels take `per` queries a thread, a
// lane kernel a whole number of the slice's queries on each warp.
bool bad_plan(int block, int slices, int warps, int lanes, int per = 1) {
  if (bad_block(block) || slices < 1 || block % slices != 0 || warps < 1 ||
      warps * 32 > kMaxBlock)
    return true;
  const int sq = block / slices;
  return lanes ? sq % warps != 0 : sq != warps * 32 * per;
}

// Dynamic shared memory of K3's kernels.
size_t spfh_smem(int sq, int warps) {
  return sizeof(float4) * 2 * kRowTile +
         sizeof(float) * 2 * (kSpfhPlanes - 3) * kRowTile +
         sizeof(int) * (33 * sq + kRing * warps);
}
size_t spfh_lanes_smem(int sq, int warps) {
  return sizeof(float) * (2 * kSpfhPlanes * kLaneStride + (6 + 33) * sq) +
         sizeof(int2) * kSpfhQueue * warps;
}

}  // namespace

extern "C" int tpu3d_moments_sweep(const void* q8, const void* packed,
                                   const void* lo, const void* len, int m,
                                   int nb, int block, int slices, int warps,
                                   int per, float r2, void* out,
                                   void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if ((per != 1 && per != 2 && per != 4) ||
      bad_plan(block, slices, warps, 0, per))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = per == 4   ? moments_kernel<4>
                : per == 2 ? moments_kernel<2>
                           : moments_kernel<1>;
  if (nb > 0) {
    kernel<<<nb * slices, warps * 32, 0, st>>>(
        static_cast<const float*>(q8), static_cast<const float*>(packed),
        static_cast<const int*>(lo), static_cast<const int*>(len), m, block,
        slices, r2, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpu3d_spfh_sweep(const void* q8n, const void* packed,
                                const void* lo, const void* len, int m, int nb,
                                int block, int slices, int warps, int lanes,
                                float r2, const void* thresh_host, void* out,
                                void* stream) {
  if (bad_plan(block, slices, warps, lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  Thresh th;
  for (int i = 0; i < kThresh; ++i)
    th.t[i] = static_cast<const float*>(thresh_host)[i];
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  const int sq = block / slices;
  auto kernel = lanes ? spfh_lanes_kernel : spfh_kernel;
  const size_t smem = lanes ? spfh_lanes_smem(sq, warps) : spfh_smem(sq, warps);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  kernel<<<nb * slices, warps * 32, smem, st>>>(
      static_cast<const float*>(q8n), static_cast<const float*>(packed),
      static_cast<const int*>(lo), static_cast<const int*>(len), m, block,
      slices, r2, th, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpu3d_fpfh_sweep(const void* q8, const void* packed,
                                const void* lo, const void* len,
                                const void* blocks, int m, int nblocks,
                                int block, int slices, int warps, float r2,
                                void* out, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (bad_block(block)) return static_cast<int>(cudaErrorInvalidValue);
  if (slices == 1) {  // every block, a thread a query
    if (blocks != nullptr || warps * 32 != block)
      return static_cast<int>(cudaErrorInvalidValue);
    if (nblocks > 0) {
      fpfh_kernel<<<nblocks, block, 0, st>>>(
          static_cast<const float*>(q8), static_cast<const float*>(packed),
          static_cast<const int*>(lo), static_cast<const int*>(len), m, r2,
          static_cast<float*>(out));
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (slices < 1 || block % slices != 0 || warps < 1 ||
      warps * 32 > kFpfhMaxThreads || (block / slices) % warps != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(
      sizeof(float) * (2 * kFpfhPlanes * kFpfhStride + (block / slices) * 36) +
      sizeof(int2) * kFpfhQueue * warps);
  cudaError_t err = cudaFuncSetAttribute(
      fpfh_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nblocks > 0) {
    fpfh_lanes_kernel<<<nblocks * slices, warps * 32, smem, st>>>(
        static_cast<const float*>(q8), static_cast<const float*>(packed),
        static_cast<const int*>(lo), static_cast<const int*>(len),
        static_cast<const int*>(blocks), m, block, slices, r2,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
