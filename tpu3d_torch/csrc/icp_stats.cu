// K7: one ICP correspondence pass over slab windows, in one launch.
//
// Replaces tpu3d/ops/icp_pallas.py: icp_p2plane_stats_pallas
// (_stats_kernel) with the window semantics of tpu3d/ops/pallas_walk.py:
// window_walk (K1, one window per block), and the per-query matches of the
// point-to-point branch of tpu3d/ops/icp.py: fused_slab_stats_fn. One CUDA
// block serves one query block of `block` source rows:
//   - P = R s + t per row, ((R_i0 s_x + R_i1 s_y) + R_i2 s_z) + t_i rounded
//     once per operation (the pose is a launch argument);
//   - the block's window [lo, hi) of the x-sorted target rows with x in
//     [min P_x - r, max P_x + r] over its valid rows (empty without one),
//     found by two warps in a 32-way search of sorted_x;
//   - each query's nearest target of the window, the lowest row winning
//     ties; invalid targets carry 3e4 sentinel coordinates;
//   - mode 0: keep = valid && d2 <= thr2 (inclusive), J = [p x n | n],
//     r = (p - q).n, the block's 29 sums (21 of J^T J, 6 of J^T r, n_corr,
//     sum d2) into parts[b], and the last block to finish sums the blocks'
//     rows into out[44] = J^T J (6 x 6) | J^T r | n_corr | sum d2;
//     mode 1: the query's P, d2 (1e30 for an empty window) and matched row
//     (-1 there).
//
// What bounds it on an H100: at the 1M target the window walk (16,384
// queries x ~4,900 rows, 8 operations each, ~0.01 ms of fp32 work); at
// 8,192 queries and 86-row windows nothing but latency: the launch, the
// window search and the reductions. The earlier design took the window of a
// block that mixes valid and padding rows up to the last target row (tens
// of thousands of rows for one block at the 100k pair; the matches kept are
// the same either way), ran one thread per
// query (2 warps a block, ~4 warps an SM at 1M), staged tiles with no
// overlap, reduced the 29 sums with ~230 barriers, and left the transform,
// the windows and the sum over blocks to a dozen PyTorch launches. Now:
//   - 8 lanes split each query's window, lane l taking rows l, l + 8, ...
//     (4 lanes measured within 10 % of 8, either way, at every shape
//     chip_smoke.py runs, on an NVIDIA H100 80GB HBM3 at 700 W); strict '<' keeps each lane's lowest row of its least d2,
//     and a butterfly of shuffles merges the lanes lexicographically on
//     (d2, row), so the match is the lowest row of the least d2 whatever
//     the split (bit for bit the plain version's);
//   - 512-row tiles of the coordinate planes are double-buffered with
//     cp.async, the next tile in flight while the current one is scanned;
//     normals are read only for the matched row;
//   - the 29 sums reduce by warp shuffles and one pass over the warps'
//     rows in shared memory (two barriers), in a fixed order; the last
//     block (an atomic ticket) sums the block rows in a fixed order too, so
//     the result is deterministic and one ICP iteration is one launch plus
//     its readback.
// Distances use __fmul_rn/__fadd_rn so d2 rounds as the plain PyTorch
// version's separate operations do: matches, n_corr and the threshold test
// agree bit for bit.

#include <cuda_runtime.h>

#include "window_walk.cuh"

namespace {

using tpu3d::add_rn;
using tpu3d::mul_rn;
using tpu3d::sub_rn;

constexpr int kLanes = 8;  // threads that split one query's window
constexpr int kTile = 512;  // window rows per shared-memory tile
constexpr int kMaxThreads = 512;
constexpr int kVals = 29;
constexpr int kPart = 32;  // floats per block row of parts
constexpr int kOut = 44;
constexpr float kBig = 1.0e30f;
constexpr float kPadQ = 2.9e4f;
constexpr unsigned kFull = 0xffffffffu;

struct Pose {
  float m[12];  // rows of [R | t]
};

// First index i of the ascending x[0, m) with x[i] >= v (right: x[i] > v),
// m when there is none: one warp probes 32 evenly spaced rows per step.
__device__ int warp_search(const float* __restrict__ x, int m, float v,
                           bool right) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = m;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + (lane + 1) * step - 1;
    bool p = true;
    if (idx < hi) {
      const float xi = x[idx];
      p = right ? (xi > v) : (xi >= v);
    }
    const unsigned hit = __ballot_sync(kFull, p);
    if (hit == 0) return hi;
    const int k = __ffs(hit) - 1;
    const int new_hi = min(lo + (k + 1) * step - 1, hi);
    lo = k == 0 ? lo : lo + k * step;
    hi = new_hi;
  }
  return lo;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
icp_stats_kernel(const float* __restrict__ src, const float* __restrict__ qmask,
                 const float* __restrict__ packed,
                 const float* __restrict__ sorted_x, int m, Pose pose,
                 float radius, float thr2, int mode, float* __restrict__ parts,
                 float* __restrict__ out, float* __restrict__ match_p,
                 float* __restrict__ match_d2, int* __restrict__ match_row,
                 int* __restrict__ counter) {
  __shared__ float tile[2][3][kTile];
  __shared__ float red[kMaxThreads / 32][kVals];
  __shared__ float wmin[kMaxThreads / 32], wmax[kMaxThreads / 32];
  __shared__ int win[2];
  __shared__ bool last;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int sl = tid % kLanes;  // this thread's lane of its query
  const int row = blockIdx.x * (nthr / kLanes) + tid / kLanes;

  // The transformed query; every lane of the group computes it.
  const float sx = src[row * 3 + 0];
  const float sy = src[row * 3 + 1];
  const float sz = src[row * 3 + 2];
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = add_rn(add_rn(add_rn(mul_rn(sx, pose.m[4 * i]),
                                mul_rn(sy, pose.m[4 * i + 1])),
                         mul_rn(sz, pose.m[4 * i + 2])),
                  pose.m[4 * i + 3]);
  }
  const float px = p[0], py = p[1], pz = p[2];
  const bool valid = qmask[row] > 0.5f;

  // The block's window, over its valid queries only.
  float mn = valid ? px : kPadQ;
  float mx = valid ? px : -kPadQ;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  }
  if (lane == 0) {
    wmin[warp] = mn;
    wmax[warp] = mx;
  }
  __syncthreads();
  if (warp < 2) {
    float v = warp == 0 ? wmin[0] : wmax[0];
    for (int w = 1; w < nwarps; ++w)
      v = warp == 0 ? fminf(v, wmin[w]) : fmaxf(v, wmax[w]);
    v = warp == 0 ? sub_rn(v, radius) : add_rn(v, radius);
    const int i = warp_search(sorted_x, m, v, warp == 1);
    if (lane == 0) win[warp] = i;
  }
  __syncthreads();
  const int lo_b = win[0];
  const int hi_b = max(win[1], lo_b);

  // The walk: tile t + 1 is copied while tile t is scanned.
  float bd = kBig;
  int brow = 0x7fffffff;
  const int ntiles = (hi_b - lo_b + kTile - 1) / kTile;
  auto stage = [&](int t) {
    const int start = lo_b + t * kTile;
    const int nt = min(kTile, hi_b - start);
    float(*buf)[kTile] = tile[t & 1];
    for (int i = tid; i < 3 * kTile; i += nthr) {
      const int r = i / kTile;
      const int c = i - r * kTile;
      if (c < nt) tpu3d::cp_async4(&buf[r][c], packed + (size_t)r * m + start + c);
    }
    tpu3d::cp_async_commit();
  };
  if (ntiles > 0) stage(0);
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage(t + 1);
      tpu3d::cp_async_wait<1>();
    } else {
      tpu3d::cp_async_wait<0>();
    }
    __syncthreads();
    const int start = lo_b + t * kTile;
    const int nt = min(kTile, hi_b - start);
    const float(*buf)[kTile] = tile[t & 1];
#pragma unroll 4
    for (int j = sl; j < nt; j += kLanes) {
      const float d2 = tpu3d::dist2(buf[0][j], buf[1][j], buf[2][j], px, py, pz);
      if (d2 < bd) {
        bd = d2;
        brow = start + j;
      }
    }
    __syncthreads();  // the buffer is free for tile t + 2
  }
  // Merge the lanes: the least d2, then the lowest row.
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    const float od = __shfl_xor_sync(kFull, bd, o);
    const int orow = __shfl_xor_sync(kFull, brow, o);
    if (od < bd || (od == bd && orow < brow)) {
      bd = od;
      brow = orow;
    }
  }
  const bool found = bd < kBig;

  if (mode == 1) {
    if (sl == 0) {
      match_p[row * 3 + 0] = px;
      match_p[row * 3 + 1] = py;
      match_p[row * 3 + 2] = pz;
      match_d2[row] = bd;
      match_row[row] = found ? brow : -1;
    }
    return;
  }

  // This query's terms, on its first lane only.
  float vals[kVals];
#pragma unroll
  for (int k = 0; k < kVals; ++k) vals[k] = 0.0f;
  if (sl == 0 && valid && bd <= thr2) {
    const float bqx = packed[brow];
    const float bqy = packed[(size_t)m + brow];
    const float bqz = packed[2 * (size_t)m + brow];
    const float bnx = packed[3 * (size_t)m + brow];
    const float bny = packed[4 * (size_t)m + brow];
    const float bnz = packed[5 * (size_t)m + brow];
    const float J[6] = {py * bnz - pz * bny, pz * bnx - px * bnz,
                        px * bny - py * bnx, bnx, bny, bnz};
    const float r = (px - bqx) * bnx + (py - bqy) * bny + (pz - bqz) * bnz;
    int v = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = i; j < 6; ++j) vals[v++] = J[i] * J[j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) vals[v++] = J[i] * r;
    vals[v++] = 1.0f;
    vals[v++] = bd;
  }
#pragma unroll
  for (int k = 0; k < kVals; ++k) {
    const float s = warp_sum(vals[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (tid < kPart) {
    float s = 0.0f;
    if (tid < kVals)
      for (int w = 0; w < nwarps; ++w) s += red[w][tid];
    parts[(size_t)blockIdx.x * kPart + tid] = s;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;

  // The last block: every block's row, summed in a fixed order.
  __threadfence();
  for (int k = warp; k < kVals; k += nwarps) {
    float s = 0.0f;
    for (int b = lane; b < static_cast<int>(gridDim.x); b += 32)
      s += __ldcg(parts + (size_t)b * kPart + k);
    s = warp_sum(s);
    if (lane == 0) red[0][k] = s;
  }
  __syncthreads();
  if (tid < kOut) {
    float v;
    if (tid < 36) {
      const int i = min(tid / 6, tid % 6);
      const int j = max(tid / 6, tid % 6);
      v = red[0][i * 6 - i * (i - 1) / 2 + (j - i)];
    } else {
      v = red[0][21 + (tid - 36)];
    }
    out[tid] = v;
  }
  if (tid == 0) *counter = 0;
}

}  // namespace

extern "C" int tpu3d_icp_p2plane_stats(
    const void* src, const void* qmask, const void* packed,
    const void* sorted_x, int m, int nb, int block, const void* pose_host,
    float radius, float thr2, int mode, void* parts, void* out, void* match_p,
    void* match_d2, void* match_row, void* counter, void* stream) {
  const int threads = block * kLanes;
  if ((threads != 64 && threads != 128 && threads != 256 && threads != 512) ||
      (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pose pose;
  for (int i = 0; i < 12; ++i)
    pose.m[i] = static_cast<const float*>(pose_host)[i];
  if (nb > 0) {
    icp_stats_kernel<<<nb, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<const float*>(qmask),
        static_cast<const float*>(packed), static_cast<const float*>(sorted_x),
        m, pose, radius, thr2, mode, static_cast<float*>(parts),
        static_cast<float*>(out), static_cast<float*>(match_p),
        static_cast<float*>(match_d2), static_cast<int*>(match_row),
        static_cast<int*>(counter));
  }
  return static_cast<int>(cudaGetLastError());
}
