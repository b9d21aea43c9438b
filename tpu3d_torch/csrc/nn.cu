// K5: tiled brute-force top-1 nearest neighbour.
//
// Replaces tpu3d/ops/nn_pallas.py: nearest_neighbor_pallas (_nn_kernel),
// the MXU formulation d2 = |t|^2 - 2 t.s carried as a running min/argmin
// across target tiles. Used for the 33-D FPFH correspondences (Q = M =
// capacity) and for 3-D brute ICP matches below 4,096 target points.
//
// What bounds it on an H100: arithmetic. Q*M*D fp32 FMAs (8192^2 * 33 =
// 2.2 GFMA per call) against an operand set that fits in L2 (a few MB).
// Design: one thread per query keeps -2*q in registers (D is a runtime
// argument; the host picks the MAXD = 4 or 36 instantiation so the
// dimension loop unrolls into registers), and a block stages 128 target
// rows at a time through shared memory in ascending index order. Every
// thread reads the same target row at once, so the shared-memory reads
// are broadcasts. The update is a strict '<', so the lowest index wins
// ties, as in the reference scan. Invalid targets take the 1e6 sentinel
// coordinate, as in the Pallas wrapper. fp32 FMA replaces the TPU's
// bf16x3 / HIGHEST passes: it is exact-class and cheap here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 128;
constexpr float kSentinel = 1.0e6f;

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
nn_top1_kernel(const float* __restrict__ queries,
               const float* __restrict__ targets,
               const uint8_t* __restrict__ mask, int q, int m, int d,
               int* __restrict__ out_idx, float* __restrict__ out_d2) {
  __shared__ __align__(16) float t_s[kTile * MAXD];
  __shared__ float n_s[kTile];
  const int row = blockIdx.x * kThreads + threadIdx.x;

  float qm2[MAXD];
  float qn = 0.0f;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    const float v = (row < q && k < d) ? queries[(size_t)row * d + k] : 0.0f;
    qn = fmaf(v, v, qn);
    qm2[k] = -2.0f * v;
  }

  float best = 1.0e30f;
  int best_i = 0;
  for (int base = 0; base < m; base += kTile) {
    const int n_tile = min(kTile, m - base);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * MAXD; i += kThreads) {
      const int j = i / MAXD;
      const int k = i - j * MAXD;
      float v = 0.0f;
      if (j < n_tile && k < d) {
        v = mask[base + j] ? targets[(size_t)(base + j) * d + k] : kSentinel;
      }
      t_s[i] = v;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n_tile; j += kThreads) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < MAXD; ++k) s = fmaf(t_s[j * MAXD + k], t_s[j * MAXD + k], s);
      n_s[j] = s;
    }
    __syncthreads();
    for (int j = 0; j < n_tile; ++j) {
      float acc = n_s[j];
#pragma unroll
      for (int k = 0; k < MAXD; ++k) acc = fmaf(t_s[j * MAXD + k], qm2[k], acc);
      if (acc < best) {
        best = acc;
        best_i = base + j;
      }
    }
  }
  if (row < q) {
    out_idx[row] = best_i;
    out_d2[row] = fmaxf(best + qn, 0.0f);
  }
}

}  // namespace

extern "C" int tpu3d_nn_top1(const void* queries, const void* targets,
                             const void* mask, int q, int m, int d,
                             void* out_idx, void* out_d2, void* stream) {
  const dim3 grid((q + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(queries);
  const float* tp = static_cast<const float*>(targets);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  int* ip = static_cast<int*>(out_idx);
  float* dp = static_cast<float*>(out_d2);
  if (q > 0) {
    if (d <= 4) {
      nn_top1_kernel<4><<<grid, kThreads, 0, s>>>(qp, tp, mp, q, m, d, ip, dp);
    } else if (d <= 36) {
      nn_top1_kernel<36><<<grid, kThreads, 0, s>>>(qp, tp, mp, q, m, d, ip, dp);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
