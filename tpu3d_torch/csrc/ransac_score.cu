// K6: fused RANSAC hypothesis scoring.
//
// Replaces tpu3d/ops/ransac_pallas.py: score_hypotheses_pallas
// (_score_kernel, with the bf16x3 product of ops/precision.py). For each
// hypothesis h over N correspondence rows:
//   err2 = F_n . W_h + pq_n + |t_h|^2     (rank-16 expansion, K-major)
//   inlier  <=>  err2 < thr2              (strict)
//   count = #inliers,  err = sum over inliers of max(err2, 0)
// Invalid rows carry pq = 1e30 and never count.
//
// What bounds it on an H100: arithmetic, H*N*16 fp32 FMAs (25,600 x 2,048
// per estimate chunk, 32 x 8,192 for the finalists) on a few MB of
// operands. The Pallas kernel existed to keep the (N x H) err2 plane out
// of HBM; here no plane exists at all. Design: one thread per hypothesis
// holds its 16 weights and |t|^2 in registers; a block streams the point
// factors through shared memory, 256 rows at a time, stored row-major
// (16 floats per row) so each row is four 16-byte broadcast reads. The
// count is an integer and the error sum a per-thread fp32 running sum in
// ascending row order: no atomics, so results are deterministic. fp32 FMA
// replaces the TPU's bf16x3 product.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileN = 256;
constexpr int kRank = 16;

__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ feat, const float* __restrict__ pq,
             const float* __restrict__ w, const float* __restrict__ tn,
             int n, int h, float thr2, float* __restrict__ cnt_out,
             float* __restrict__ err_out) {
  __shared__ __align__(16) float f_s[kTileN * kRank];
  __shared__ float pq_s[kTileN];
  const int hid = blockIdx.x * kThreads + threadIdx.x;

  float wv[kRank];
#pragma unroll
  for (int k = 0; k < kRank; ++k) wv[k] = hid < h ? w[(size_t)k * h + hid] : 0.0f;
  const float tnh = hid < h ? tn[hid] : 0.0f;

  int cnt = 0;
  float err = 0.0f;
  for (int base = 0; base < n; base += kTileN) {
    const int n_tile = min(kTileN, n - base);
    __syncthreads();
    for (int i = threadIdx.x; i < kTileN * kRank; i += kThreads) {
      const int k = i / kTileN;  // coalesced global reads along rows
      const int r = i - k * kTileN;
      f_s[r * kRank + k] = r < n_tile ? feat[(size_t)k * n + base + r] : 0.0f;
    }
    for (int r = threadIdx.x; r < kTileN; r += kThreads) {
      pq_s[r] = r < n_tile ? pq[base + r] : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < n_tile; ++r) {
      const float4* fr = reinterpret_cast<const float4*>(f_s + r * kRank);
      float cross = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < kRank / 4; ++k4) {
        const float4 f = fr[k4];
        cross = fmaf(f.x, wv[4 * k4 + 0], cross);
        cross = fmaf(f.y, wv[4 * k4 + 1], cross);
        cross = fmaf(f.z, wv[4 * k4 + 2], cross);
        cross = fmaf(f.w, wv[4 * k4 + 3], cross);
      }
      const float e2 = (cross + pq_s[r]) + tnh;
      if (e2 < thr2) {
        ++cnt;
        err += fmaxf(e2, 0.0f);
      }
    }
  }
  if (hid < h) {
    cnt_out[hid] = static_cast<float>(cnt);
    err_out[hid] = err;
  }
}

}  // namespace

extern "C" int tpu3d_ransac_score(const void* feat, const void* pq,
                                  const void* w, const void* tn, int n, int h,
                                  float thr2, void* cnt_out, void* err_out,
                                  void* stream) {
  if (h > 0) {
    const dim3 grid((h + kThreads - 1) / kThreads);
    score_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feat), static_cast<const float*>(pq),
        static_cast<const float*>(w), static_cast<const float*>(tn), n, h,
        thr2, static_cast<float*>(cnt_out), static_cast<float*>(err_out));
  }
  return static_cast<int>(cudaGetLastError());
}
