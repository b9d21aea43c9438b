// K7: fused ICP point-to-plane statistics over slab windows.
//
// Replaces tpu3d/ops/icp_pallas.py: icp_p2plane_stats_pallas
// (_stats_kernel) with the window semantics of tpu3d/ops/pallas_walk.py:
// window_walk (K1, one window per block). For each query block b:
//   - each query's nearest target among the slab-sorted rows
//     [lo_b, lo_b + len_b), the lowest row winning ties (strict '<' in
//     ascending row order); invalid targets carry 3e4 sentinel coordinates;
//   - keep = mask && d2 <= thr2 (inclusive);
//   - J = [p x n | n] with the transformed p, r = (p - q).n;
//   - the block's partial sums: the 21 upper-triangle entries of J^T J,
//     the 6 of J^T r, n_corr and sum d2, as one row of 32 floats
//     (3 zero fillers). The sum over blocks stays outside the kernel.
//
// What bounds it on an H100: the window walk, about N * window rows of
// 3-D distance work per iteration (8,192 queries x a few hundred rows),
// with every target row read by a whole block. Design: one block per
// query block and one thread per query; the window's coordinates and
// normals go through shared memory in 256-row tiles, read as broadcasts.
// Distances use __fmul_rn/__fadd_rn so d2 rounds exactly as the plain
// PyTorch version's separate elementwise ops do: matches, n_corr and the
// threshold test agree bit for bit. The block's 29 sums are a
// shared-memory tree reduction in a fixed order: deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kSub = 256;
constexpr int kMaxBlock = 256;
constexpr int kOut = 32;
constexpr int kVals = 29;

__global__ void __launch_bounds__(kMaxBlock)
icp_stats_kernel(const float* __restrict__ pts, const float* __restrict__ qmask,
                 const float* __restrict__ packed, const int* __restrict__ lo,
                 const int* __restrict__ len, int m, float thr2,
                 float* __restrict__ out) {
  __shared__ float c_s[6][kSub];
  __shared__ float red[kMaxBlock];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int row = b * nthr + tid;

  const float px = pts[row * 3 + 0];
  const float py = pts[row * 3 + 1];
  const float pz = pts[row * 3 + 2];
  const bool valid = qmask[row] > 0.5f;

  float bd = 1.0e30f;
  float bqx = 0.f, bqy = 0.f, bqz = 0.f, bnx = 0.f, bny = 0.f, bnz = 0.f;
  const int lo_b = lo[b];
  const int hi_b = lo_b + len[b];
  for (int start = lo_b; start < hi_b; start += kSub) {
    const int nt = min(kSub, hi_b - start);
    __syncthreads();
    for (int i = tid; i < 6 * kSub; i += nthr) {
      const int r = i / kSub;
      const int c = i - r * kSub;
      c_s[r][c] = c < nt ? packed[(size_t)r * m + start + c] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      const float dx = __fsub_rn(c_s[0][j], px);
      const float dy = __fsub_rn(c_s[1][j], py);
      const float dz = __fsub_rn(c_s[2][j], pz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < bd) {
        bd = d2;
        bqx = c_s[0][j];
        bqy = c_s[1][j];
        bqz = c_s[2][j];
        bnx = c_s[3][j];
        bny = c_s[4][j];
        bnz = c_s[5][j];
      }
    }
  }

  const bool keep = valid && bd <= thr2;
  const float wf = keep ? 1.0f : 0.0f;
  const float J[6] = {py * bnz - pz * bny, pz * bnx - px * bnz,
                      px * bny - py * bnx, bnx, bny, bnz};
  const float r = (px - bqx) * bnx + (py - bqy) * bny + (pz - bqz) * bnz;

  float vals[kVals];
  int v = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) vals[v++] = (J[i] * wf) * J[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) vals[v++] = (J[i] * wf) * (r * wf);
  vals[v++] = wf;
  vals[v++] = keep ? bd : 0.0f;

#pragma unroll
  for (int k = 0; k < kVals; ++k) {
    __syncthreads();
    red[tid] = vals[k];
    __syncthreads();
    for (int stride = nthr / 2; stride > 0; stride >>= 1) {
      if (tid < stride) red[tid] += red[tid + stride];
      __syncthreads();
    }
    if (tid == 0) out[(size_t)b * kOut + k] = red[0];
  }
  if (tid < kOut - kVals) out[(size_t)b * kOut + kVals + tid] = 0.0f;
}

}  // namespace

extern "C" int tpu3d_icp_p2plane_stats(const void* pts, const void* qmask,
                                       const void* packed, const void* lo,
                                       const void* len, int m, int nb,
                                       int block, float thr2, void* out,
                                       void* stream) {
  if (block < 32 || block > kMaxBlock || (block & (block - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb > 0) {
    icp_stats_kernel<<<nb, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const float*>(qmask),
        static_cast<const float*>(packed), static_cast<const int*>(lo),
        static_cast<const int*>(len), m, thr2, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
