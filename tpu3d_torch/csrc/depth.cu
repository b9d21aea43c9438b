// K9: edge-preserving bilateral filter of a depth frame.
//
// Replaces tpu3d/ops/depth.py: bilateral_filter(use_pallas=True)
// (_bf_kernel over _bilateral_math). For every pixel with centre depth
// c > 0, over the (2r+1)^2 window (frame outside reads as 0, as jnp.pad
// gives) and skipping neighbours nb <= 0:
//   w   = exp((dx^2 + dy^2) * inv_s2 + (nb - c)^2 * inv_r2)
//   out = sum(w * nb) / max(sum(w), 1e-30), or c where sum(w) == 0;
// a zero centre stays 0. r = min(int(2 sigma_s + 0.5), 5).
//
// What bounds it on an H100: at 1280x720 and r = 4 it is 74.6 M taps of
// ~8 fp32 operations and one expf each on 3.7 MB in and 3.7 MB out, so
// the bytes (~0.002 ms) and the fp32 operations (~0.009 ms) are both far
// below the expf work on the special-function units (16 per clock per
// SM), a floor near 0.02 ms. The Pallas kernel kept the frame and all
// taps in VMEM; here a block of 32x8 threads, one per output pixel,
// stages its tile plus the radius-r halo in shared memory once, so every
// tap is a shared-memory read. The spatial term of each tap is computed
// once per block in double and rounded to fp32, as the reference
// computes (dx^2 + dy^2) * inv_s2 in Python before it meets fp32. The
// loop runs dy outer and dx inner, the reference's order, and every
// operation is a _rn intrinsic (no FMA contraction) with the accurate
// expf, so each pixel's sums round in the plain version's order.

#include <cuda_runtime.h>

namespace {

constexpr int kBx = 32;
constexpr int kBy = 8;
constexpr int kMaxR = 5;
constexpr int kTaps = (2 * kMaxR + 1) * (2 * kMaxR + 1);

__global__ void __launch_bounds__(kBx * kBy)
bilateral_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
                 int w, int r, double inv_s2, float inv_r2) {
  __shared__ float tile[(kBy + 2 * kMaxR) * (kBx + 2 * kMaxR)];
  __shared__ float spatial[kTaps];
  const int tw = kBx + 2 * r;
  const int th = kBy + 2 * r;
  const int k = 2 * r + 1;
  const int x0 = blockIdx.x * kBx - r;
  const int y0 = blockIdx.y * kBy - r;
  const int tid = threadIdx.y * kBx + threadIdx.x;
  for (int i = tid; i < tw * th; i += kBx * kBy) {
    const int ty = i / tw;
    const int tx = i - ty * tw;
    const int gy = y0 + ty;
    const int gx = x0 + tx;
    tile[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                  ? in[(size_t)gy * w + gx]
                  : 0.0f;
  }
  for (int i = tid; i < k * k; i += kBx * kBy) {
    const int dy = i / k - r;
    const int dx = i % k - r;
    spatial[i] = __double2float_rn((double)(dx * dx + dy * dy) * inv_s2);
  }
  __syncthreads();

  const int x = blockIdx.x * kBx + threadIdx.x;
  const int y = blockIdx.y * kBy + threadIdx.y;
  if (x >= w || y >= h) return;
  const float c = tile[(threadIdx.y + r) * tw + threadIdx.x + r];
  float sum_w = 0.0f;
  float sum_v = 0.0f;
  for (int dy = 0; dy < k; ++dy) {
    const float* row = tile + (threadIdx.y + dy) * tw + threadIdx.x;
    const float* sp = spatial + dy * k;
    for (int dx = 0; dx < k; ++dx) {
      const float nb = row[dx];
      if (nb > 0.0f) {
        const float rd = __fsub_rn(nb, c);
        const float wgt =
            expf(__fadd_rn(sp[dx], __fmul_rn(__fmul_rn(rd, rd), inv_r2)));
        sum_w = __fadd_rn(sum_w, wgt);
        sum_v = __fadd_rn(sum_v, __fmul_rn(wgt, nb));
      }
    }
  }
  const float o = sum_w > 0.0f ? __fdiv_rn(sum_v, fmaxf(sum_w, 1e-30f)) : c;
  out[(size_t)y * w + x] = c > 0.0f ? o : 0.0f;
}

}  // namespace

extern "C" int tpu3d_bilateral_filter(const void* in, void* out, int h, int w,
                                      int r, double inv_s2, float inv_r2,
                                      void* stream) {
  if (r < 0 || r > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  if (h > 0 && w > 0) {
    const dim3 grid((w + kBx - 1) / kBx, (h + kBy - 1) / kBy);
    const dim3 block(kBx, kBy);
    bilateral_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(in), static_cast<float*>(out), h, w, r,
        inv_s2, inv_r2);
  }
  return static_cast<int>(cudaGetLastError());
}
