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
// What bounds it on an H100: at 1280x720 and r = 4 the whole frame is
// 74.6 M taps of ~8 fp32 operations and one expf each on 3.7 MB in and
// 3.7 MB out, so the bytes (~0.002 ms) and the fp32 operations (~0.009
// ms) are both below the expf work on the special-function units (16 per
// clock per SM), a floor near 0.02 ms, and a tap's ~17 issue slots (the
// accurate expf is eight of them) put the whole frame near 0.04 ms. The
// pipeline filters a frame already masked to one instance, where ~89 % of
// the centres are zero, so the design spends nothing on them:
//   - a CTA of 32 x 8 threads covers 32 x 16 pixels, kP = 2 vertically
//     adjacent pixels a thread; one whose centres are all zero writes
//     zeros and stages no halo (__syncthreads_or), and a thread whose kP
//     centres are all zero leaves before the tap loop (whole warps of
//     zero centres retire);
//   - a live CTA stages its tile plus the radius-R halo in shared memory
//     once; the radius is a template parameter, so the tap loops unroll:
//     every shared read sits at a fixed offset, each staged neighbour is
//     read once for the kP pixels whose windows hold it, and the spatial
//     terms are launch arguments (constant-bank operands).
// The Pallas kernel kept the frame and all taps in VMEM. The spatial term
// of each tap is computed on the host in double and rounded to fp32, as
// the reference computes (dx^2 + dy^2) * inv_s2 in Python before it meets
// fp32. Each pixel's taps run dy outer and dx inner, the reference's
// order, and every operation is a _rn intrinsic (no FMA contraction) with
// the accurate expf, so each pixel's sums round in the plain version's
// order. Two pixels a thread is the fastest of one, two and four on
// masked frames, the frames the pipeline filters: on an H100 at 700 W
// 0.0202 / 0.0176 / 0.0206 ms device at r = 4 (chip_smoke.py, medians
// of six runs, the run PERF.md's section 6 reports).

#include <cuda_runtime.h>

namespace {

constexpr int kBx = 32;
constexpr int kBy = 8;
constexpr int kMaxR = 5;
constexpr int kMaxK = 2 * kMaxR + 1;
constexpr int kP = 2;  // vertically adjacent pixels a thread

// The spatial term of tap (dy, dx), at t[dy + r][dx + r].
struct Spatial {
  float t[kMaxK][kMaxK];
};

template <int R>
__global__ void __launch_bounds__(kBx * kBy)
bilateral_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
                 int w, const Spatial sp, float inv_r2) {
  constexpr int kTw = kBx + 2 * R;
  constexpr int kTh = kBy * kP + 2 * R;
  __shared__ float tile[kTh * kTw];
  const int x = blockIdx.x * kBx + threadIdx.x;
  const int y0 = blockIdx.y * (kBy * kP) + threadIdx.y * kP;
  float c[kP];
  bool live = false;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    c[p] = (x < w && y0 + p < h) ? in[(size_t)(y0 + p) * w + x] : 0.0f;
    live |= c[p] > 0.0f;
  }
  auto write_zeros = [&]() {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (x < w && y0 + p < h) out[(size_t)(y0 + p) * w + x] = 0.0f;
    }
  };
  if (!__syncthreads_or(live)) {  // every centre of the CTA is zero
    write_zeros();
    return;
  }
  const int gx0 = blockIdx.x * kBx - R;
  const int gy0 = blockIdx.y * (kBy * kP) - R;
  for (int i = threadIdx.y * kBx + threadIdx.x; i < kTh * kTw;
       i += kBx * kBy) {
    const int ty = i / kTw;
    const int gy = gy0 + ty;
    const int gx = gx0 + i - ty * kTw;
    tile[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                  ? in[(size_t)gy * w + gx]
                  : 0.0f;
  }
  __syncthreads();
  if (!live) {
    write_zeros();
    return;
  }
  float sum_w[kP], sum_v[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) sum_w[p] = sum_v[p] = 0.0f;
  // Staged row s of the thread's window rows serves pixel p at dy = s - p.
  const float* base = tile + threadIdx.y * kP * kTw + threadIdx.x;
#pragma unroll
  for (int s = 0; s < kP + 2 * R; ++s) {
#pragma unroll
    for (int dx = 0; dx <= 2 * R; ++dx) {
      const float nb = base[s * kTw + dx];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int dy = s - p;
        if (dy >= 0 && dy <= 2 * R && nb > 0.0f) {
          const float rd = __fsub_rn(nb, c[p]);
          const float wgt = expf(__fadd_rn(
              sp.t[dy][dx], __fmul_rn(__fmul_rn(rd, rd), inv_r2)));
          sum_w[p] = __fadd_rn(sum_w[p], wgt);
          sum_v[p] = __fadd_rn(sum_v[p], __fmul_rn(wgt, nb));
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    if (x < w && y0 + p < h) {
      const float o = sum_w[p] > 0.0f
                          ? __fdiv_rn(sum_v[p], fmaxf(sum_w[p], 1e-30f))
                          : c[p];
      out[(size_t)(y0 + p) * w + x] = c[p] > 0.0f ? o : 0.0f;
    }
  }
}

template <int R>
void launch_r(const float* in, float* out, int h, int w, const Spatial& sp,
              float inv_r2, cudaStream_t stream) {
  const dim3 grid((w + kBx - 1) / kBx, (h + kBy * kP - 1) / (kBy * kP));
  bilateral_kernel<R><<<grid, dim3(kBx, kBy), 0, stream>>>(in, out, h, w, sp,
                                                           inv_r2);
}

}  // namespace

// in, out f32[h, w]; r the radius (0-5); inv_s2 and inv_r2 the weights'
// exponent factors.
extern "C" int tpu3d_bilateral_filter(const void* in, void* out, int h, int w,
                                      int r, double inv_s2, float inv_r2,
                                      void* stream) {
  if (r < 0 || r > kMaxR) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Spatial sp{};
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      sp.t[dy + r][dx + r] =
          static_cast<float>(static_cast<double>(dx * dx + dy * dy) * inv_s2);
    }
  }
  const auto* src = static_cast<const float*>(in);
  auto* dst = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (h > 0 && w > 0) {
    switch (r) {
      case 0: launch_r<0>(src, dst, h, w, sp, inv_r2, st); break;
      case 1: launch_r<1>(src, dst, h, w, sp, inv_r2, st); break;
      case 2: launch_r<2>(src, dst, h, w, sp, inv_r2, st); break;
      case 3: launch_r<3>(src, dst, h, w, sp, inv_r2, st); break;
      case 4: launch_r<4>(src, dst, h, w, sp, inv_r2, st); break;
      default: launch_r<5>(src, dst, h, w, sp, inv_r2, st); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
