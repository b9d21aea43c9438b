// K6: fused RANSAC hypothesis scoring on the tensor cores.
//
// Replaces tpu3d/ops/ransac_pallas.py: score_hypotheses_pallas
// (_score_kernel, with the bf16x3 product of ops/precision.py). For each
// hypothesis h over N correspondence rows:
//   err2 = F_n . W_h + pq_n + |t_h|^2     (rank-16 expansion, K-major)
//   inlier  <=>  err2 < thr2              (strict)
//   count = #inliers,  err = sum over inliers of max(err2, 0)
// Invalid rows carry pq = 1e30 and never count.
//
// What bounds it on an H100: arithmetic, 2*H*N*16 per call (25,600 x 2,048
// per estimate chunk) on a few MB of operands; the finalists (32 x 8,192)
// are bound by the launch. The Pallas kernel existed to keep the (N x H)
// err2 plane out of HBM; here no plane exists at all.
// Design:
// - Split over hypotheses and rows: a block of 4 warps takes 128
//   hypotheses (32 a warp, two m16 tiles) and a slice of R rows (R a
//   multiple of 32, picked by the wrapper so both main-path shapes launch
//   at least 132 blocks). The slice's factors, its pq and the block's
//   weights are staged in shared memory (factor row stride R + 8:
//   conflict-free B-fragment loads).
// - F.W by mma.sync m16n8k8 TF32 in 3xTF32 (hi = tf32(x), lo = tf32(x -
//   hi); e = hi.hi + (hi.lo + lo.hi)), hypotheses as A (their hi/lo
//   fragments split once, in registers), rows as B: K = 16 is two k-steps.
//   The epilogue works on the accumulator fragments: + pq, + |t|^2, the
//   threshold, the count and the sum, per thread over its own columns.
// - The threshold decides inlier sets, and 3xTF32 (~2^-21) is eight
//   times coarser than fp32, so rows within the rounding band of thr2
//   would flip against the fp32 scorer (about one finalist hypothesis in
//   32 on the bench pair, by emulation). An element whose 3xTF32 err2 lies
//   within band * (pq + 2)(|t|^2 + 3) of thr2 (the product of the two
//   operand norms bounds the sum of |F_k W_k|; band = 2^-19 is about ten
//   times the largest 3xTF32-against-fp32 difference measured) is
//   recomputed from the staged fp32 operands as the fp32 scorer does it:
//   sequential FMA over k, then + pq, then + |t|^2. So the inlier set is
//   the fp32 one.
// - The recompute is deferred, so that in-band elements do not stall the
//   warp's step: each lane counts all its elements by their 3xTF32 err2
//   and queues its in-band ones (row, slot, 3xTF32 err2) in shared
//   memory; when a queue may overflow, and at the end of the slice, the
//   warp drains the queues together, each lane recomputing its own
//   elements and replacing their contributions, in queue order. A lane
//   owns its elements, so no list is shared and nothing is scanned. (The
//   first design re-checked inside the step, running up to eight serial
//   16-FMA loops whenever any lane of the step had an in-band element:
//   ~61 % of the steps at the bucket-8,192 estimate's 0.59 % band share.)
// - Partials per (row slice, hypothesis): integer counts and fp32 sums (a
//   quad shuffle in a fixed order), reduced by a second kernel in a fixed
//   order over the slices (a warp per hypothesis). No atomics:
//   deterministic.
// Resources (nvcc -Xptxas -v, sm_90a): the scoring kernel 91 registers,
// no spills, (16 (R + 8) + 2 R + 6,272) x 4 bytes of dynamic shared memory
// (44,032 at R = 256: five blocks an SM, as the registers allow); the
// reduction 32 registers.
// Earlier design (one thread per hypothesis over all rows on the
// CUDA cores): 0.2067 ms at H 25,600 x N 2,048 and 0.5187 ms at H 32 x
// N 8,192 (one block on one SM; PERF.md, NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRank = 16;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kHypTile = kWarps * 32;  // hypotheses per block
constexpr int kQueue = 16;  // deferred in-band elements per lane
static_assert(kThreads == kHypTile, "one thread per staged weight column");

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// feat (16, N), pq (N), w (16, H), tn (H); partials (gridDim.y, H).
__global__ void __launch_bounds__(kThreads)
score_tc_kernel(const float* __restrict__ feat, const float* __restrict__ pq,
                const float* __restrict__ w, const float* __restrict__ tn,
                int n, int h, int rows_per_slice, float thr2, float band,
                int* __restrict__ part_cnt, float* __restrict__ part_err) {
  extern __shared__ __align__(16) float smem[];
  const int R = rows_per_slice;
  const int rs = R + 8;  // factor row stride: rs % 32 == 8
  float* f_s = smem;                  // (16, rs)
  float* pq_s = f_s + kRank * rs;     // (R)
  float* bq_s = pq_s + R;             // (R) band * (pq + 2)
  float* w_s = bq_s + R;              // (16, kHypTile)
  float* tn_s = w_s + kRank * kHypTile;  // (kHypTile)
  int* qc_s = reinterpret_cast<int*>(tn_s + kHypTile);  // (kWarps, kQueue, 32)
  float* qe_s = reinterpret_cast<float*>(qc_s + kWarps * kQueue * 32);
  const int r0 = blockIdx.y * R;
  const int rows = min(R, n - r0);
  const int hb = blockIdx.x * kHypTile;

  // Staging: every load of a thread's row (or weight column) is issued
  // before the first store, so their latencies overlap.
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool live = r < rows;
    float f[kRank];
#pragma unroll
    for (int k = 0; k < kRank; ++k) {
      f[k] = live ? feat[(size_t)k * n + r0 + r] : 0.0f;
    }
    const float v = live ? pq[r0 + r] : 1.0e30f;  // padded rows never count
#pragma unroll
    for (int k = 0; k < kRank; ++k) f_s[k * rs + r] = f[k];
    pq_s[r] = v;
    bq_s[r] = __fmul_rn(band, __fadd_rn(v, 2.0f));
  }
  {
    const int c = threadIdx.x;  // kThreads == kHypTile
    const bool live = hb + c < h;
    float wv[kRank];
#pragma unroll
    for (int k = 0; k < kRank; ++k) {
      wv[k] = live ? w[(size_t)k * h + hb + c] : 0.0f;
    }
    const float tv = live ? tn[hb + c] : 0.0f;
#pragma unroll
    for (int k = 0; k < kRank; ++k) w_s[k * kHypTile + c] = wv[k];
    tn_s[c] = tv;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wl = warp * 32;  // the warp's first hypothesis in the block
  if (hb + wl >= h) return;  // warp-uniform; no barrier follows
  // The warp's lane queues of in-band elements: entry i of a lane at
  // i * 32 + lane, its row in the slice and accumulator slot 4 mt + j
  // (row | slot << 8) in qc, its 3xTF32 err2 in qe.
  int* qc = qc_s + warp * kQueue * 32;
  float* qe = qe_s + warp * kQueue * 32;

  // A fragments (hypotheses): rows wl + 16 mt + {g, g + 8}, k 8 ks + {t, t + 4}.
  uint32_t a_hi[2][2][4], a_lo[2][2][4];
  float tnr[2][2], tn3[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int c = wl + 16 * mt + g;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float* wk = w_s + (8 * ks + t) * kHypTile;
      split_tf32(wk[c], a_hi[mt][ks][0], a_lo[mt][ks][0]);
      split_tf32(wk[c + 8], a_hi[mt][ks][1], a_lo[mt][ks][1]);
      split_tf32(wk[4 * kHypTile + c], a_hi[mt][ks][2], a_lo[mt][ks][2]);
      split_tf32(wk[4 * kHypTile + c + 8], a_hi[mt][ks][3], a_lo[mt][ks][3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tnr[mt][hh] = tn_s[c + 8 * hh];
      tn3[mt][hh] = __fadd_rn(tnr[mt][hh], 3.0f);
    }
  }

  int cnt[2][2] = {};
  float err[2][2] = {};
  // Every element is counted by its 3xTF32 err2; the lane's in-band ones
  // also go to its queue, and a drain replaces each one's contribution by
  // that of its fp32 err2. The lanes drain together, one element each a
  // turn, as many turns as the longest queue.
  int qlen = 0;
  auto drain = [&]() {
    int most = qlen;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      most = max(most, __shfl_xor_sync(0xffffffffu, most, off));
    }
    for (int i = 0; i < most; ++i) {
      if (i < qlen) {
        const int code = qc[i * 32 + lane];
        const float etc = qe[i * 32 + lane];
        const int col = code & 0xff;
        const int s = code >> 8;
        const int mt_ = s >> 2, hh_ = (s >> 1) & 1;
        const int hl = wl + 16 * mt_ + 8 * hh_ + g;
        // The fp32 scorer's arithmetic: sequential FMA, + pq, + |t|^2.
        float cross = 0.0f;
#pragma unroll
        for (int k = 0; k < kRank; ++k) {
          cross = fmaf(f_s[k * rs + col], w_s[k * kHypTile + hl], cross);
        }
        const float e = __fadd_rn(__fadd_rn(cross, pq_s[col]), tn_s[hl]);
        const bool in = e < thr2, in_tc = etc < thr2;
        const float fix = __fsub_rn(in ? fmaxf(e, 0.0f) : 0.0f,
                                    in_tc ? fmaxf(etc, 0.0f) : 0.0f);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if ((in || in_tc) && mt_ == mt && hh_ == hh) {
              cnt[mt][hh] += int(in) - int(in_tc);
              err[mt][hh] = __fadd_rn(err[mt][hh], fix);
            }
          }
        }
      }
    }
    qlen = 0;
  };

  for (int n0 = 0; n0 < rows; n0 += 8) {
    float big[2][4] = {}, small[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // B fragment (rows): column n0 + g, k 8 ks + {t, t + 4}.
      uint32_t b0h, b0l, b1h, b1l;
      split_tf32(f_s[(8 * ks + t) * rs + n0 + g], b0h, b0l);
      split_tf32(f_s[(8 * ks + t + 4) * rs + n0 + g], b1h, b1l);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_tf32(small[mt], a_lo[mt][ks], b0h, b1h);
        mma_tf32(small[mt], a_hi[mt][ks], b0l, b1l);
        mma_tf32(big[mt], a_hi[mt][ks], b0h, b1h);
      }
    }
    // Accumulator j: hypothesis row g + 8 (j >> 1), column n0 + 2t + (j & 1).
    const int c0 = n0 + 2 * t;
    const float pq2[2] = {pq_s[c0], pq_s[c0 + 1]};
    const float bq2[2] = {bq_s[c0], bq_s[c0 + 1]};
    float e[2][4];
    bool near = false;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hh = j >> 1;
        e[mt][j] = __fadd_rn(__fadd_rn(__fadd_rn(big[mt][j], small[mt][j]),
                                       pq2[j & 1]),
                             tnr[mt][hh]);
        near |= fabsf(__fsub_rn(e[mt][j], thr2)) <=
                __fmul_rn(bq2[j & 1], tn3[mt][hh]);
        const bool in = e[mt][j] < thr2;
        cnt[mt][hh] += in;
        err[mt][hh] = in ? __fadd_rn(err[mt][hh], fmaxf(e[mt][j], 0.0f))
                         : err[mt][hh];
      }
    }
    if (__any_sync(0xffffffffu, near)) {
      if (near) {  // queue the lane's in-band elements
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int hh = j >> 1;
            if (fabsf(__fsub_rn(e[mt][j], thr2)) <=
                __fmul_rn(bq2[j & 1], tn3[mt][hh])) {
              qc[qlen * 32 + lane] = (c0 + (j & 1)) | ((4 * mt + j) << 8);
              qe[qlen * 32 + lane] = e[mt][j];
              ++qlen;
            }
          }
        }
      }
      // Room for the next step's eight.
      if (__any_sync(0xffffffffu, qlen > kQueue - 8)) drain();
    }
  }
  if (__any_sync(0xffffffffu, qlen > 0)) drain();

  // Quad reduction in a fixed order, then one partial per hypothesis.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      int c = cnt[mt][hh];
      float e = err[mt][hh];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        c += __shfl_xor_sync(0xffffffffu, c, off);
        e = __fadd_rn(e, __shfl_xor_sync(0xffffffffu, e, off));
      }
      const int hy = hb + wl + 16 * mt + 8 * hh + g;
      if (t == 0 && hy < h) {
        part_cnt[(size_t)blockIdx.y * h + hy] = c;
        part_err[(size_t)blockIdx.y * h + hy] = e;
      }
    }
  }
}

// One warp per hypothesis, so the finalists' 256 slices are 8 loads a
// lane: lane l sums slices l, l + 32, ... in ascending order, then a
// butterfly over the lanes; the order does not depend on the run.
__global__ void __launch_bounds__(256)
score_reduce(const int* __restrict__ part_cnt,
             const float* __restrict__ part_err, int h, int slices,
             float* __restrict__ cnt_out, float* __restrict__ err_out) {
  const int hid = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (hid >= h) return;  // warp-uniform
  int c = 0;
  float e = 0.0f;
#pragma unroll 8
  for (int s = lane; s < slices; s += 32) {
    c += part_cnt[(size_t)s * h + hid];
    e = __fadd_rn(e, part_err[(size_t)s * h + hid]);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    c += __shfl_xor_sync(0xffffffffu, c, off);
    e = __fadd_rn(e, __shfl_xor_sync(0xffffffffu, e, off));
  }
  if (lane == 0) {
    cnt_out[hid] = static_cast<float>(c);
    err_out[hid] = e;
  }
}

}  // namespace

// rows_per_slice: a multiple of 32, at most 256; slices = ceil(n / it).
// part_cnt i32 / part_err f32 (slices, h) scratch from the caller.
extern "C" int tpu3d_ransac_score(const void* feat, const void* pq,
                                  const void* w, const void* tn, int n, int h,
                                  int rows_per_slice, int slices, float thr2,
                                  float band, void* part_cnt, void* part_err,
                                  void* cnt_out, void* err_out,
                                  void* stream) {
  if (rows_per_slice < 32 || rows_per_slice > 256 || rows_per_slice % 32 ||
      slices != (n + rows_per_slice - 1) / rows_per_slice) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (h <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slices > 0) {
    const size_t smem = sizeof(float) * (kRank * (rows_per_slice + 8) +
                                         2 * rows_per_slice +
                                         (kRank + 1) * kHypTile +
                                         2 * kWarps * kQueue * 32);
    score_tc_kernel<<<dim3((h + kHypTile - 1) / kHypTile, slices), kThreads,
                      smem, s>>>(
        static_cast<const float*>(feat), static_cast<const float*>(pq),
        static_cast<const float*>(w), static_cast<const float*>(tn), n, h,
        rows_per_slice, thr2, band, static_cast<int*>(part_cnt),
        static_cast<float*>(part_err));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  score_reduce<<<(h + 7) / 8, 256, 0, s>>>(
      static_cast<const int*>(part_cnt), static_cast<const float*>(part_err),
      h, slices, static_cast<float*>(cnt_out), static_cast<float*>(err_out));
  return static_cast<int>(cudaGetLastError());
}
