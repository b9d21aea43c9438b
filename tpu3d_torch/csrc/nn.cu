// K5: tiled brute-force top-1 nearest neighbour, in two instantiations.
//
// Replaces tpu3d/ops/nn_pallas.py: nearest_neighbor_pallas (_nn_kernel),
// the MXU formulation d2 = |t|^2 - 2 t.s carried as a running min/argmin
// across target tiles, returned as max(min e + |s|^2, 0). Ties go to the
// lowest target row; invalid targets take the 1e6 sentinel coordinate.
//
// 1. D <= 4 (3-D brute ICP below 4,096 target points): one thread per
//    query keeps -2*q in registers, a block stages 128 target rows at a
//    time through shared memory in ascending index order, and a strict '<'
//    keeps the lowest index. fp32 FMA, as JAX runs this case at HIGHEST;
//    it is already faster than its library call (PERF.md).
//
// 2. 4 < D <= 36 (the 33-D FPFH correspondences of RANSAC): the tensor
//    cores, as the TPU kernel uses the MXU.
//    What bounds it on an H100: arithmetic, 2*Q*M*D per call (8,192 x
//    1,048,576 x 33 at the 1M pair), 495 TFLOP/s of TF32 against 67 of
//    plain fp32; the target operand (168 MB at 1M) exceeds the 50 MB L2.
//    Design:
//    - Operands, packed by the wrapper as the Pallas wrapper packs them (the
//      target's once per target model):
//      targets [t | |t|^2 | 0] and queries [-2q | 1 | 0], K = 40 floats
//      a row (five k-steps of 8), so one contraction gives e = |t|^2 -
//      2 t.q. Padded target rows carry a 1e30 norm and never win.
//    - mma.sync m16n8k8 TF32 in 3xTF32: each operand x splits into
//      hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away),
//      and e = hi.hi + (hi.lo + lo.hi) in fp32: ~2^-21 relative, the
//      class of the TPU kernel's bf16x3 (single-pass TF32 is past the
//      descriptor precision cliff of BENCH_NOTES.md).
//    - A block holds 256 queries, 32 per warp (two m16 tiles), whose
//      hi/lo A fragments stay in registers for the whole walk. 128-row
//      target tiles stream through shared memory in a 2-stage cp.async
//      ring; once a tile has landed, the block splits it into hi and lo
//      planes (once per block: an eighth of the conversions of a split at
//      fragment load), row stride 44 words so the B-fragment loads are
//      conflict-free, and every B fragment serves both m tiles.
//    - Each thread keeps a running (min, argmin) for its two query rows
//      of each m tile over its own accumulator columns, visited in
//      ascending target order with a strict '<'; at the end a quad
//      shuffle reduces (value, index) lexicographically. Warps own
//      disjoint queries, so nothing crosses warps.
//    - The grid is (query tiles, S target splits), query tile fastest, so
//      the blocks that share a target slice run together and read it
//      through L2. Each writes an (S, Qp) partial; a second kernel
//      reduces the partials in ascending split order (lower split on
//      ties), adds |q|^2 and clamps at 0. No atomics: deterministic.
//    Resources (nvcc -Xptxas -v, sm_90a): the tile kernel is bounded at
//    128 registers (126 used, no spills) for two blocks of 256 threads per
//    SM, with 90,112 bytes of dynamic shared memory each; the reduction 32.
//    On the card its two launches run at 29-32 % of the 3xTF32
//    tensor-core bound at M >= 100k (PERF.md): mma.sync, not wgmma, with
//    the per-tile split and the epilogue on the same issue slots.
//    Earlier design (one thread per query over every target on
//    the CUDA cores): 17.30 ms at Q 8,192 x M 100,352 and 281.69 ms at
//    M 1,048,576 (PERF.md, NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --- 1. D <= 4 ------------------------------------------------------------

constexpr int kThreads = 64;
constexpr int kTile = 128;
constexpr int kMaxD = 4;
constexpr float kSentinel = 1.0e6f;

__global__ void __launch_bounds__(kThreads)
nn_top1_kernel(const float* __restrict__ queries,
               const float* __restrict__ targets,
               const uint8_t* __restrict__ mask, int q, int m, int d,
               int* __restrict__ out_idx, float* __restrict__ out_d2) {
  __shared__ __align__(16) float t_s[kTile * kMaxD];
  __shared__ float n_s[kTile];
  const int row = blockIdx.x * kThreads + threadIdx.x;

  float qm2[kMaxD];
  float qn = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    const float v = (row < q && k < d) ? queries[(size_t)row * d + k] : 0.0f;
    qn = fmaf(v, v, qn);
    qm2[k] = -2.0f * v;
  }

  float best = 1.0e30f;
  int best_i = 0;
  for (int base = 0; base < m; base += kTile) {
    const int n_tile = min(kTile, m - base);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kMaxD; i += kThreads) {
      const int j = i / kMaxD;
      const int k = i - j * kMaxD;
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
      for (int k = 0; k < kMaxD; ++k) {
        s = fmaf(t_s[j * kMaxD + k], t_s[j * kMaxD + k], s);
      }
      n_s[j] = s;
    }
    __syncthreads();
    for (int j = 0; j < n_tile; ++j) {
      float acc = n_s[j];
#pragma unroll
      for (int k = 0; k < kMaxD; ++k) acc = fmaf(t_s[j * kMaxD + k], qm2[k], acc);
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

// --- 2. 4 < D <= 36: 3xTF32 on the tensor cores ---------------------------

constexpr int kK = 40;            // packed operand width (floats)
constexpr int kKSteps = kK / 8;   // k8 steps of the mma
constexpr int kWarps = 8;
constexpr int kDescThreads = kWarps * 32;
constexpr int kQTile = kWarps * 32;  // queries per block (32 per warp)
constexpr int kTTile = 128;          // target rows per pipeline stage
constexpr int kStages = 2;
constexpr int kRowStride = 44;       // words per staged target row
constexpr int kChunks = kK / 4;      // 16-byte chunks per operand row
constexpr int kTileWords = kTTile * kRowStride;
// The cp.async stages, then the tile's hi and lo planes.
constexpr int kSmemBytes = (kStages + 2) * kTileWords * 4;

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;  // a tf32 value, exactly representable in fp32
}

// x = hi + lo + O(2^-22 |x|); the subtraction is exact and uncontracted.
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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Running (min, argmin) update: columns arrive in ascending order, so a
// strict '<' keeps the lowest index among equal values.
__device__ __forceinline__ void take(float e, int col, float& best,
                                     int& idx) {
  if (e < best) {
    best = e;
    idx = col;
  }
}

// One block: 256 queries x one target split. qop (Qp, 40), top (Mp, 40);
// part_e / part_i (S, Qp) with S = gridDim.y.
__global__ void __launch_bounds__(kDescThreads, 2)
nn_desc_kernel(const float* __restrict__ qop, const float* __restrict__ top,
               int qp, int m_tiles, int tiles_per_split,
               float* __restrict__ part_e, int* __restrict__ part_i) {
  extern __shared__ __align__(16) float t_s[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in the group
  const int q0 = blockIdx.x * kQTile + warp * 32;
  const int split = blockIdx.y;
  const int tile0 = split * tiles_per_split;
  const int n_tiles = min(tiles_per_split, m_tiles - tile0);

  // A fragments (queries): rows q0 + 16 mt + {g, g + 8}, k 8 ks + {t, t + 4}.
  uint32_t a_hi[2][kKSteps][4], a_lo[2][kKSteps][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float* r0 = qop + (size_t)(q0 + 16 * mt + g) * kK;
    const float* r1 = r0 + 8 * kK;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      split_tf32(r0[8 * ks + t], a_hi[mt][ks][0], a_lo[mt][ks][0]);
      split_tf32(r1[8 * ks + t], a_hi[mt][ks][1], a_lo[mt][ks][1]);
      split_tf32(r0[8 * ks + t + 4], a_hi[mt][ks][2], a_lo[mt][ks][2]);
      split_tf32(r1[8 * ks + t + 4], a_hi[mt][ks][3], a_lo[mt][ks][3]);
    }
  }

  float best[2][2];
  int idx[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    best[mt][0] = best[mt][1] = __int_as_float(0x7f800000);  // +inf
    idx[mt][0] = idx[mt][1] = 0;
  }

  auto load_tile = [&](int j, int stage) {
    const float* src = top + (size_t)(tile0 + j) * kTTile * kK;
    float* dst = t_s + stage * kTileWords;
    for (int c = threadIdx.x; c < kTTile * kChunks; c += kDescThreads) {
      const int r = c / kChunks;
      const int v = c - r * kChunks;
      cp_async16(dst + r * kRowStride + 4 * v, src + (size_t)r * kK + 4 * v);
    }
  };
  uint32_t* hi_s = reinterpret_cast<uint32_t*>(t_s + kStages * kTileWords);
  uint32_t* lo_s = hi_s + kTileWords;

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_all();  // tile j, the only copy in flight, has landed
    __syncthreads();      // for every thread; the planes and stage j+1 free
    if (j + 1 < n_tiles) load_tile(j + 1, (j + 1) % kStages);
    cp_async_commit();
    // The tile's hi/lo split, once for the block (not once per warp).
    const float* ts = t_s + (j % kStages) * kTileWords;
#pragma unroll 4
    for (int i = threadIdx.x; i < kTTile * kK; i += kDescThreads) {
      const int o = (i / kK) * kRowStride + i % kK;
      split_tf32(ts[o], hi_s[o], lo_s[o]);
    }
    __syncthreads();
    const int col0 = (tile0 + j) * kTTile + 2 * t;
#pragma unroll 1
    for (int nt = 0; nt < kTTile / 8; ++nt) {
      // B fragment (targets): column nt*8 + g, k 8 ks + {t, t + 4}.
      const uint32_t* bh = hi_s + (nt * 8 + g) * kRowStride + t;
      const uint32_t* bl = lo_s + (nt * 8 + g) * kRowStride + t;
      float big[2][4] = {}, small[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        const uint32_t b0h = bh[8 * ks], b1h = bh[8 * ks + 4];
        const uint32_t b0l = bl[8 * ks], b1l = bl[8 * ks + 4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(small[mt], a_lo[mt][ks], b0h, b1h);
          mma_tf32(small[mt], a_hi[mt][ks], b0l, b1l);
          mma_tf32(big[mt], a_hi[mt][ks], b0h, b1h);
        }
      }
      // Accumulator (c0, c1): row g, columns 2t, 2t + 1; (c2, c3): row g + 8.
      const int col = col0 + nt * 8;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        take(__fadd_rn(big[mt][0], small[mt][0]), col, best[mt][0],
             idx[mt][0]);
        take(__fadd_rn(big[mt][1], small[mt][1]), col + 1, best[mt][0],
             idx[mt][0]);
        take(__fadd_rn(big[mt][2], small[mt][2]), col, best[mt][1],
             idx[mt][1]);
        take(__fadd_rn(big[mt][3], small[mt][3]), col + 1, best[mt][1],
             idx[mt][1]);
      }
    }
  }

  // Quad reduction: (value, index) lexicographic, so exact ties keep the
  // lowest index.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = best[mt][hh];
      int i = idx[mt][hh];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        if (ov < v || (ov == v && oi < i)) {
          v = ov;
          i = oi;
        }
      }
      if (t == 0) {
        const size_t o = (size_t)split * qp + q0 + 16 * mt + 8 * hh + g;
        part_e[o] = v;
        part_i[o] = i;
      }
    }
  }
}

// One thread per query: the splits in ascending order (strict '<': the
// lower split, hence the lower index, wins ties), then + |q|^2, clamp at 0.
__global__ void __launch_bounds__(256)
nn_desc_reduce(const float* __restrict__ part_e,
               const int* __restrict__ part_i,
               const float* __restrict__ queries, int q, int d, int qp,
               int splits, int* __restrict__ out_idx,
               float* __restrict__ out_d2) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= q) return;
  float best = part_e[row];
  int bi = part_i[row];
  for (int s = 1; s < splits; ++s) {
    const float v = part_e[(size_t)s * qp + row];
    if (v < best) {
      best = v;
      bi = part_i[(size_t)s * qp + row];
    }
  }
  float qn = 0.0f;
  for (int k = 0; k < d; ++k) {
    const float v = queries[(size_t)row * d + k];
    qn = fmaf(v, v, qn);
  }
  out_idx[row] = bi;
  out_d2[row] = fmaxf(best + qn, 0.0f);
}

}  // namespace

// D <= 4.
extern "C" int tpu3d_nn_top1(const void* queries, const void* targets,
                             const void* mask, int q, int m, int d,
                             void* out_idx, void* out_d2, void* stream) {
  if (d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0) {
    nn_top1_kernel<<<(q + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const float*>(targets),
        static_cast<const uint8_t*>(mask), q, m, d, static_cast<int*>(out_idx),
        static_cast<float*>(out_d2));
  }
  return static_cast<int>(cudaGetLastError());
}

// 4 < D <= 36, on the packed operands: qop (qp, 40) with qp a multiple of
// 256, top (m_tiles * 128, 40); partials (splits, qp); queries (q, d) raw,
// for |q|^2. Launches the tile kernel, then the split reduction.
extern "C" int tpu3d_nn_desc_top1(const void* qop, const void* top,
                                  const void* queries, int q, int d, int qp,
                                  int m_tiles, int tiles_per_split,
                                  int splits, void* part_e, void* part_i,
                                  void* out_idx, void* out_d2, void* stream) {
  if (qp % kQTile != 0 || m_tiles < 1 || splits < 1 ||
      (splits - 1) * tiles_per_split >= m_tiles ||
      splits * tiles_per_split < m_tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = cudaFuncSetAttribute(
      nn_desc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q > 0) {
    nn_desc_kernel<<<dim3(qp / kQTile, splits), kDescThreads, kSmemBytes,
                     s>>>(static_cast<const float*>(qop),
                          static_cast<const float*>(top), qp, m_tiles,
                          tiles_per_split, static_cast<float*>(part_e),
                          static_cast<int*>(part_i));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    nn_desc_reduce<<<(q + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(part_e), static_cast<const int*>(part_i),
        static_cast<const float*>(queries), q, d, qp, splits,
        static_cast<int*>(out_idx), static_cast<float*>(out_d2));
  }
  return static_cast<int>(cudaGetLastError());
}
