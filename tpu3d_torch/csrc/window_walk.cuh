// K1: the multi-window walk shared by the fused-prepare sweeps (K2-K4, three
// windows per block) and the slab2 top-1 walk (K8, k_windows per block).
//
// Replaces tpu3d/ops/pallas_walk.py: window_walk / window_walk_vmem. One
// CUDA block serves one query block of blockDim.x padded rows, one thread
// per query. For each of the block's K candidate windows [lo, lo + len) of
// the packed plane-major (R, m) operand (tables lo/len of shape (nb, K)),
// in window order, the block stages tiles of kTile rows into shared memory
// with coalesced loads (neighbouring threads read neighbouring columns of
// one plane), and every thread then hands the tile's rows to `consume(j)`
// in ascending order. A zero-length window costs nothing, which is how the
// sparse prepare prunes blocks. The order of the walk is fixed, so every
// sum a sweep takes over it is deterministic.
//
// The TPU's sub-aligned tile grid and its DMA pipeline were Mosaic rules;
// here a tile starts wherever the window does.

#pragma once

#include <cuda_runtime.h>

namespace tpu3d {

// Exactly rounded fp32 arithmetic: no FMA contraction, so every sweep
// rounds as its plain PyTorch version's separate operations do.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// d² = (dx² + dy²) + dz² with d = t − q.
__device__ __forceinline__ float dist2(float tx, float ty, float tz, float qx,
                                       float qy, float qz) {
  const float dx = sub_rn(tx, qx);
  const float dy = sub_rn(ty, qy);
  const float dz = sub_rn(tz, qz);
  return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

template <int K, int R, int kTile, typename Consume>
__device__ __forceinline__ void window_walk(const float* __restrict__ packed,
                                            int m, const int* __restrict__ lo,
                                            const int* __restrict__ len, int b,
                                            float (*tile)[kTile],
                                            Consume&& consume) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const int lo_k = lo[b * K + k];
    const int hi_k = lo_k + len[b * K + k];
#pragma unroll 1
    for (int start = lo_k; start < hi_k; start += kTile) {
      const int nt = min(kTile, hi_k - start);
      __syncthreads();  // the previous tile is consumed
      for (int i = tid; i < R * kTile; i += nthr) {
        const int r = i / kTile;
        const int c = i - r * kTile;
        if (c < nt) tile[r][c] = packed[(size_t)r * m + start + c];
      }
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < nt; ++j) consume(j);
    }
  }
}

// cp.async of one float from device memory into shared memory (any
// 4-byte aligned addresses, so a tile may start at any window row), and
// the group commit and wait that overlap a tile's copy with the scan of the
// previous one.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum of v over the block's threads by halving (blockDim.x a power of two),
// the order of the plain versions' _tree_sum. Every thread gets the sum.
__device__ __forceinline__ float block_tree_sum(float v, float* red) {
  const int tid = threadIdx.x;
  __syncthreads();
  red[tid] = v;
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] = add_rn(red[tid], red[tid + stride]);
    __syncthreads();
  }
  return red[0];
}

}  // namespace tpu3d
