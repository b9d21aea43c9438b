// K1: what the window walks share. Replaces tpu3d/ops/pallas_walk.py:
// window_walk / window_walk_vmem, the skeleton through which one Pallas
// program per query block walks that block's K candidate windows
// [lo, lo + len) of a packed plane-major operand in sub-wide tiles. On the
// card there is no generic walk: each kernel walks its windows with its
// own double-buffered tiles, shaped for its work (K2-K4 their three
// windows a block in csrc/features.cu, K7 one window a query block in
// csrc/icp_stats.cu, K8 up to 16 windows a block in csrc/nn_walk.cu), in
// window order and ascending row order, so every sum a sweep takes over a
// walk is deterministic, and a zero-length window costs nothing (which is
// how the sparse prepare prunes blocks). What they share is here: the
// exactly rounded fp32 arithmetic, the squared distance, and the cp.async
// copy, commit and wait that overlap a tile's copy with the scan of the
// previous one. The TPU's sub-aligned tile grid and its DMA pipeline were
// Mosaic rules; here a tile starts wherever the window does.

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

}  // namespace tpu3d
