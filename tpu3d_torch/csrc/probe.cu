// The lowering probe's counterpart: the device math and data movement the
// port's kernels build on, one launch per probed function.
//
// Replaces benchmarks/pallas_probe.py: probe (one pallas_call per probed
// function, asking which operations Mosaic lowers on a TPU). On an H100
// every one of them compiles; the question left is how far the device's
// results lie from PyTorch's on the same card, which tpu3d_torch/probe.py
// measures:
//   elementwise   atan2f(x, 0.5), atanf, acosf(clip(x, -1, 1)), cosf (the
//                 accurate CUDA math library, no fast-math intrinsics);
//   row argmin    one block per row, a shared-memory tree over
//                 (value, index) pairs; ties go to the lower index;
//   row cumsum    one warp per row, a shuffle scan per 32-wide piece and
//                 a carry between pieces (row_cumsum_plain's order);
//   dot axis 0    out[p, q] = sum_k a[k, p] * b[q, k], k ascending, one
//                 fmaf per term (the probe's axis-0 dot_general);
//   transpose     a square matrix through 32 x 33 shared-memory tiles, one
//                 element a thread.
// Each is a few KB: launch latency bounds them all.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;

__global__ void unary_kernel(const float* __restrict__ x, int n, int op,
                             float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  float r;
  switch (op) {
    case 0: r = atan2f(v, 0.5f); break;
    case 1: r = atanf(v); break;
    case 2: r = acosf(fminf(fmaxf(v, -1.0f), 1.0f)); break;
    default: r = cosf(v); break;
  }
  out[i] = r;
}

__global__ void __launch_bounds__(kThreads)
argmin_kernel(const float* __restrict__ x, int cols, int* __restrict__ out) {
  __shared__ float val[kThreads];
  __shared__ int arg[kThreads];
  const float* row = x + static_cast<size_t>(blockIdx.x) * cols;
  float best = 0.0f;
  int bi = -1;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const float v = row[c];
    if (bi < 0 || v < best) {
      best = v;
      bi = c;
    }
  }
  val[threadIdx.x] = best;
  arg[threadIdx.x] = bi;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      const float v = val[threadIdx.x + stride];
      const int a = arg[threadIdx.x + stride];
      const int mine = arg[threadIdx.x];
      if (a >= 0 && (mine < 0 || v < val[threadIdx.x] ||
                     (v == val[threadIdx.x] && a < mine))) {
        val[threadIdx.x] = v;
        arg[threadIdx.x] = a;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = arg[0];
}

// One warp a row: each 32-wide piece is scanned by five shuffle-up adds
// (lane i adds lane i - d for d = 1, 2, 4, 8, 16), then the carry, the last
// lane's sum of the piece before, is added and passed on. Columns past the
// row's end load 0 and feed no valid lane.
__global__ void __launch_bounds__(kThreads)
cumsum_kernel(const float* __restrict__ x, int rows, int cols,
              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps leave together
  const size_t base = static_cast<size_t>(r) * cols;
  float carry = 0.0f;
  for (int c0 = 0; c0 < cols; c0 += 32) {
    const int c = c0 + lane;
    float v = c < cols ? x[base + c] : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v = __fadd_rn(v, u);
    }
    v = __fadd_rn(v, carry);
    if (c < cols) out[base + c] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

__global__ void dot_axis0_kernel(const float* __restrict__ a,
                                 const float* __restrict__ b, int k, int p,
                                 int q, int ldb, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p * q) return;
  const int pi = i / q;
  const int qi = i - pi * q;
  float acc = 0.0f;
  for (int kk = 0; kk < k; ++kk) {
    acc = fmaf(a[static_cast<size_t>(kk) * p + pi],
               b[static_cast<size_t>(qi) * ldb + kk], acc);
  }
  out[i] = acc;
}

// One element a thread: a (32, 32) block stages its 32 x 32 tile in shared
// memory padded to 33 columns (the column read hits 32 banks), then writes
// the transposed tile row by row, coalesced both ways.
__global__ void __launch_bounds__(kTile * kTile)
transpose_kernel(const float* __restrict__ x, int n, float* __restrict__ out) {
  __shared__ float tile[kTile][kTile + 1];
  const int bx = blockIdx.x * kTile;
  const int by = blockIdx.y * kTile;
  int r = by + threadIdx.y;
  int c = bx + threadIdx.x;
  if (r < n && c < n) {
    tile[threadIdx.y][threadIdx.x] = x[static_cast<size_t>(r) * n + c];
  }
  __syncthreads();
  r = bx + threadIdx.y;
  c = by + threadIdx.x;
  if (r < n && c < n) {
    out[static_cast<size_t>(r) * n + c] = tile[threadIdx.x][threadIdx.y];
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// op: 0 atan2f(x, 0.5), 1 atanf, 2 acosf(clip(x, -1, 1)), 3 cosf.
extern "C" int tpu3d_probe_unary(const void* x, int n, int op, void* out,
                                 void* stream) {
  if (op < 0 || op > 3 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    unary_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, op, static_cast<float*>(out));
  }
  return last_error();
}

extern "C" int tpu3d_probe_argmin(const void* x, int rows, int cols,
                                  void* out, void* stream) {
  if (cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    argmin_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), cols, static_cast<int*>(out));
  }
  return last_error();
}

extern "C" int tpu3d_probe_cumsum(const void* x, int rows, int cols,
                                  void* out, void* stream) {
  if (rows > 0 && cols > 0) {
    constexpr int kRowsPerBlock = kThreads / 32;
    cumsum_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), rows, cols, static_cast<float*>(out));
  }
  return last_error();
}

// a f32[k, p], b f32[q, ldb] (k <= ldb) -> out f32[p, q].
extern "C" int tpu3d_probe_dot_axis0(const void* a, const void* b, int k,
                                     int p, int q, int ldb, void* out,
                                     void* stream) {
  if (k > ldb) return static_cast<int>(cudaErrorInvalidValue);
  if (p > 0 && q > 0) {
    dot_axis0_kernel<<<(p * q + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), k, p, q,
        ldb, static_cast<float*>(out));
  }
  return last_error();
}

extern "C" int tpu3d_probe_transpose(const void* x, int n, void* out,
                                     void* stream) {
  if (n > 0) {
    const dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
    transpose_kernel<<<grid, dim3(kTile, kTile), 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), n, static_cast<float*>(out));
  }
  return last_error();
}
