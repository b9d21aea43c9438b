// K8: exact top-1 nearest neighbour within a radius over slab2 windows, on
// the K1 multi-window walk (window_walk.cuh).
//
// Replaces tpu3d/ops/nn_walk.py: slab2_top1_indexed (_top1_kernel, run
// through features_pallas._run_sweep). One CUDA block per query block of
// the key-sorted queries (block = 128, 256 or 512 rows), one thread per
// query. The block's K windows [lo, lo + len) of the key-sorted target
// stream through shared memory in `sub`-row tiles of the four packed planes
// (x, y, z, the original row as an f32 payload: 8 KB at sub 512), and
// every thread keeps a running (bd, bi) over them:
//   d2 = (dx*dx + dy*dy) + dz*dz with d = t - q, each operation rounded
//   once (the _rn intrinsics, no FMA contraction); a row replaces the
//   running best only when d2 < bd, so the first least row of the walk
//   wins, which is the lowest sorted row (the windows are disjoint
//   ascending row ranges walked in order). bi takes the payload of every
//   improvement, inside the radius or not; only the distance is gated:
//   out_d2 = (valid && bd <= r2) ? bd : 1e30, out_idx = int(bi) (exact for
//   fewer than 2^24 target rows).
//
// What bounds it on an H100: fp32 arithmetic. Each (query, window row)
// pair costs about 9 operations and the operands are a few tens of MB, so
// 1M queries against ~1,600 window rows each are ~15 GFLOP against ~40 MB.
// The design keeps the running best in registers and reads each staged row
// as a shared-memory broadcast; making it fast (several queries a thread,
// a vector load per row) is later work.

#include <cuda_runtime.h>

#include "window_walk.cuh"

namespace {

constexpr float kBig = 1.0e30f;
constexpr int kMaxK = 16;

template <int K, int kTile>
__global__ void __launch_bounds__(512)
nn_walk_top1_kernel(const float* __restrict__ q4,
                    const float* __restrict__ packed,
                    const int* __restrict__ lo, const int* __restrict__ len,
                    int qp, int m, float r2, float* __restrict__ out_d2,
                    int* __restrict__ out_idx) {
  __shared__ float tile[4][kTile];
  const int b = blockIdx.x;
  const int row = b * blockDim.x + threadIdx.x;
  const size_t qs = static_cast<size_t>(qp);
  const float qx = q4[row];
  const float qy = q4[qs + row];
  const float qz = q4[2 * qs + row];
  const bool valid = q4[3 * qs + row] > 0.5f;
  float bd = kBig;
  float bi = 0.0f;
  tpu3d::window_walk<K, 4, kTile>(packed, m, lo, len, b, tile, [&](int j) {
    const float d2 =
        tpu3d::dist2(tile[0][j], tile[1][j], tile[2][j], qx, qy, qz);
    if (d2 < bd) {
      bd = d2;
      bi = tile[3][j];
    }
  });
  out_d2[row] = (valid && bd <= r2) ? bd : kBig;
  out_idx[row] = static_cast<int>(bi);
}

struct Args {
  const float* q4;
  const float* packed;
  const int* lo;
  const int* len;
  int qp, m, nb, block;
  float r2;
  float* out_d2;
  int* out_idx;
  cudaStream_t stream;
};

template <int K, int kTile>
void launch_tile(const Args& a) {
  nn_walk_top1_kernel<K, kTile><<<a.nb, a.block, 0, a.stream>>>(
      a.q4, a.packed, a.lo, a.len, a.qp, a.m, a.r2, a.out_d2, a.out_idx);
}

template <int K>
bool launch_k(const Args& a, int sub) {
  switch (sub) {
    case 128: launch_tile<K, 128>(a); return true;
    case 256: launch_tile<K, 256>(a); return true;
    case 512: launch_tile<K, 512>(a); return true;
    default: return false;
  }
}

bool launch(const Args& a, int k, int sub) {
  switch (k) {
    case 1: return launch_k<1>(a, sub);
    case 2: return launch_k<2>(a, sub);
    case 3: return launch_k<3>(a, sub);
    case 4: return launch_k<4>(a, sub);
    case 5: return launch_k<5>(a, sub);
    case 6: return launch_k<6>(a, sub);
    case 7: return launch_k<7>(a, sub);
    case 8: return launch_k<8>(a, sub);
    case 9: return launch_k<9>(a, sub);
    case 10: return launch_k<10>(a, sub);
    case 11: return launch_k<11>(a, sub);
    case 12: return launch_k<12>(a, sub);
    case 13: return launch_k<13>(a, sub);
    case 14: return launch_k<14>(a, sub);
    case 15: return launch_k<15>(a, sub);
    case kMaxK: return launch_k<kMaxK>(a, sub);
    default: return false;
  }
}

}  // namespace

// q4 f32[4, qp] (key-sorted query x, y, z, validity; qp = nb * block),
// packed f32[4, m] (key-sorted target x, y, z, original row), lo/len
// i32[nb, k] -> out_d2 f32[qp], out_idx i32[qp].
extern "C" int tpu3d_nn_walk_top1(const void* q4, const void* packed,
                                  const void* lo, const void* len, int qp,
                                  int m, int nb, int k, int block, int sub,
                                  float r2, void* out_d2, void* out_idx,
                                  void* stream) {
  if ((block != 128 && block != 256 && block != 512) || qp != nb * block ||
      k < 1 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb > 0) {
    const Args a{static_cast<const float*>(q4),
                 static_cast<const float*>(packed),
                 static_cast<const int*>(lo),
                 static_cast<const int*>(len),
                 qp, m, nb, block, r2,
                 static_cast<float*>(out_d2),
                 static_cast<int*>(out_idx),
                 static_cast<cudaStream_t>(stream)};
    if (!launch(a, k, sub)) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
