// K2, K3, K4: the fused-prepare sweeps (normals, SPFH, FPFH) on the K1
// multi-window walk (window_walk.cuh).
//
// Replaces tpu3d/ops/features_pallas.py: moments_sweep_pallas
// (_moments_kernel, K2), spfh_sweep_pallas (_spfh_kernel, K3) and
// fpfh_sweep_pallas (_fpfh_kernel, K4). One CUDA block per query block of
// the bucket-aligned layout (128 or 256 padded rows), one thread per query;
// the block's three candidate windows stream through shared memory in
// 128-row tiles and every thread consumes each tile's rows in ascending
// order, keeping its sums in registers:
//   K2  9 centred moments + an int count over d2 <= r2 (raw coordinates),
//       centred on the block's mean of valid queries (a fixed-order tree);
//       then covariance, the Newton smallest eigenvector and the viewpoint
//       flip per thread -> out (8, m): normal in rows 0-2, count in row 3;
//   K3  30 int cumulative threshold counts of the Darboux angles alpha,
//       phi and the diamond surrogate of theta over r2 >= d2 >= 1e-16
//       (centroid-shifted coordinates), assembled into the 33-bin
//       histogram by integer differences and L1-normalised -> out (40, m);
//   K4  33 fp32 sums of SPFH_j / d over r2 >= d2 >= 1e-16 -> out (m, 36).
//
// What bounds it on an H100: fp32 arithmetic, not memory. Every (query,
// candidate) pair of a block's windows costs one distance (8 operations),
// and each neighbour within the radius 18 more (K2), about 60 (K3) or 66
// (K4); the operands are a few MB and each tile is read from shared
// memory as broadcasts. The design keeps every per-pair quantity in
// registers (the TPU ran the bilinear angle terms and the weighted SPFH
// sum as MXU matmuls; here they are per-pair dot products) and evaluates
// the angles only for pairs inside the radius. The TPU's +-1 histogram
// assembly matmul becomes integer differences.
//
// Every operation rounds once (the _rn intrinsics, no FMA contraction) and
// sums run in the walk's fixed order, so a block's results depend only on
// its own windows (the sparse prepare equals the dense one bit for bit)
// and match the plain PyTorch versions' sequential arithmetic.

#include <cuda_runtime.h>

#include "window_walk.cuh"

namespace {

using tpu3d::add_rn;
using tpu3d::div_rn;
using tpu3d::mul_rn;
using tpu3d::sub_rn;

constexpr int kWindows = 3;  // the aligned layout's windows per block
constexpr int kTile = 128;
constexpr int kMaxBlock = 256;
constexpr int kThresh = 20;

struct Thresh {
  float t[kThresh];  // alpha/phi bin thresholds, then theta's diamond ones
};

// tpu3d_torch/ops/normals.py smallest_eigvec_3x3_planes_newton, operation
// for operation.
__device__ void eigvec_newton(float a00, float a01, float a02, float a11,
                              float a12, float a22, float* v) {
  float scale = fabsf(a00);
  scale = fmaxf(scale, fabsf(a01));
  scale = fmaxf(scale, fabsf(a02));
  scale = fmaxf(scale, fabsf(a11));
  scale = fmaxf(scale, fabsf(a12));
  scale = fmaxf(scale, fabsf(a22));
  scale = fmaxf(scale, 1e-30f);
  a00 = div_rn(a00, scale);
  a01 = div_rn(a01, scale);
  a02 = div_rn(a02, scale);
  a11 = div_rn(a11, scale);
  a12 = div_rn(a12, scale);
  a22 = div_rn(a22, scale);

  const float q = div_rn(add_rn(add_rn(a00, a11), a22), 3.0f);
  const float p1 =
      add_rn(add_rn(mul_rn(a01, a01), mul_rn(a02, a02)), mul_rn(a12, a12));
  const float d00 = sub_rn(a00, q);
  const float d11 = sub_rn(a11, q);
  const float d22 = sub_rn(a22, q);
  const float p2 = add_rn(
      add_rn(add_rn(mul_rn(d00, d00), mul_rn(d11, d11)), mul_rn(d22, d22)),
      mul_rn(2.0f, p1));
  const float p = __fsqrt_rn(fmaxf(div_rn(p2, 6.0f), 1e-30f));
  const float inv_p = div_rn(1.0f, p);
  const float b00 = mul_rn(d00, inv_p);
  const float b11 = mul_rn(d11, inv_p);
  const float b22 = mul_rn(d22, inv_p);
  const float b01 = mul_rn(a01, inv_p);
  const float b02 = mul_rn(a02, inv_p);
  const float b12 = mul_rn(a12, inv_p);
  const float det = add_rn(
      sub_rn(mul_rn(b00, sub_rn(mul_rn(b11, b22), mul_rn(b12, b12))),
             mul_rn(b01, sub_rn(mul_rn(b01, b22), mul_rn(b12, b02)))),
      mul_rn(b02, sub_rn(mul_rn(b01, b12), mul_rn(b11, b02))));
  const float d = fminf(fmaxf(det, -2.0f), 2.0f);
  float beta = -2.0f;
#pragma unroll
  for (int it = 0; it < 12; ++it) {
    const float h = sub_rn(mul_rn(sub_rn(mul_rn(beta, beta), 3.0f), beta), d);
    const float hp = sub_rn(mul_rn(mul_rn(3.0f, beta), beta), 3.0f);
    beta = fminf(fmaxf(sub_rn(beta, div_rn(h, fmaxf(hp, 1e-12f))), -2.0f),
                 -1.0f);
  }
  const float lam1 = add_rn(q, mul_rn(p, beta));
  const float s = sub_rn(mul_rn(3.0f, q), lam1);
  const float tra2 = add_rn(
      add_rn(add_rn(mul_rn(a00, a00), mul_rn(a11, a11)), mul_rn(a22, a22)),
      mul_rn(2.0f, p1));
  const float e2 = div_rn(sub_rn(mul_rn(mul_rn(9.0f, q), q), tra2), 2.0f);
  const float t = sub_rn(e2, mul_rn(lam1, s));

  const float P00 = add_rn(
      sub_rn(add_rn(add_rn(mul_rn(a00, a00), mul_rn(a01, a01)),
                    mul_rn(a02, a02)),
             mul_rn(s, a00)),
      t);
  const float P01 = sub_rn(
      add_rn(add_rn(mul_rn(a00, a01), mul_rn(a01, a11)), mul_rn(a02, a12)),
      mul_rn(s, a01));
  const float P02 = sub_rn(
      add_rn(add_rn(mul_rn(a00, a02), mul_rn(a01, a12)), mul_rn(a02, a22)),
      mul_rn(s, a02));
  const float P11 = add_rn(
      sub_rn(add_rn(add_rn(mul_rn(a01, a01), mul_rn(a11, a11)),
                    mul_rn(a12, a12)),
             mul_rn(s, a11)),
      t);
  const float P12 = sub_rn(
      add_rn(add_rn(mul_rn(a01, a02), mul_rn(a11, a12)), mul_rn(a12, a22)),
      mul_rn(s, a12));
  const float P22 = add_rn(
      sub_rn(add_rn(add_rn(mul_rn(a02, a02), mul_rn(a12, a12)),
                    mul_rn(a22, a22)),
             mul_rn(s, a22)),
      t);

  const float n0 =
      add_rn(add_rn(mul_rn(P00, P00), mul_rn(P01, P01)), mul_rn(P02, P02));
  const float n1 =
      add_rn(add_rn(mul_rn(P01, P01), mul_rn(P11, P11)), mul_rn(P12, P12));
  const float n2 =
      add_rn(add_rn(mul_rn(P02, P02), mul_rn(P12, P12)), mul_rn(P22, P22));
  const bool m0 = (n0 >= n1) && (n0 >= n2);
  const bool m1 = n1 >= n2;
  const float vx = m0 ? P00 : (m1 ? P01 : P02);
  const float vy = m0 ? P01 : (m1 ? P11 : P12);
  const float vz = m0 ? P02 : (m1 ? P12 : P22);
  const float vn = __fsqrt_rn(
      add_rn(add_rn(mul_rn(vx, vx), mul_rn(vy, vy)), mul_rn(vz, vz)));
  const bool ok = vn > 1e-20f;
  const float inv = div_rn(1.0f, fmaxf(vn, 1e-30f));
  v[0] = ok ? mul_rn(vx, inv) : 0.0f;
  v[1] = ok ? mul_rn(vy, inv) : 0.0f;
  v[2] = ok ? mul_rn(vz, inv) : 1.0f;
}

// ---- K2 ------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxBlock)
moments_kernel(const float* __restrict__ q8, const float* __restrict__ packed,
               const int* __restrict__ lo, const int* __restrict__ len, int m,
               float r2, float* __restrict__ out) {
  __shared__ float tile[3][kTile];
  __shared__ float red[kMaxBlock];
  const int b = blockIdx.x;
  const int row = b * blockDim.x + threadIdx.x;
  const size_t ms = static_cast<size_t>(m);
  const float qx = q8[row];
  const float qy = q8[ms + row];
  const float qz = q8[2 * ms + row];
  const bool valid = q8[3 * ms + row] > 0.5f;
  const float wq = valid ? 1.0f : 0.0f;

  // The block's centre over valid queries (fixed-order tree sums).
  const float cnt_q = fmaxf(tpu3d::block_tree_sum(wq, red), 1.0f);
  const float cx = div_rn(tpu3d::block_tree_sum(mul_rn(qx, wq), red), cnt_q);
  const float cy = div_rn(tpu3d::block_tree_sum(mul_rn(qy, wq), red), cnt_q);
  const float cz = div_rn(tpu3d::block_tree_sum(mul_rn(qz, wq), red), cnt_q);

  float mom[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) mom[i] = 0.0f;
  int cnt = 0;
  tpu3d::window_walk<kWindows, 3, kTile>(packed, m, lo, len, b, tile, [&](int j) {
    const float tx = tile[0][j];
    const float ty = tile[1][j];
    const float tz = tile[2][j];
    if (tpu3d::dist2(tx, ty, tz, qx, qy, qz) <= r2) {
      const float c0 = sub_rn(tx, cx);
      const float c1 = sub_rn(ty, cy);
      const float c2 = sub_rn(tz, cz);
      mom[0] = add_rn(mom[0], c0);
      mom[1] = add_rn(mom[1], c1);
      mom[2] = add_rn(mom[2], c2);
      mom[3] = add_rn(mom[3], mul_rn(c0, c0));
      mom[4] = add_rn(mom[4], mul_rn(c1, c1));
      mom[5] = add_rn(mom[5], mul_rn(c2, c2));
      mom[6] = add_rn(mom[6], mul_rn(c0, c1));
      mom[7] = add_rn(mom[7], mul_rn(c0, c2));
      mom[8] = add_rn(mom[8], mul_rn(c1, c2));
      ++cnt;
    }
  });

  const float cntf = static_cast<float>(cnt);
  const float c = fmaxf(cntf, 1.0f);
  const float mx = div_rn(mom[0], c);
  const float my = div_rn(mom[1], c);
  const float mz = div_rn(mom[2], c);
  float v[3];
  eigvec_newton(sub_rn(div_rn(mom[3], c), mul_rn(mx, mx)),
                sub_rn(div_rn(mom[6], c), mul_rn(mx, my)),
                sub_rn(div_rn(mom[7], c), mul_rn(mx, mz)),
                sub_rn(div_rn(mom[4], c), mul_rn(my, my)),
                sub_rn(div_rn(mom[8], c), mul_rn(my, mz)),
                sub_rn(div_rn(mom[5], c), mul_rn(mz, mz)), v);
  const bool flip =
      add_rn(add_rn(mul_rn(v[0], qx), mul_rn(v[1], qy)), mul_rn(v[2], qz)) >
      0.0f;
  const float sgn = valid ? (flip ? -1.0f : 1.0f) : 0.0f;
  out[row] = mul_rn(v[0], sgn);
  out[ms + row] = mul_rn(v[1], sgn);
  out[2 * ms + row] = mul_rn(v[2], sgn);
  out[3 * ms + row] = cntf;
#pragma unroll
  for (int r = 4; r < 8; ++r) out[r * ms + row] = 0.0f;
}

// ---- K3 ------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxBlock)
spfh_kernel(const float* __restrict__ q8n, const float* __restrict__ packed,
            const int* __restrict__ lo, const int* __restrict__ len, int m,
            float r2, Thresh th, float* __restrict__ out) {
  __shared__ float tile[10][kTile];
  const int b = blockIdx.x;
  const int row = b * blockDim.x + threadIdx.x;
  const size_t ms = static_cast<size_t>(m);
  const float px = q8n[row];
  const float py = q8n[ms + row];
  const float pz = q8n[2 * ms + row];
  const float nx = q8n[4 * ms + row];
  const float ny = q8n[5 * ms + row];
  const float nz = q8n[6 * ms + row];
  const float bx = sub_rn(mul_rn(py, nz), mul_rn(pz, ny));
  const float by = sub_rn(mul_rn(pz, nx), mul_rn(px, nz));
  const float bz = sub_rn(mul_rn(px, ny), mul_rn(py, nx));

  float thr[kThresh];  // registers, not the parameter space
#pragma unroll
  for (int i = 0; i < kThresh; ++i) thr[i] = th.t[i];
  int cum[30];
#pragma unroll
  for (int i = 0; i < 30; ++i) cum[i] = 0;
  int cnt = 0;
  tpu3d::window_walk<kWindows, 10, kTile>(packed, m, lo, len, b, tile, [&](int j) {
    const float t0 = tile[0][j];
    const float t1 = tile[1][j];
    const float t2 = tile[2][j];
    const float d2 = tpu3d::dist2(t0, t1, t2, px, py, pz);
    if (d2 <= r2 && d2 >= 1e-16f) {
      const float bjx = tile[3][j], bjy = tile[4][j], bjz = tile[5][j];
      const float njx = tile[6][j], njy = tile[7][j], njz = tile[8][j];
      const float aj = tile[9][j];
      const float anum = add_rn(
          add_rn(add_rn(add_rn(add_rn(mul_rn(nx, bjx), mul_rn(ny, bjy)),
                               mul_rn(nz, bjz)),
                        mul_rn(bx, njx)),
                 mul_rn(by, njy)),
          mul_rn(bz, njz));
      const float c =
          add_rn(add_rn(mul_rn(nx, njx), mul_rn(ny, njy)), mul_rn(nz, njz));
      const float pin =
          add_rn(add_rn(mul_rn(px, njx), mul_rn(py, njy)), mul_rn(pz, njz));
      const float inv_d = div_rn(1.0f, __fsqrt_rn(fmaxf(d2, 1e-24f)));
      const float dx = sub_rn(t0, px);
      const float dy = sub_rn(t1, py);
      const float dz = sub_rn(t2, pz);
      const float phi = mul_rn(
          add_rn(add_rn(mul_rn(nx, dx), mul_rn(ny, dy)), mul_rn(nz, dz)),
          inv_d);
      const float e = mul_rn(sub_rn(aj, pin), inv_d);
      const float alpha = mul_rn(anum, inv_d);
      const float s = sub_rn(mul_rn(phi, c), e);
      const float u = div_rn(s, fmaxf(add_rn(fabsf(s), fabsf(c)), 1e-30f));
      const float dth = c >= 0.0f ? u : sub_rn(s >= 0.0f ? 2.0f : -2.0f, u);
#pragma unroll
      for (int i = 0; i < 10; ++i) {
        cum[i] += alpha >= thr[i];
        cum[10 + i] += phi >= thr[i];
        cum[20 + i] += dth >= thr[10 + i];
      }
      ++cnt;
    }
  });

  // hist[0] = cnt - cum_0, hist[b] = cum_{b-1} - cum_b, hist[10] = cum_9
  // per angle; the L1 norm is 3 * cnt, a whole number.
  const float norm = static_cast<float>(3 * cnt);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int k = 0; k < 11; ++k) {
      const int h = k == 0    ? cnt - cum[10 * a]
                    : k == 10 ? cum[10 * a + 9]
                              : cum[10 * a + k - 1] - cum[10 * a + k];
      const float hf = static_cast<float>(h);
      out[(11 * a + k) * ms + row] =
          norm > 0.0f ? div_rn(hf, fmaxf(norm, 1e-30f)) : hf;
    }
  }
  out[33 * ms + row] = static_cast<float>(cnt);
#pragma unroll
  for (int r = 34; r < 40; ++r) out[r * ms + row] = 0.0f;
}

// ---- K4 ------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxBlock)
fpfh_kernel(const float* __restrict__ q8, const float* __restrict__ packed,
            const int* __restrict__ lo, const int* __restrict__ len, int m,
            float r2, float* __restrict__ out) {
  __shared__ float tile[36][kTile];
  const int b = blockIdx.x;
  const int row = b * blockDim.x + threadIdx.x;
  const size_t ms = static_cast<size_t>(m);
  const float qx = q8[row];
  const float qy = q8[ms + row];
  const float qz = q8[2 * ms + row];

  float acc[33];
#pragma unroll
  for (int k = 0; k < 33; ++k) acc[k] = 0.0f;
  tpu3d::window_walk<kWindows, 36, kTile>(packed, m, lo, len, b, tile, [&](int j) {
    const float d2 =
        tpu3d::dist2(tile[0][j], tile[1][j], tile[2][j], qx, qy, qz);
    if (d2 <= r2 && d2 >= 1e-16f) {
      const float w = div_rn(1.0f, __fsqrt_rn(fmaxf(d2, 1e-24f)));
#pragma unroll
      for (int k = 0; k < 33; ++k)
        acc[k] = add_rn(acc[k], mul_rn(w, tile[3 + k][j]));
    }
  });
  float* o = out + static_cast<size_t>(row) * 36;
#pragma unroll
  for (int k = 0; k < 33; ++k) o[k] = acc[k];
  o[33] = 0.0f;
  o[34] = 0.0f;
  o[35] = 0.0f;
}

bool bad_block(int block) { return block != 128 && block != 256; }

}  // namespace

extern "C" int tpu3d_moments_sweep(const void* q8, const void* packed,
                                   const void* lo, const void* len, int m,
                                   int nb, int block, float r2, void* out,
                                   void* stream) {
  if (bad_block(block)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0) {
    moments_kernel<<<nb, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q8), static_cast<const float*>(packed),
        static_cast<const int*>(lo), static_cast<const int*>(len), m, r2,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpu3d_spfh_sweep(const void* q8n, const void* packed,
                                const void* lo, const void* len, int m, int nb,
                                int block, float r2, const void* thresh_host,
                                void* out, void* stream) {
  if (bad_block(block)) return static_cast<int>(cudaErrorInvalidValue);
  Thresh th;
  for (int i = 0; i < kThresh; ++i)
    th.t[i] = static_cast<const float*>(thresh_host)[i];
  if (nb > 0) {
    spfh_kernel<<<nb, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q8n), static_cast<const float*>(packed),
        static_cast<const int*>(lo), static_cast<const int*>(len), m, r2, th,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpu3d_fpfh_sweep(const void* q8, const void* packed,
                                const void* lo, const void* len, int m, int nb,
                                int block, float r2, void* out, void* stream) {
  if (bad_block(block)) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0) {
    fpfh_kernel<<<nb, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q8), static_cast<const float*>(packed),
        static_cast<const int*>(lo), static_cast<const int*>(len), m, r2,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
