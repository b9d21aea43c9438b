// K10: RANSAC's rotation-table hypotheses, draw -> 3-point QCP -> w16.
// K11: RANSAC's gather-sampler hypotheses, triple -> perm -> 3-point QCP
// -> w16 (below K10, with its own note).
//
// Replaces no Pallas kernel: on the TPU this is XLA's compiled body of
// tpu3d/ops/ransac.py:173 solve_rotation_chunk (the epoch slices of the
// doubled plane table), tpu3d/ops/transforms.py:364 kabsch3_planes and
// :226 _qcp_quat_planes (the 3-point QCP), and the w16 packing: ~1,000
// elementwise PyTorch launches a chunk done eagerly, one launch here.
//
// Hypothesis j of a chunk is slot i = j mod n of epoch e = j / n (n the
// table's width, half its 2n columns). Epoch e reads the three slot
// columns i + off[e][s] of the (6, 2n) plane table (p then q planes), so
// slot s pairs valid row i with row (i + r_s) mod count. Per hypothesis:
//   - the QCP solve of _qcp_quat_planes: Horn matrix N, N^2, the
//     characteristic quartic, 12 Newton steps from E0, the best adjugate
//     column, two Rayleigh polishes, the exact renormalisation with the
//     identity fallback;
//   - R from the quaternion, t = qm - R pm, and the w16 column
//     [R^T t | t | vec(R) | 0] with |t|^2;
//   - disabled = slot i >= count, or its iteration id
//     first_id + e count + i >= max_iterations, or count < 3.
//
// Rounding order. Each a*b + c of the JAX expression is one fused
// multiply-add, the first product of a sum first (fmaf(a, b, c * d)), as
// LLVM contracts XLA's CPU code; every other operation rounds once
// (__fadd_rn, __fmul_rn, __fdiv_rn), so nvcc contracts nothing of its
// own; 1/sqrt is __frsqrt_rn, correctly rounded. XLA's CPU backend does
// not contract a product that two of its fused consumers share, and its
// rsqrt is the AVX-512 rsqrt14 estimate with two Newton steps, so JAX's
// own result depends on its fusion split and on the host's ISA; this is
// one fixed order close to it (PERF.md, ROADMAP section 3).
// ops/ransac.py rotation_hypotheses_plain computes the same function.
//
// What bounds it on an H100: bytes. Per hypothesis 1,383 flops
// (FLOPS_PER_HYPOTHESIS in ops/ransac.py) against 69 bytes written; the
// table (48 n bytes) is read once from HBM and then from L2. At the
// chunk's 25,600 x 8,192 that is ~0.65 us of HBM against ~0.53 us of
// fp32. Design: one thread per hypothesis, the solve in registers (the
// 4x4 matrices as fully unrolled arrays), block 128; neighbouring threads
// read neighbouring table columns and write neighbouring w16 columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNewton = 12;

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ float mul_(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub_(float a, float b) {
  return __fsub_rn(a, b);
}
// jnp.maximum: NaN propagates (fmaxf would drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : (a > b ? a : b);
}

// Sum over k of x[k] * y[k], k = 0..3: fma(x3, y3, fma(x2, y2, fma(x0, y0,
// x1 * y1))).
__device__ __forceinline__ float dot4(float x0, float y0, float x1, float y1,
                                      float x2, float y2, float x3,
                                      float y3) {
  return fma_(x3, y3, fma_(x2, y2, fma_(x0, y0, mul_(x1, y1))));
}

// det3 of rows r[] and columns c[] of A: A[r0][c0] (A[r1][c1] A[r2][c2] -
// A[r1][c2] A[r2][c1]) - A[r0][c1] (...) + A[r0][c2] (...).
__device__ __forceinline__ float det3(const float (&A)[4][4], int i0, int i1,
                                      int i2, int j0, int j1, int j2) {
  const float m1 = fma_(A[i1][j1], A[i2][j2], -mul_(A[i1][j2], A[i2][j1]));
  const float m2 = fma_(A[i1][j0], A[i2][j2], -mul_(A[i1][j2], A[i2][j0]));
  const float m3 = fma_(A[i1][j0], A[i2][j1], -mul_(A[i1][j1], A[i2][j0]));
  return fma_(A[i0][j2], m3, fma_(A[i0][j0], m1, -mul_(A[i0][j1], m2)));
}

// The largest adjugate column of N - lam I, normalised (_adj_best_col).
__device__ __forceinline__ void adj_best_col(const float (&N)[4][4],
                                             float lam, float (&v)[4]) {
  float A[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) A[a][b] = (a == b) ? sub_(N[a][a], lam)
                                                   : N[a][b];
  }
  float best[4], best_norm = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // Rows other than k, columns other than i, ascending.
    const int r0 = k <= 0 ? 1 : 0, r1 = k <= 1 ? 2 : 1, r2 = k <= 2 ? 3 : 2;
    float col[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c0 = i <= 0 ? 1 : 0, c1 = i <= 1 ? 2 : 1;
      const int c2 = i <= 2 ? 3 : 2;
      const float d = det3(A, r0, r1, r2, c0, c1, c2);
      col[i] = ((i + k) & 1) ? -d : d;
    }
    const float nrm = dot4(col[0], col[0], col[1], col[1], col[2], col[2],
                           col[3], col[3]);
    if (k == 0 || nrm > best_norm) {  // strict: the first of equals
      best_norm = nrm;
#pragma unroll
      for (int i = 0; i < 4; ++i) best[i] = col[i];
    }
  }
  // max(best_norm, 1e-60) in fp32 is max(best_norm, 0).
  const float inv = __frsqrt_rn(max_nan(best_norm, 0.0f));
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = mul_(best[i], inv);
}

__device__ __forceinline__ float rayleigh(const float (&N)[4][4],
                                          const float (&v)[4]) {
  float nv[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    nv[a] = dot4(N[a][0], v[0], N[a][1], v[1], N[a][2], v[2], N[a][3], v[3]);
  }
  return dot4(v[0], nv[0], v[1], nv[1], v[2], nv[2], v[3], nv[3]);
}

__global__ void __launch_bounds__(kThreads)
    ransac_hyp_kernel(const float* __restrict__ pq2p,
                      const int* __restrict__ params, int n, int h,
                      float* __restrict__ w16t, float* __restrict__ t_norm,
                      uint8_t* __restrict__ disabled) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= h) return;
  const int first_id = params[0], count = params[1], max_it = params[2];
  const int e = j / n;
  const int i = j - e * n;
  const int* off = params + 3 + 3 * e;
  const size_t w = 2 * static_cast<size_t>(n);  // table row stride

  // P[s][c], Q[s][c]: coordinate c of slot s's p and q.
  float P[3][3], Q[3][3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const size_t col = static_cast<size_t>(i) + off[s];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      P[s][c] = pq2p[c * w + col];
      Q[s][c] = pq2p[(3 + c) * w + col];
    }
  }

  const float third = 1.0f / 3.0f;
  float psum[3], qsum[3], pm[3], pc[3][3], qc[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    psum[c] = add_(add_(P[0][c], P[1][c]), P[2][c]);
    qsum[c] = add_(add_(Q[0][c], Q[1][c]), Q[2][c]);
    pm[c] = mul_(psum[c], third);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      pc[s][c] = fma_(-psum[c], third, P[s][c]);  // p - psum/3
      qc[s][c] = fma_(-qsum[c], third, Q[s][c]);
    }
  }
  float S[3][3];  // S[a][b] = sum over slots of pc[.][a] qc[.][b]
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      S[a][b] = fma_(pc[2][a], qc[2][b],
                     fma_(pc[0][a], qc[0][b], mul_(pc[1][a], qc[1][b])));
    }
  }
  float e0 = 0.0f;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float term = fma_(pc[s][c], pc[s][c], mul_(qc[s][c], qc[s][c]));
      e0 = (s == 0 && c == 0) ? term : add_(e0, term);
    }
  }
  e0 = mul_(0.5f, e0);

  // Horn matrix.
  const float sxx = S[0][0], sxy = S[0][1], sxz = S[0][2];
  const float syx = S[1][0], syy = S[1][1], syz = S[1][2];
  const float szx = S[2][0], szy = S[2][1], szz = S[2][2];
  float N[4][4];
  N[0][0] = add_(add_(sxx, syy), szz);
  N[0][1] = N[1][0] = sub_(syz, szy);
  N[0][2] = N[2][0] = sub_(szx, sxz);
  N[0][3] = N[3][0] = sub_(sxy, syx);
  N[1][1] = sub_(sub_(sxx, syy), szz);
  N[1][2] = N[2][1] = add_(sxy, syx);
  N[1][3] = N[3][1] = add_(szx, sxz);
  N[2][2] = sub_(sub_(syy, sxx), szz);  // -sxx + syy - szz
  N[2][3] = N[3][2] = add_(syz, szy);
  N[3][3] = add_(sub_(-sxx, syy), szz);

  // M = N^2 and the quartic's coefficients.
  float M[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = a; b < 4; ++b) {
      M[a][b] = M[b][a] = dot4(N[a][0], N[0][b], N[a][1], N[1][b], N[a][2],
                               N[2][b], N[a][3], N[3][b]);
    }
  }
  const float tr2 = add_(add_(add_(M[0][0], M[1][1]), M[2][2]), M[3][3]);
  const float tr3 = fma_(
      2.0f,
      fma_(N[2][3], M[2][3],
           fma_(N[1][3], M[1][3],
                fma_(N[1][2], M[1][2],
                     fma_(N[0][3], M[0][3],
                          fma_(N[0][1], M[0][1], mul_(N[0][2], M[0][2])))))),
      dot4(N[0][0], M[0][0], N[1][1], M[1][1], N[2][2], M[2][2], N[3][3],
           M[3][3]));
  const float tr4 = fma_(
      2.0f,
      fma_(M[2][3], M[2][3],
           fma_(M[1][3], M[1][3],
                fma_(M[1][2], M[1][2],
                     fma_(M[0][3], M[0][3],
                          fma_(M[0][1], M[0][1], mul_(M[0][2], M[0][2])))))),
      dot4(M[0][0], M[0][0], M[1][1], M[1][1], M[2][2], M[2][2], M[3][3],
           M[3][3]));
  const float c2 = mul_(-0.5f, tr2);
  const float c1 = mul_(-tr3, third);  // XLA divides by 3 as * (1/3)
  const float c0 = mul_(-0.25f, fma_(c2, tr2, tr4));

  float lam = e0;  // lambda_max <= E0: Newton from above
#pragma unroll
  for (int it = 0; it < kNewton; ++it) {
    const float p = fma_(fma_(fma_(lam, lam, c2), lam, c1), lam, c0);
    const float dp = fma_(fma_(mul_(4.0f, lam), lam, mul_(2.0f, c2)), lam, c1);
    lam = sub_(lam, __fdiv_rn(p, fabsf(dp) > 1e-20f ? dp : 1e-20f));
  }

  float v[4];
  adj_best_col(N, lam, v);
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    lam = rayleigh(N, v);
    adj_best_col(N, lam, v);
  }
  const float nrm = dot4(v[0], v[0], v[1], v[1], v[2], v[2], v[3], v[3]);
  const bool ok = isfinite(nrm) && nrm > 1e-12f;
  const float inv = __frsqrt_rn(ok ? nrm : 1.0f);
  const float q0 = ok ? mul_(v[0], inv) : 1.0f;
  const float qx = ok ? mul_(v[1], inv) : 0.0f;
  const float qy = ok ? mul_(v[2], inv) : 0.0f;
  const float qz = ok ? mul_(v[3], inv) : 0.0f;

  float r[9];
  r[0] = fma_(-qz, qz, fma_(-qy, qy, fma_(q0, q0, mul_(qx, qx))));
  r[1] = mul_(2.0f, fma_(qx, qy, -mul_(q0, qz)));
  r[2] = mul_(2.0f, fma_(qx, qz, mul_(q0, qy)));
  r[3] = mul_(2.0f, fma_(qy, qx, mul_(q0, qz)));
  r[4] = fma_(-qz, qz, fma_(qy, qy, fma_(q0, q0, -mul_(qx, qx))));
  r[5] = mul_(2.0f, fma_(qy, qz, -mul_(q0, qx)));
  r[6] = mul_(2.0f, fma_(qz, qx, -mul_(q0, qy)));
  r[7] = mul_(2.0f, fma_(qz, qy, mul_(q0, qx)));
  r[8] = fma_(qz, qz, fma_(-qy, qy, fma_(q0, q0, -mul_(qx, qx))));
  float t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float rp = fma_(r[3 * a + 2], pm[2],
                          fma_(r[3 * a], pm[0], mul_(r[3 * a + 1], pm[1])));
    t[a] = fma_(qsum[a], third, -rp);  // qm - R pm
  }

  const size_t hs = static_cast<size_t>(h);
#pragma unroll
  for (int a = 0; a < 3; ++a) {  // R^T t
    w16t[a * hs + j] = fma_(r[6 + a], t[2],
                            fma_(r[a], t[0], mul_(r[3 + a], t[1])));
    w16t[(3 + a) * hs + j] = t[a];
  }
#pragma unroll
  for (int a = 0; a < 9; ++a) w16t[(6 + a) * hs + j] = r[a];
  w16t[15 * hs + j] = 0.0f;
  t_norm[j] = fma_(t[2], t[2], fma_(t[0], t[0], mul_(t[1], t[1])));
  const bool valid = i < count;
  const long long id = static_cast<long long>(first_id) +
                       static_cast<long long>(e) * count + i;
  disabled[j] = (!valid || id >= max_it || count < 3) ? 1 : 0;
}

// --- K11 -------------------------------------------------------------------
//
// Replaces no Pallas kernel: on the TPU this is XLA's compiled body of
// tpu3d/ops/ransac.py:414 solve_hypotheses (the gather sampler: draws ->
// dup flags -> perm[draws] -> one (h, 3, 6) row gather -> kabsch_quat,
// tpu3d/ops/transforms.py:149, QCP core :226 -> pack_hypotheses), which
// the port ran eagerly at ~1,000 launches a call; one launch here.
//
// Hypothesis j reads its triple (d0, d1, d2) of valid-row ranks from
// params[2 + 3 j ...], the rows perm[d] of the packed (n, 6) p|q table,
// and computes ops/transforms.py kabsch_quat and ops/ransac.py
// pack_hypotheses: means by a division by 3, centring, the nine
// correlations and E0 in _sum3 order, the QCP core (Horn matrix, N^2,
// the quartic, 12 Newton steps from E0, the best adjugate column, two
// Rayleigh polishes, the renormalisation with the identity fallback), R
// from the quaternion, t = tgt_mean - R src_mean, the w16 column
// [R^T t | t | vec(R) | 0] and |t|^2. disabled = two equal draws, or
// the iteration id params[0] + j >= params[1].
//
// Rounding order: the port's per-op order, each operation rounded once
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn), left to right as the
// Python expression reads, nothing contracted (not K10's fma order); 1/sqrt
// is a square root and a division, each rounded (rsqrt_div), which is
// what torch.rsqrt computes on the CPU: so the port's CPU results stay
// bit for bit what they were (a correctly rounded 1/sqrt moved half the
// w16 elements by an ulp or more, and ICP's 1e-6 parity with JAX with
// them). The plain version, ops/ransac.py gather_hypotheses_plain
// (ops/transforms.py kabsch_quat), rounds the same way on either device,
// so the two agree bit for bit.
//
// What bounds it on an H100: bytes, barely. Per hypothesis ~1,370 flops
// (GATHER_FLOPS_PER_HYPOTHESIS in ops/ransac.py) against 12 bytes of
// triple read and 69 written; the rows of perm (8 bytes) and of the
// table (24) that the draws reach are read once from HBM and then from
// L2. At 100,352 hypotheses that is ~2.4 us of HBM against ~2.0 us of
// fp32. Design: one thread per
// hypothesis, the solve in registers, block 128; neighbouring threads
// read neighbouring triples and write neighbouring w16 columns, and the
// row gather is the only scattered read.

__device__ __forceinline__ float div_(float a, float b) {
  return __fdiv_rn(a, b);
}
// 1/sqrt(x), the square root and the division each rounded once.
__device__ __forceinline__ float rsqrt_div(float x) {
  return __fdiv_rn(1.0f, __fsqrt_rn(x));
}

// x0 y0 + x1 y1 + x2 y2 + x3 y3, left to right, each operation rounded.
__device__ __forceinline__ float sum4_op(float x0, float y0, float x1,
                                         float y1, float x2, float y2,
                                         float x3, float y3) {
  return add_(add_(add_(mul_(x0, y0), mul_(x1, y1)), mul_(x2, y2)),
              mul_(x3, y3));
}

// A[r0][c0] (A[r1][c1] A[r2][c2] - A[r1][c2] A[r2][c1]) - A[r0][c1] (...)
// + A[r0][c2] (...), left to right.
__device__ __forceinline__ float det3_op(const float (&A)[4][4], int i0,
                                         int i1, int i2, int j0, int j1,
                                         int j2) {
  const float m1 = sub_(mul_(A[i1][j1], A[i2][j2]), mul_(A[i1][j2], A[i2][j1]));
  const float m2 = sub_(mul_(A[i1][j0], A[i2][j2]), mul_(A[i1][j2], A[i2][j0]));
  const float m3 = sub_(mul_(A[i1][j0], A[i2][j1]), mul_(A[i1][j1], A[i2][j0]));
  return add_(sub_(mul_(A[i0][j0], m1), mul_(A[i0][j1], m2)),
              mul_(A[i0][j2], m3));
}

// The largest adjugate column of N - lam I, normalised, per-op.
__device__ __forceinline__ void adj_best_col_op(const float (&N)[4][4],
                                                float lam, float (&v)[4]) {
  float A[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) A[a][b] = (a == b) ? sub_(N[a][a], lam)
                                                   : N[a][b];
  }
  float best[4], best_norm = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r0 = k <= 0 ? 1 : 0, r1 = k <= 1 ? 2 : 1, r2 = k <= 2 ? 3 : 2;
    float col[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c0 = i <= 0 ? 1 : 0, c1 = i <= 1 ? 2 : 1;
      const int c2 = i <= 2 ? 3 : 2;
      const float d = det3_op(A, r0, r1, r2, c0, c1, c2);
      col[i] = ((i + k) & 1) ? -d : d;
    }
    const float nrm = sum4_op(col[0], col[0], col[1], col[1], col[2], col[2],
                              col[3], col[3]);
    if (k == 0 || nrm > best_norm) {  // strict: the first of equals
      best_norm = nrm;
#pragma unroll
      for (int i = 0; i < 4; ++i) best[i] = col[i];
    }
  }
  // clamp_min(best_norm, 1e-60): 1e-60 is 0 in fp32; NaN propagates.
  const float inv = rsqrt_div(max_nan(best_norm, 0.0f));
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = mul_(best[i], inv);
}

__device__ __forceinline__ float rayleigh_op(const float (&N)[4][4],
                                             const float (&v)[4]) {
  float nv[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    nv[a] = sum4_op(N[a][0], v[0], N[a][1], v[1], N[a][2], v[2], N[a][3],
                    v[3]);
  }
  return sum4_op(v[0], nv[0], v[1], nv[1], v[2], nv[2], v[3], nv[3]);
}

// a0 b0 + a1 b1 + a2 b2, left to right (_sum3 of a product).
__device__ __forceinline__ float sum3_op(float a0, float b0, float a1,
                                         float b1, float a2, float b2) {
  return add_(add_(mul_(a0, b0), mul_(a1, b1)), mul_(a2, b2));
}

__global__ void __launch_bounds__(kThreads)
    gather_hyp_kernel(const int* __restrict__ params,
                      const long long* __restrict__ perm,
                      const float* __restrict__ pq, int h,
                      float* __restrict__ w16t, float* __restrict__ t_norm,
                      uint8_t* __restrict__ disabled) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= h) return;
  const int* tri = params + 2 + 3 * static_cast<size_t>(j);
  const int d0 = tri[0], d1 = tri[1], d2 = tri[2];
  const long long id = static_cast<long long>(params[0]) + j;
  disabled[j] = (d0 == d1 || d1 == d2 || d0 == d2 || id >= params[1]) ? 1
                                                                      : 0;
  // P[s][c], Q[s][c]: coordinate c of sample s's source and target point.
  float P[3][3], Q[3][3];
  const int d[3] = {d0, d1, d2};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const float* row = pq + 6 * perm[d[s]];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      P[s][c] = row[c];
      Q[s][c] = row[3 + c];
    }
  }

  float sm[3], tm[3], pc[3][3], qc[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sm[c] = div_(add_(add_(P[0][c], P[1][c]), P[2][c]), 3.0f);
    tm[c] = div_(add_(add_(Q[0][c], Q[1][c]), Q[2][c]), 3.0f);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      pc[s][c] = sub_(P[s][c], sm[c]);
      qc[s][c] = sub_(Q[s][c], tm[c]);
    }
  }
  float S[3][3];  // S[a][b] = sum over samples of pc[.][a] qc[.][b]
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      S[a][b] = sum3_op(pc[0][a], qc[0][b], pc[1][a], qc[1][b], pc[2][a],
                        qc[2][b]);
    }
  }
  float e[3];  // per sample |pc|^2 + |qc|^2
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    e[s] = add_(sum3_op(pc[s][0], pc[s][0], pc[s][1], pc[s][1], pc[s][2],
                        pc[s][2]),
                sum3_op(qc[s][0], qc[s][0], qc[s][1], qc[s][1], qc[s][2],
                        qc[s][2]));
  }
  const float e0 = mul_(0.5f, add_(add_(e[0], e[1]), e[2]));

  // Horn matrix.
  const float sxx = S[0][0], sxy = S[0][1], sxz = S[0][2];
  const float syx = S[1][0], syy = S[1][1], syz = S[1][2];
  const float szx = S[2][0], szy = S[2][1], szz = S[2][2];
  float N[4][4];
  N[0][0] = add_(add_(sxx, syy), szz);
  N[0][1] = N[1][0] = sub_(syz, szy);
  N[0][2] = N[2][0] = sub_(szx, sxz);
  N[0][3] = N[3][0] = sub_(sxy, syx);
  N[1][1] = sub_(sub_(sxx, syy), szz);
  N[1][2] = N[2][1] = add_(sxy, syx);
  N[1][3] = N[3][1] = add_(szx, sxz);
  N[2][2] = sub_(add_(-sxx, syy), szz);
  N[2][3] = N[3][2] = add_(syz, szy);
  N[3][3] = add_(sub_(-sxx, syy), szz);

  float M[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = a; b < 4; ++b) {
      M[a][b] = M[b][a] = sum4_op(N[a][0], N[0][b], N[a][1], N[1][b],
                                  N[a][2], N[2][b], N[a][3], N[3][b]);
    }
  }
  const float tr2 = add_(add_(add_(M[0][0], M[1][1]), M[2][2]), M[3][3]);
  float off3 = mul_(N[0][1], M[0][1]), off4 = mul_(M[0][1], M[0][1]);
  off3 = add_(off3, mul_(N[0][2], M[0][2]));
  off4 = add_(off4, mul_(M[0][2], M[0][2]));
  off3 = add_(off3, mul_(N[0][3], M[0][3]));
  off4 = add_(off4, mul_(M[0][3], M[0][3]));
  off3 = add_(off3, mul_(N[1][2], M[1][2]));
  off4 = add_(off4, mul_(M[1][2], M[1][2]));
  off3 = add_(off3, mul_(N[1][3], M[1][3]));
  off4 = add_(off4, mul_(M[1][3], M[1][3]));
  off3 = add_(off3, mul_(N[2][3], M[2][3]));
  off4 = add_(off4, mul_(M[2][3], M[2][3]));
  const float tr3 = add_(sum4_op(N[0][0], M[0][0], N[1][1], M[1][1], N[2][2],
                                 M[2][2], N[3][3], M[3][3]),
                         mul_(2.0f, off3));
  const float tr4 = add_(sum4_op(M[0][0], M[0][0], M[1][1], M[1][1], M[2][2],
                                 M[2][2], M[3][3], M[3][3]),
                         mul_(2.0f, off4));
  const float c2 = mul_(-0.5f, tr2);
  const float c1 = div_(-tr3, 3.0f);
  const float c0 = mul_(-0.25f, add_(tr4, mul_(c2, tr2)));

  float lam = e0;  // lambda_max <= E0: Newton from above
#pragma unroll
  for (int it = 0; it < kNewton; ++it) {
    const float p =
        add_(mul_(add_(mul_(add_(mul_(lam, lam), c2), lam), c1), lam), c0);
    const float dp =
        add_(mul_(add_(mul_(mul_(4.0f, lam), lam), mul_(2.0f, c2)), lam), c1);
    lam = sub_(lam, div_(p, fabsf(dp) > 1e-20f ? dp : 1e-20f));
  }

  float v[4];
  adj_best_col_op(N, lam, v);
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    lam = rayleigh_op(N, v);
    adj_best_col_op(N, lam, v);
  }
  const float nrm = sum4_op(v[0], v[0], v[1], v[1], v[2], v[2], v[3], v[3]);
  const bool ok = isfinite(nrm) && nrm > 1e-12f;
  const float inv = rsqrt_div(ok ? nrm : 1.0f);
  const float q0 = ok ? mul_(v[0], inv) : 1.0f;
  const float qx = ok ? mul_(v[1], inv) : 0.0f;
  const float qy = ok ? mul_(v[2], inv) : 0.0f;
  const float qz = ok ? mul_(v[3], inv) : 0.0f;

  float r[9];
  r[0] = sub_(sub_(add_(mul_(q0, q0), mul_(qx, qx)), mul_(qy, qy)),
              mul_(qz, qz));
  r[1] = mul_(2.0f, sub_(mul_(qx, qy), mul_(q0, qz)));
  r[2] = mul_(2.0f, add_(mul_(qx, qz), mul_(q0, qy)));
  r[3] = mul_(2.0f, add_(mul_(qy, qx), mul_(q0, qz)));
  r[4] = sub_(add_(sub_(mul_(q0, q0), mul_(qx, qx)), mul_(qy, qy)),
              mul_(qz, qz));
  r[5] = mul_(2.0f, sub_(mul_(qy, qz), mul_(q0, qx)));
  r[6] = mul_(2.0f, sub_(mul_(qz, qx), mul_(q0, qy)));
  r[7] = mul_(2.0f, add_(mul_(qz, qy), mul_(q0, qx)));
  r[8] = add_(sub_(sub_(mul_(q0, q0), mul_(qx, qx)), mul_(qy, qy)),
              mul_(qz, qz));
  float t[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    t[a] = sub_(tm[a], sum3_op(r[3 * a], sm[0], r[3 * a + 1], sm[1],
                               r[3 * a + 2], sm[2]));
  }

  const size_t hs = static_cast<size_t>(h);
#pragma unroll
  for (int a = 0; a < 3; ++a) {  // R^T t
    w16t[a * hs + j] = sum3_op(r[a], t[0], r[3 + a], t[1], r[6 + a], t[2]);
    w16t[(3 + a) * hs + j] = t[a];
  }
#pragma unroll
  for (int a = 0; a < 9; ++a) w16t[(6 + a) * hs + j] = r[a];
  w16t[15 * hs + j] = 0.0f;
  t_norm[j] = sum3_op(t[0], t[0], t[1], t[1], t[2], t[2]);
}

}  // namespace

// pq2p: f32 (6, 2n) plane table; params: i32 [first_id, count,
// max_iterations, then (r0, r1, r2) per epoch]; outputs w16t f32 (16, h),
// t_norm f32 (h), disabled u8 (h).
extern "C" int tpu3d_ransac_hyp(const void* pq2p, const void* params, int n,
                                int h, void* w16t, void* t_norm,
                                void* disabled, void* stream) {
  if (n <= 0 || h < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0) return static_cast<int>(cudaGetLastError());
  ransac_hyp_kernel<<<(h + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pq2p), static_cast<const int*>(params), n, h,
      static_cast<float*>(w16t), static_cast<float*>(t_norm),
      static_cast<uint8_t*>(disabled));
  return static_cast<int>(cudaGetLastError());
}

// params: i32 [first_id, max_iterations, then (d0, d1, d2) per
// hypothesis], each draw a valid-row rank in [0, n); perm: i64 (n) rows,
// valid first; pq: f32 (n, 6) p|q rows; outputs w16t f32 (16, h), t_norm
// f32 (h), disabled u8 (h).
extern "C" int tpu3d_gather_hyp(const void* params, const void* perm,
                                const void* pq, int h, void* w16t,
                                void* t_norm, void* disabled, void* stream) {
  if (h < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0) return static_cast<int>(cudaGetLastError());
  gather_hyp_kernel<<<(h + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(params), static_cast<const long long*>(perm),
      static_cast<const float*>(pq), h, static_cast<float*>(w16t),
      static_cast<float*>(t_norm), static_cast<uint8_t*>(disabled));
  return static_cast<int>(cudaGetLastError());
}
