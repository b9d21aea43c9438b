// K12: the k smallest values of each row of a distance block, ascending,
// with their columns; ties at the lower column first.
//
// Replaces no Pallas kernel. The JAX package's exact k-NN
// (tpu3d/ops/neighbors.py: knn) keeps its k columns by lax.top_k, which
// XLA compiles; the port's plain version is a stable ascending sort of
// the whole row and a slice (ops/neighbors.py: knn_select_plain), which
// on the card is a segmented radix sort of every element (Q x M keys a
// chunk) only to keep k of them. K12 selects the same (value, column)
// pairs, bit for bit: it computes nothing, it only picks.
//
// Input: d2 f32[Q, M], each value >= +0.0 (a squared distance, or the
// 1e30 sentinel, or the sum of both): for such values the fp32 bits, read
// as unsigned integers, order as the values do, so a row's k smallest are
// the k smallest bit patterns, and (bits, column) is a key that orders
// as the stable sort does. (NaN bits lie above every finite value's and
// +inf's, where the stable sort also puts them.)
//
// What bounds it on an H100: bytes, Q*M*4 read and Q*k*8 written (33.6 MB
// for a 1,024 x 8,192 chunk: ~10 us at 3.35 TB/s).
// Design (a CTA of 256 threads a row):
// - The row is staged once in shared memory (uint4 loads where aligned)
//   when it fits beside the static arrays in 48 KB (M <= 10,240: every
//   capacity of the gather route); a longer row is read from global
//   memory on each pass.
// - A radix select on the 32-bit keys, 8 bits a pass from the top: each
//   pass counts the digits of the keys that share the prefix found so
//   far in a 256-bin shared histogram (lanes with the same digit add
//   once, by __match_any_sync: a row's distances share few top bytes),
//   and warp 0 finds the bin holding the k-th smallest by a shuffle scan.
//   After four passes the k-th key T is known, and so how many keys equal
//   to T belong to the answer ("need"); the rest lie below T.
// - One pass collects: a key below T takes a slot by a shared atomic (its
//   place is fixed by the sort below); the keys equal to T are ranked in
//   column order by a block scan of ballots, and the first "need" of them
//   are taken. So exactly k (bits << 32 | column) keys are kept.
// - A bitonic sort of the kept keys (k <= 128, padded to a power of two)
//   in shared memory, then k values and columns are written.
// No atomics decide a result and no float is computed: deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;
constexpr int kStagedMaxM = 10240;  // 40 KB of keys, ~2 KB static
constexpr unsigned kFull = 0xffffffffu;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
knn_select_kernel(const unsigned* __restrict__ d2, int m, int k, int sort_n,
                  float* __restrict__ out_d2, int* __restrict__ out_idx) {
  extern __shared__ unsigned staged[];
  __shared__ unsigned hist[256];
  __shared__ unsigned long long kept[kMaxK];
  __shared__ unsigned warp_eq[2][kWarps];
  __shared__ unsigned s_digit, s_below, s_less;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned* row = d2 + static_cast<size_t>(blockIdx.x) * m;
  const unsigned* keys = row;
  if (kStaged) {
    if ((m & 3) == 0 && (reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(row);
      uint4* dst = reinterpret_cast<uint4*>(staged);
      for (int i = tid; i < (m >> 2); i += kThreads) dst[i] = src[i];
    } else {
      for (int i = tid; i < m; i += kThreads) staged[i] = row[i];
    }
    keys = staged;
  }
  if (tid == 0) s_less = 0;

  // Radix select: the k-th smallest key T, and how many keys equal to T
  // the answer holds (rank, 1-based among the keys that share T).
  unsigned prefix = 0, pmask = 0, rank = static_cast<unsigned>(k);
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int base = warp * 32; base < m; base += kThreads) {
      const int i = base + lane;
      const unsigned key = i < m ? keys[i] : 0u;
      const bool take = i < m && (key & pmask) == prefix;
      const unsigned active = __ballot_sync(kFull, take);
      if (take) {
        const unsigned digit = (key >> shift) & 255u;
        const unsigned peers = __match_any_sync(active, digit);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {
      unsigned c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[lane * 8 + j];
        s += c[j];
      }
      unsigned incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned excl = incl - s;
      const unsigned hit = __ballot_sync(kFull, excl < rank && rank <= incl);
      if (lane == __ffs(hit) - 1) {
        unsigned below = excl;
        int d = lane * 8 + 7;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (below + c[j] >= rank) {
            d = lane * 8 + j;
            break;
          }
          below += c[j];
        }
        s_digit = static_cast<unsigned>(d);
        s_below = below;
      }
    }
    __syncthreads();
    prefix |= s_digit << shift;
    pmask |= 255u << shift;
    rank -= s_below;
  }
  const unsigned t_key = prefix;
  const unsigned need = rank;
  const unsigned less = static_cast<unsigned>(k) - need;

  // Collect: every key below T, and the first `need` keys equal to T in
  // column order (a block scan of each tile's ballots).
  const unsigned lanes_below = (1u << lane) - 1u;
  unsigned eq_base = 0;
  int buf = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int i = base + tid;
    const unsigned key = i < m ? keys[i] : kFull;
    const bool eq = i < m && key == t_key;
    if (i < m && key < t_key) {
      const unsigned slot = atomicAdd(&s_less, 1u);
      kept[slot] = (static_cast<unsigned long long>(key) << 32) |
                   static_cast<unsigned>(i);
    }
    const unsigned eb = __ballot_sync(kFull, eq);
    if (lane == 0) warp_eq[buf][warp] = __popc(eb);
    __syncthreads();
    unsigned before = eq_base + __popc(eb & lanes_below);
    unsigned tile = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned n = warp_eq[buf][w];
      if (w < warp) before += n;
      tile += n;
    }
    if (eq && before < need) {
      kept[less + before] = (static_cast<unsigned long long>(t_key) << 32) |
                            static_cast<unsigned>(i);
    }
    eq_base += tile;
    buf ^= 1;
  }
  for (int j = k + tid; j < sort_n; j += kThreads) kept[j] = ~0ull;

  // Bitonic sort of the sort_n kept keys, ascending.
  for (int size = 2; size <= sort_n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      if (tid < sort_n) {
        const int j = tid ^ stride;
        if (j > tid) {
          const unsigned long long a = kept[tid], b = kept[j];
          const bool up = (tid & size) == 0;
          if ((a > b) == up) {
            kept[tid] = b;
            kept[j] = a;
          }
        }
      }
    }
  }
  __syncthreads();
  if (tid < k) {
    const unsigned long long v = kept[tid];
    const size_t o = static_cast<size_t>(blockIdx.x) * k + tid;
    out_d2[o] = __uint_as_float(static_cast<unsigned>(v >> 32));
    out_idx[o] = static_cast<int>(v & 0xffffffffu);
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// d2 f32[q, m] (contiguous) -> out_d2 f32[q, k], out_idx i32[q, k];
// 1 <= k <= min(m, 128).
extern "C" int tpu3d_knn_select(const void* d2, int q, int m, int k,
                                void* out_d2, void* out_idx, void* stream) {
  if (q < 0 || m < 1 || k < 1 || k > kMaxK || k > m) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (q == 0) return last_error();
  int sort_n = 1;
  while (sort_n < k) sort_n <<= 1;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const unsigned*>(d2);
  auto* od = static_cast<float*>(out_d2);
  auto* oi = static_cast<int*>(out_idx);
  if (m <= kStagedMaxM) {
    knn_select_kernel<true><<<q, kThreads, m * sizeof(unsigned), s>>>(
        in, m, k, sort_n, od, oi);
  } else {
    knn_select_kernel<false><<<q, kThreads, 0, s>>>(in, m, k, sort_n, od, oi);
  }
  return last_error();
}
