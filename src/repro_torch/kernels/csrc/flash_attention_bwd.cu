// Flash attention's backward for Hopper (sm_90a), on tensor cores.
//
// The backward of the forward kernel in flash_attention.cu, which replaces
// the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py; the JAX package differentiates the
// plain attention (`kernels/ref.py::flash_attention_ref`), whose gradients
// these are.  FlashAttention-2's form (Dao 2023, Algorithm 2): with the
// scale c = d^-1/2, the masked scores S = c q.k^T, the rows' log-sum-exp
// `lse` that the forward wrote, and dO the output's gradient,
//
//   P = exp(S - lse),  D = rowsum(dO o O),
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = c dS K,  dK = c dS^T Q,
//
// under the forward's masks by index: with `causal`, key j is seen when
// i >= j and, with a window w > 0, i - j < w; without `causal` every key.
// A row whose band holds no key (i - (sk - 1) >= w) weighs every key 1/sk
// in the forward (its masked scores are a finite -1e30), so it adds dO/sk
// to every dV row and nothing to dQ or dK; those rows are found by index,
// since in f32 -1e30 + log(sk) rounds back to -1e30 and exp(S - lse)
// would give 1.
//
// Layouts as the forward's: q, dq, out, dO (b, h, sq, d); k, v, dk, dv
// (b, kv, sk, d), kv dividing h; each given by its (b, head, position)
// strides with d contiguous.  lse (b, h, sq) f32, contiguous.  f32 or
// bf16, d in {16, 32, 64, 128}, any sq, sk >= 1.
//
// What bounds it: operations.  Five products of 2 b h d multiply-adds per
// kept (query, key) pair; this design runs seven (S and dP twice, once in
// each of the two kernels below), so that no sum crosses blocks: the
// gradients are deterministic, with no atomics.  Three launches in order:
//   1. rows, one warp a query row: D = rowsum(dO o O) and lse in log2
//      units (+inf for a row that sees no key, so its P is 0), as scratch;
//   2. dK/dV, grid (key tile, KV head, batch row): a block owns 64 keys of
//      one KV head, 16 a warp, and walks every query head of its group
//      and every query tile that sees its keys (and the tiles of rows that
//      see none): S^T = K Q^T and dP^T = V dO^T from shared memory, P^T
//      and dS^T in registers, then dV += P^T dO and dK += dS^T Q with P^T
//      and dS^T as register A operands (no shuffles), each tile's product
//      summed apart and added in f32 (tensor cores truncate their sums);
//   3. dQ, grid (query tile, head, batch row): a block owns 64 query rows,
//      16 a warp, and walks the key tiles its rows see: S, dP, then
//      dQ += dS K.
// Query tiles (dK/dV) and key tiles (dQ) are double-buffered by 16-byte
// cp.async (single-buffered for f32 at d 128, for two blocks an SM).  f32 runs three TF32 passes of mma.sync (f32-accurate,
// tf32_mma.cuh); bf16 runs mma.sync m16n8k16 with f32 accumulators, P and
// dS rounded to bf16 before their products.  wgmma, TMA and a pipeline
// across warpgroups are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kThreads = 128;
constexpr int kRows = 64;  // keys (dK/dV) or queries (dQ) a block, 16 a warp

struct Strides {
  long long b, h, s;
};

// Shared-memory row length in elements: d plus a pad that keeps rows
// 16-byte aligned and the fragment loads free of bank conflicts.
template <typename T, int D>
__host__ __device__ constexpr int row_len() {
  return D + (sizeof(T) == 4 ? 4 : 8);
}
// The other side's tile: queries a step of the dK/dV kernel, keys a step
// of the dQ kernel (32 at d 128, which keeps the registers under 255).
template <int D>
__host__ __device__ constexpr int step_len() {
  return D == 128 ? 32 : 64;
}
// Stages of that tile's ring: one for f32 at d 128, where two would take
// 135 KB of shared memory and leave one block (4 warps) an SM; a single
// stage fits two, whose loads overlap each other's products.
template <typename T, int D>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 4 && D == 128 ? 1 : 2;
}

__device__ __forceinline__ bool kept(int i, int j, int sk, int causal,
                                     int window) {
  return j < sk && (!causal || (j <= i && (window <= 0 || i - j < window)));
}

// Whether query row i sees no key at all.
__device__ __forceinline__ bool no_key(int i, int sk, int causal,
                                       int window) {
  return causal && window > 0 && i - (sk - 1) >= window;
}

// Whether no (query, key) pair of rows [r, r + rows) and keys
// [kt, kt + keys) is masked.
__device__ __forceinline__ bool unmasked(int r, int rows, int kt, int keys,
                                         int sk, int causal, int window) {
  return kt + keys <= sk &&
         (!causal || (kt + keys - 1 <= r &&
                      (window <= 0 || r + rows - 1 - kt < window)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// c += a.b, bf16 m16n8k16 with f32 accumulation.  Fragments, lane = 4g + t:
//   A: a0 (g, 2t, 2t + 1), a1 (g + 8, 2t, 2t + 1), a2 (g, 2t + 8, 2t + 9),
//      a3 (g + 8, 2t + 8, 2t + 9);  B: b0 (2t, 2t + 1; g), b1 (2t + 8,
//      2t + 9; g) as (k; n);  C as m16n8k8's.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp: acc[nt] += A[0 .. 16, 0 .. K) . B[0 .. K, 8 nt .. 8 nt + 8),
// a(r, k) and b(k, c) returning f32 elements from shared memory.  f32:
// three TF32 passes (K a multiple of 8); bf16: the elements are bf16
// values, packed back exactly (K a multiple of 16).
template <typename T, int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int K, FA a,
                                         FB b) {
  if constexpr (std::is_same<T, float>::value) {
    tc::warp_mma3<NT>(acc, K, a, b);
  } else {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int c = k0 + 2 * t;
      const uint32_t af[4] = {pack_bf16(a(g, c), a(g, c + 1)),
                              pack_bf16(a(g + 8, c), a(g + 8, c + 1)),
                              pack_bf16(a(g, c + 8), a(g, c + 9)),
                              pack_bf16(a(g + 8, c + 8), a(g + 8, c + 9))};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = 8 * nt + g;
        const uint32_t bf[2] = {pack_bf16(b(c, n), b(c + 1, n)),
                                pack_bf16(b(c + 8, n), b(c + 9, n))};
        mma_bf16(acc[nt], af, bf);
      }
    }
  }
}

// One warp: acc[nt] += P . B with P (16 x 8 KT) held as the C fragments
// p[KT][4] of a product: f32 by tc::frag_mma3; bf16 rounds P and takes two
// fragments a k-step of 16 (columns 2t, 2t + 1 of each are A's), no
// shuffles either way.
template <typename T, int NT, int KT, typename FB>
__device__ __forceinline__ void frag_mma(float (&acc)[NT][4],
                                         const float (&p)[KT][4], FB b) {
  if constexpr (std::is_same<T, float>::value) {
    tc::frag_mma3<NT, KT>(acc, p, b);
  } else {
    static_assert(KT % 2 == 0, "bf16 k-steps take two fragments");
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      const uint32_t af[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
      const int c = 16 * kk + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = 8 * nt + g;
        const uint32_t bf[2] = {pack_bf16(b(c, n), b(c + 1, n)),
                                pack_bf16(b(c + 8, n), b(c + 9, n))};
        mma_bf16(acc[nt], af, bf);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Store a warp's 16 rows x D of f32 accumulators (times `scale`), rows
// from `r_first`, the rows at or past `limit` skipped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long stride,
                                           const float (&acc)[D / 8][4],
                                           int r_first, int limit,
                                           float scale) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_first + g + 8 * half;
    if (r < limit) {
      T* out = base + r * stride;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        out[8 * dn + 2 * t] = from_float<T>(acc[dn][2 * half] * scale);
        out[8 * dn + 2 * t + 1] =
            from_float<T>(acc[dn][2 * half + 1] * scale);
      }
    }
  }
}

// ------------------------------------------------------------ 1. rows
// One warp a query row: D = rowsum(dO o O) in f32, and lse in log2 units
// (+inf for a row that sees no key, whose P the kernels take as 0).  rows
// holds the lse plane, then the D plane, each (b, h, sq).
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_rows_kernel(const T* __restrict__ out,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ rows, Strides os, Strides dos,
                          int h, int sq, int sk, int d, int causal,
                          int window, long long total) {
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= total) return;
  const int i = (int)(r % sq);
  const long long bh = r / sq;
  const int head = (int)(bh % h);
  const int row = (int)(bh / h);
  const T* o = out + row * os.b + head * os.h + i * os.s;
  const T* g = dout + row * dos.b + head * dos.h + i * dos.s;
  float acc = 0.f;
  for (int e = lane; e < d; e += 32)
    acc += tc::to_float(o[e]) * tc::to_float(g[e]);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    rows[r] = no_key(i, sk, causal, window) ? INFINITY : lse[r] * kLog2e;
    rows[total + r] = acc;
  }
}

// ------------------------------------------------------------ 2. dK, dV
// Shared memory: K and V (kRows rows each), then the stages of a Q and a
// dO tile (BQ rows each), then the stages of the tile's per-row lse, D
// and 1/sk weight.
template <typename T, int D>
__host__ __device__ constexpr size_t dkdv_smem() {
  return (2 * (size_t)kRows + 2 * stages<T, D>() * (size_t)step_len<D>()) *
             row_len<T, D>() * sizeof(T) +
         stages<T, D>() * 3 * (size_t)step_len<D>() * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ rows,
                          T* __restrict__ dk, T* __restrict__ dv, Strides qs,
                          Strides ks, Strides vs, Strides dos, Strides dks,
                          Strides dvs, int b, int h, int kv, int sq, int sk,
                          int causal, int window, float scale_log2,
                          float scale) {
  constexpr int LD = row_len<T, D>();
  constexpr int BQ = step_len<D>();
  constexpr int S = stages<T, D>();
  constexpr int DC = D < 64 ? D : 64;  // output columns a pass
  const int k0 = blockIdx.x * kRows;
  const int kv_head = blockIdx.y;
  const int row = blockIdx.z;
  const int group = h / kv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = 16 * warp;
  const long long plane = (long long)b * h * sq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kRows * LD;
  T* ring = v_s + kRows * LD;  // stage: Q tile, dO tile
  float* row_s = reinterpret_cast<float*>(ring + 2 * S * BQ * LD);

  const T* k_bh = k + row * ks.b + kv_head * ks.h + (long long)k0 * ks.s;
  const T* v_bh = v + row * vs.b + kv_head * vs.h + (long long)k0 * vs.s;
  const int keys = min(kRows, sk - k0);
  tc::stage(k_s, LD, k_bh, ks.s, keys, kRows, D, D, tc::aligned16(k_bh, ks.s));
  tc::stage(v_s, LD, v_bh, vs.s, keys, kRows, D, D, tc::aligned16(v_bh, vs.s));

  // The query tiles that see these keys, then the tiles of rows that see
  // no key (whose band ends before key 0 of this tile could reach them).
  const int k1 = k0 + keys;
  const int q_tiles = (sq + BQ - 1) / BQ;
  int start1 = 0, n1 = q_tiles, start2 = 0, n2 = 0;
  if (causal) {
    const int hi = window > 0 ? min(sq, k1 - 1 + window) : sq;
    start1 = k0 / BQ;
    n1 = k0 < hi ? (hi + BQ - 1) / BQ - start1 : 0;
    if (window > 0 && sk - 1 + window < sq) {
      start2 = max((sk - 1 + window) / BQ, start1 + n1);
      n2 = max(q_tiles - start2, 0);
    }
  }
  const int steps = n1 + n2;
  const int total = steps * group;
  const float uniform = 1.f / sk;

  auto tile_of = [&](int it, int& head, int& q0) {
    head = kv_head * group + it / steps;
    const int i = it % steps;
    q0 = (i < n1 ? start1 + i : start2 + i - n1) * BQ;
  };
  auto stage = [&](int it) {
    int head, q0;
    tile_of(it, head, q0);
    T* q_s = ring + (it % S) * 2 * BQ * LD;
    const T* q_bh = q + row * qs.b + head * qs.h + (long long)q0 * qs.s;
    const T* d_bh = dout + row * dos.b + head * dos.h + (long long)q0 * dos.s;
    const int n = min(BQ, sq - q0);
    tc::stage(q_s, LD, q_bh, qs.s, n, BQ, D, D, tc::aligned16(q_bh, qs.s));
    tc::stage(q_s + BQ * LD, LD, d_bh, dos.s, n, BQ, D, D,
              tc::aligned16(d_bh, dos.s));
    float* r_s = row_s + (it % S) * 3 * BQ;
    const long long off = ((long long)row * h + head) * sq + q0;
    for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
      const bool in = r < n;
      r_s[r] = in ? rows[off + r] : INFINITY;
      r_s[BQ + r] = in ? rows[plane + off + r] : 0.f;
      r_s[2 * BQ + r] =
          in && no_key(q0 + r, sk, causal, window) ? uniform : 0.f;
    }
    tc::cp_async_commit();
  };

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  if (total > 0)
    stage(0);
  else
    tc::cp_async_commit();
  for (int it = 0; it < total; ++it) {
    tc::cp_async_wait<0>();
    // tile `it` is in; with two stages, every warp is done with the
    // buffers it + 1 fills
    __syncthreads();
    if (S == 2 && it + 1 < total) stage(it + 1);
    int head, q0;
    tile_of(it, head, q0);
    const T* q_s = ring + (it % S) * 2 * BQ * LD;
    const T* do_s = q_s + BQ * LD;
    const float* lse_s = row_s + (it % S) * 3 * BQ;
    const float* dsum_s = lse_s + BQ;
    const float* unif_s = dsum_s + BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float st[BQ / 8][4] = {}, dpt[BQ / 8][4] = {};
    warp_mma<T, BQ / 8>(
        st, D,
        [&](int r, int kk) { return tc::to_float(k_s[(wr + r) * LD + kk]); },
        [&](int kk, int c) { return tc::to_float(q_s[c * LD + kk]); });
    warp_mma<T, BQ / 8>(
        dpt, D,
        [&](int r, int kk) { return tc::to_float(v_s[(wr + r) * LD + kk]); },
        [&](int kk, int c) { return tc::to_float(do_s[c * LD + kk]); });

    // P^T into st, dS^T into dpt; masks only on tiles that need them
    const bool full = unmasked(q0, BQ, k0, kRows, sk, causal, window);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nt + 2 * t + (e & 1);
        const int j = k0 + wr + g + (e < 2 ? 0 : 8);
        float p = exp2f(st[nt][e] * scale_log2 - lse_s[c]);
        if (!full && !kept(q0 + c, j, sk, causal, window)) p = 0.f;
        dpt[nt][e] = p * (dpt[nt][e] - dsum_s[c]);
        st[nt][e] = full ? p : p + (j < sk ? unif_s[c] : 0.f);
      }

    // dV += P^T dO, dK += dS^T Q, DC columns a pass
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += DC) {
      float part[DC / 8][4] = {};
      frag_mma<T, DC / 8, BQ / 8>(part, st, [&](int kk, int n) {
        return tc::to_float(do_s[kk * LD + c0 + n]);
      });
#pragma unroll
      for (int i = 0; i < DC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[c0 / 8 + i][e] += part[i][e];
          part[i][e] = 0.f;
        }
      frag_mma<T, DC / 8, BQ / 8>(part, dpt, [&](int kk, int n) {
        return tc::to_float(q_s[kk * LD + c0 + n]);
      });
#pragma unroll
      for (int i = 0; i < DC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[c0 / 8 + i][e] += part[i][e];
    }
    if (S == 1 && it + 1 < total) {
      __syncthreads();  // every warp is done with the one buffer
      stage(it + 1);
    }
  }
  tc::cp_async_wait<0>();

  T* dk_bh = dk + row * dks.b + kv_head * dks.h + (long long)k0 * dks.s;
  T* dv_bh = dv + row * dvs.b + kv_head * dvs.h + (long long)k0 * dvs.s;
  store_rows<T, D>(dk_bh, dks.s, dk_acc, wr, keys, scale);
  store_rows<T, D>(dv_bh, dvs.s, dv_acc, wr, keys, 1.f);
}

// ------------------------------------------------------------------ 3. dQ
// Shared memory: the Q and dO tiles (kRows rows each), then the stages of
// a K and a V tile (BN rows each).
template <typename T, int D>
__host__ __device__ constexpr size_t dq_smem() {
  return (2 * (size_t)kRows + 2 * stages<T, D>() * (size_t)step_len<D>()) *
         row_len<T, D>() * sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ rows, T* __restrict__ dq,
                        Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dqs, int b, int h, int kv, int sq, int sk,
                        int causal, int window, float scale_log2,
                        float scale) {
  constexpr int LD = row_len<T, D>();
  constexpr int BN = step_len<D>();
  constexpr int S = stages<T, D>();
  constexpr int DC = D < 64 ? D : 64;
  const int q0 = blockIdx.x * kRows;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int kv_head = head / (h / kv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = 16 * warp;
  const long long plane = (long long)b * h * sq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + kRows * LD;
  T* ring = do_s + kRows * LD;  // stage: K tile, V tile

  const int n_rows = min(kRows, sq - q0);
  const T* q_bh = q + row * qs.b + head * qs.h + (long long)q0 * qs.s;
  const T* d_bh = dout + row * dos.b + head * dos.h + (long long)q0 * dos.s;
  tc::stage(q_s, LD, q_bh, qs.s, n_rows, kRows, D, D,
            tc::aligned16(q_bh, qs.s));
  tc::stage(do_s, LD, d_bh, dos.s, n_rows, kRows, D, D,
            tc::aligned16(d_bh, dos.s));

  // this thread's rows r0 and r1 = r0 + 8: lse (log2 units; +inf past sq
  // and for rows that see no key) and D
  const int r0 = q0 + wr + g;
  const int r1 = r0 + 8;
  const long long off = ((long long)row * h + head) * sq;
  const float lse0 = r0 < sq ? rows[off + r0] : INFINITY;
  const float lse1 = r1 < sq ? rows[off + r1] : INFINITY;
  const float dsum0 = r0 < sq ? rows[plane + off + r0] : 0.f;
  const float dsum1 = r1 < sq ? rows[plane + off + r1] : 0.f;

  // the keys some row of the tile sees
  const int q_last = q0 + n_rows - 1;
  int k_begin = 0, k_end = sk;
  if (causal) {
    k_end = min(sk, q_last + 1);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  const T* k_bh = k + row * ks.b + kv_head * ks.h;
  const T* v_bh = v + row * vs.b + kv_head * vs.h;
  const bool k_vec = tc::aligned16(k_bh, ks.s);
  const bool v_vec = tc::aligned16(v_bh, vs.s);
  auto stage_kv = [&](int it) {
    const int kt = k_begin + it * BN;
    const int n = min(BN, sk - kt);
    T* k_t = ring + (it % S) * 2 * BN * LD;
    tc::stage(k_t, LD, k_bh + (long long)kt * ks.s, ks.s, n, BN, D, D,
              k_vec);
    tc::stage(k_t + BN * LD, LD, v_bh + (long long)kt * vs.s, vs.s, n, BN, D,
              D, v_vec);
    tc::cp_async_commit();
  };

  float dq_acc[D / 8][4] = {};
  if (n_tiles > 0)
    stage_kv(0);
  else
    tc::cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    tc::cp_async_wait<0>();
    __syncthreads();
    if (S == 2 && it + 1 < n_tiles) stage_kv(it + 1);
    const int kt = k_begin + it * BN;
    const T* k_t = ring + (it % S) * 2 * BN * LD;
    const T* v_t = k_t + BN * LD;

    float s[BN / 8][4] = {}, dp[BN / 8][4] = {};
    warp_mma<T, BN / 8>(
        s, D,
        [&](int r, int kk) { return tc::to_float(q_s[(wr + r) * LD + kk]); },
        [&](int kk, int c) { return tc::to_float(k_t[c * LD + kk]); });
    warp_mma<T, BN / 8>(
        dp, D,
        [&](int r, int kk) { return tc::to_float(do_s[(wr + r) * LD + kk]); },
        [&](int kk, int c) { return tc::to_float(v_t[c * LD + kk]); });

    const bool full = unmasked(q0, kRows, kt, BN, sk, causal, window);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? r0 : r1;
        const int j = kt + 8 * nt + 2 * t + (e & 1);
        float p = exp2f(s[nt][e] * scale_log2 - (e < 2 ? lse0 : lse1));
        if (!full && !kept(i, j, sk, causal, window)) p = 0.f;
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? dsum0 : dsum1));
      }

#pragma unroll
    for (int c0 = 0; c0 < D; c0 += DC) {
      float part[DC / 8][4] = {};
      frag_mma<T, DC / 8, BN / 8>(part, s, [&](int kk, int n) {
        return tc::to_float(k_t[kk * LD + c0 + n]);
      });
#pragma unroll
      for (int i = 0; i < DC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[c0 / 8 + i][e] += part[i][e];
    }
    if (S == 1 && it + 1 < n_tiles) {
      __syncthreads();  // every warp is done with the one buffer
      stage_kv(it + 1);
    }
  }
  tc::cp_async_wait<0>();

  T* dq_bh = dq + row * dqs.b + head * dqs.h + (long long)q0 * dqs.s;
  store_rows<T, D>(dq_bh, dqs.s, dq_acc, wr, n_rows, scale);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   void* dq, void* dk, void* dv, void* rows,
                   const Strides* st, int b, int h, int kv, int sq, int sk,
                   int causal, int window, float scale,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  float* rf = static_cast<float*>(rows);
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;

  const long long total = (long long)b * h * sq;
  const long long blocks = (total + 7) / 8;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_rows_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(out), dot, static_cast<const float*>(lse), rf,
      st[3], st[4], h, sq, sk, D, causal, window, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr size_t smem2 = dkdv_smem<T, D>();
  static_assert(smem2 <= kMaxSmem, "flash backward (dK/dV): shared memory");
  if ((err = allow_smem(flash_bwd_dkdv_kernel<T, D>, smem2)) != cudaSuccess)
    return err;
  flash_bwd_dkdv_kernel<T, D>
      <<<dim3((sk + kRows - 1) / kRows, kv, b), kThreads, smem2, stream>>>(
          qt, kt, vt, dot, rf, static_cast<T*>(dk), static_cast<T*>(dv),
          st[0], st[1], st[2], st[4], st[6], st[7], b, h, kv, sq, sk, causal,
          window, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr size_t smem3 = dq_smem<T, D>();
  static_assert(smem3 <= kMaxSmem, "flash backward (dQ): shared memory");
  if ((err = allow_smem(flash_bwd_dq_kernel<T, D>, smem3)) != cudaSuccess)
    return err;
  flash_bwd_dq_kernel<T, D>
      <<<dim3((sq + kRows - 1) / kRows, h, b), kThreads, smem3, stream>>>(
          qt, kt, vt, dot, rf, static_cast<T*>(dq), st[0], st[1], st[2],
          st[4], st[5], b, h, kv, sq, sk, causal, window, scale_log2, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int d, const void* q, const void* k,
                              const void* v, const void* out,
                              const void* dout, const void* lse, void* dq,
                              void* dk, void* dv, void* rows,
                              const Strides* st, int b, int h, int kv,
                              int sq, int sk, int causal, int window,
                              float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, dout, lse, dq, dk, dv, rows, st, b,
                           h, kv, sq, sk, causal, window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, dout, lse, dq, dk, dv, rows, st, b,
                           h, kv, sq, sk, causal, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, lse, dq, dk, dv, rows, st, b,
                           h, kv, sq, sk, causal, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, lse, dq, dk, dv, rows, st, b,
                            h, kv, sq, sk, causal, window, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: 24 element strides, (batch, head, position) for q, k, v, out,
// dout, dq, dk and dv in turn; the last dimension of each is contiguous.
// lse (b, h, sq) f32 from the forward; rows is (2, b, h, sq) f32 scratch
// that the call overwrites before it reads.  dtype: 0 = float32, 1 =
// bfloat16; window <= 0 means none.  Launches three kernels on `stream`;
// returns the first launch error.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* rows, const long long* strides, int b, int h, int kv, int sq,
    int sk, int d, int causal, int window, int dtype, float scale,
    void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kv < 1 || h % kv != 0 ||
      sq < 1 || sk < 1)
    return cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(d, q, k, v, out, dout, lse, dq, dk, dv,
                                    rows, st, b, h, kv, sq, sk, causal,
                                    window, scale, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(d, q, k, v, out, dout, lse, dq,
                                            dk, dv, rows, st, b, h, kv, sq,
                                            sk, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
