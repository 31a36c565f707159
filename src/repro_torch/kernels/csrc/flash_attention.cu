// Flash attention (forward) for Hopper (sm_90a), on tensor cores.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py.  Computes, for every batch row,
// query head and query position i,
//
//     out_i = softmax_j(q_i . k_j * d^-1/2, masked) . v
//
// with f32 accumulators, an online softmax over key tiles, the finite mask
// value -1e30 and the denominator floored at 1e-30, output in q's dtype.
// Masks are by index: with `causal`, key j is seen when i >= j and, with a
// window w > 0, i - j < w.  Without `causal` every key is seen and the
// window is not applied, as in the reference oracle and the model (the
// Pallas kernel applies the window either way).  A row whose band holds no
// key at all gets the mean of V, as the oracle does.
//
// Layouts: q (b, h, sq, d); k, v (b, kv, sk, d) with kv dividing h (GQA:
// query head i reads KV head i / (h / kv), so K/V are never repeated in
// memory); out (b, h, sq, d).  Each is given by its (b, head, position)
// strides with d contiguous, so the model passes its (b, s, heads, d)
// tensors as transposed views, without copies.  Any sq, sk >= 1 (the
// Pallas kernel needs multiples of its block): the ragged last tiles are
// masked here.
//
// What bounds it: operations.  A causal call does about 2 b h sq sk d
// multiply-adds over (2 b h sq + 2 b kv sk) d elements.  Three routes, by
// dtype and head dim alone (there is no fallback between them):
//
// - bfloat16, d in {16, 32, 64, 128}: `wgmma` at the native bf16 rate, in
//   a persistent kernel: one block of 384 threads an SM walks work items of
//   128 query rows of one head (heaviest first under `causal`; the heads
//   of a KV head adjacent, so their K/V tiles come from L2).  A producer
//   warpgroup, of which one thread issues TMA loads (each item's Q into one
//   of two buffers, K and V tiles of 128 keys into rings of their own of 2
//   or 3 stages, completion on mbarriers, running ahead across items), hands
//   its registers to the consumers with `setmaxnreg`.  Two consumer
//   warpgroups of 64 rows each take turns at the tensor cores on named
//   barriers (FlashAttention-3's ping-pong; the order is enforced, not left
//   to the warp scheduler): in its turn a consumer issues S = Q.K^T of a
//   tile (Q and K from shared memory) and O += P.V of the tile before (P as
//   the register A operand, V read as staged (keys x d) under the transpose
//   bit), hands the turn over, waits for S alone and runs its online
//   softmax (f32 registers, the scale d^-1/2 log2(e) applied to S in f32,
//   exp2 on the MUFU unit) beside its own P.V and the other's products;
//   then it rounds P to bf16 and rescales O.  Each consumer writes its
//   normalised O into its half of the item's Q buffer, which its products
//   no longer read, and one TMA store takes it out while the next item
//   runs; the buffer goes back to the producer once the store has read it.
//   Tiles carry the swizzle that TMA writes and the wgmma descriptors name
//   (hopper.cuh).
// - float32, d <= 64: three TF32 passes of mma.sync (tf32_mma.cuh), f32-
//   accurate; least time 3x the work over the TF32 rate.  Blocks of 4 warps
//   take 64 query rows; Q's fragments, pre-scaled by d^-1/2 log2(e) and
//   split into hi and lo once, stay in registers; K and V tiles of 64 keys
//   are double-buffered by 16-byte cp.async and split by each warp as its
//   fragments are read.
// - float32, d = 128: the same three passes, on TF32 `wgmma`, each operand
//   split once.  A block of 256 threads takes 64 query rows: a splitter
//   warpgroup loads each K/V tile of 32 keys and splits it, once, into TF32
//   hi and lo planes in shared memory (V transposed: TF32 wgmma reads B
//   K-major), into a ring of 2 stages on mbarriers; the consumer warpgroup
//   splits Q once into planes that stay in shared memory (in registers they
//   would crowd out O) and runs S = Q.K^T from shared memory and P.V with
//   P's halves as register A operands, three passes each.
//
// Common to all three: with `causal` the heaviest query tiles launch
// first; key tiles that the causal mask or the window empties for the
// whole query tile are skipped, and masks are applied only on tiles that
// need them.  In both f32 routes the score fragment becomes P.V's A
// fragment without shuffles: A's column t stands for key 2t and column
// t + 4 for key 2t + 1, and V's rows are read in the same order; each
// tile's P.V is summed apart and added to O in f32 (tensor cores do not
// round their sums to nearest, and a running O fed through every tile's
// mma would gather that error beyond the f32 tolerance; bf16's tolerance
// leaves room, so that route accumulates O in the wgmma).
//
// For the backward (flash_attention_bwd.cu), each entry also writes the
// rows' log-sum-exp, f32 (b, h, sq) in natural units, when handed a
// non-null `lse`: (m + log2 l) ln 2 from the online softmax's max m and
// sum l in log2 units, and -1e30 for a row that saw no key.  Inference
// passes null, and the output is the same either way.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

struct Strides {
  long long b, h, s;
};

// What one block walks: query rows [q0, q0 + BM) of one head and batch
// row, and n_tiles key tiles of BN from k_begin.  A masked key inside
// them scores -1e30, which weighs 0 once a row has seen a valid key and
// weighs all keys equally in a row that sees none; a key past sk weighs 0.
// Rows whose band lies wholly past the last key (i - (sk - 1) >= window)
// see none; the last row of the tile is the first to do so, and then the
// tile walks every key, as the oracle's mean of V needs.
template <int BM, int BN>
struct Walk {
  int q0, head, row, kv_head, k_begin, n_tiles;

  // the block's own: heaviest query tiles first under `causal`
  __device__ Walk(int h, int kv, int sq, int sk, int causal, int window)
      : Walk(causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x, blockIdx.y,
             blockIdx.z, h, kv, sq, sk, causal, window) {}

  __device__ Walk(int tile, int head_, int row_, int h, int kv, int sq,
                  int sk, int causal, int window) {
    q0 = tile * BM;
    head = head_;
    row = row_;
    kv_head = head / (h / kv);
    const int q_last = min(q0 + BM, sq) - 1;
    k_begin = 0;
    int k_end = sk;
    if (causal) {
      k_end = min(sk, q_last + 1);
      if (window > 0) {
        if (q_last - (sk - 1) >= window)
          k_end = sk;
        else
          k_begin = max(0, q0 - window + 1);
      }
    }
    n_tiles = (k_end - k_begin + BN - 1) / BN;
  }
};

// Score s of key j for query i after the masks: -inf past the last key,
// -1e30 where the causal mask or the window hides it.
__device__ __forceinline__ float masked(float s, int i, int j, int sk,
                                        int causal, int window) {
  if (j >= sk) return -INFINITY;
  if (causal && (j > i || (window > 0 && i - j >= window))) return kNegInf;
  return s;
}

// Whether no (query, key) pair of rows [r, r + rows) and keys
// [kt, kt + keys) is masked.
__device__ __forceinline__ bool unmasked(int r, int rows, int kt, int keys,
                                         int sk, int causal, int window) {
  return kt + keys <= sk &&
         (!causal || (kt + keys - 1 <= r &&
                      (window <= 0 || r + rows - 1 - kt < window)));
}

// Row max of the online softmax over the four lanes that share a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A row's log-sum-exp in natural units from the online softmax's running
// max m and sum l (log2 units); -1e30 for a row that saw no key.
__device__ __forceinline__ float row_lse(float m, float l) {
  return m == kNegInf ? kNegInf : (m + log2f(l)) * kLn2;
}

// Thread t == 0 of each quad writes the log-sum-exp of its rows r0 and
// r1 (quad sums l0, l1) when `lse` is not null.
__device__ __forceinline__ void store_lse(float* lse, long long bh, int sq,
                                          int r0, int r1, float m0, float m1,
                                          float l0, float l1) {
  if (lse == nullptr || (threadIdx.x & 3) != 0) return;
  float* row = lse + bh * sq;
  if (r0 < sq) row[r0] = row_lse(m0, l0);
  if (r1 < sq) row[r1] = row_lse(m1, l1);
}

// ===================================================== float32, d <= 64
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // queries per block (16 per warp), keys per tile

// Shared-memory row length in floats: d plus a pad that keeps the rows
// 16-byte aligned and the fragment loads free of bank conflicts.
template <int D>
__host__ __device__ constexpr int row_len() {
  return D + 4;
}

// Two stages of K and V tiles.
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * 2 * (size_t)kTile * row_len<D>() * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out,
                           float* __restrict__ lse, Strides qs, Strides ks,
                           Strides vs, Strides os, int h, int kv, int sq,
                           int sk, int causal, int window, float q_scale) {
  constexpr int LD = row_len<D>();
  constexpr int KT = D / 8;      // k-steps of S = Q.K^T
  constexpr int NT = kTile / 8;  // key groups of 8
  constexpr int DT = D / 8;      // output column groups of 8
  const Walk<kTile, kTile> w(h, kv, sq, sk, causal, window);
  const int q0 = w.q0, k_begin = w.k_begin, n_tiles = w.n_tiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const float* q_bh = q + w.row * qs.b + w.head * qs.h;
  const float* k_bh = k + w.row * ks.b + w.kv_head * ks.h;
  const float* v_bh = v + w.row * vs.b + w.kv_head * vs.h;
  float* out_bh = out + w.row * os.b + w.head * os.h;

  // this thread's rows of the tile: r0 (c0, c1, a0, a2) and r1 = r0 + 8
  const int r0 = q0 + 16 * warp + g;
  const int r1 = r0 + 8;

  uint32_t qh[KT][4], ql[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int e = 8 * kk + t;
    tc::split(r0 < sq ? q_bh[r0 * qs.s + e] * q_scale : 0.f, qh[kk][0],
              ql[kk][0]);
    tc::split(r1 < sq ? q_bh[r1 * qs.s + e] * q_scale : 0.f, qh[kk][1],
              ql[kk][1]);
    tc::split(r0 < sq ? q_bh[r0 * qs.s + e + 4] * q_scale : 0.f, qh[kk][2],
              ql[kk][2]);
    tc::split(r1 < sq ? q_bh[r1 * qs.s + e + 4] * q_scale : 0.f, qh[kk][3],
              ql[kk][3]);
  }

  const bool k_vec = tc::aligned16(k_bh, ks.s);
  const bool v_vec = tc::aligned16(v_bh, vs.s);

  auto stage_kv = [&](int it) {
    const int kt = k_begin + it * kTile;
    const int rows = min(kTile, sk - kt);
    float* k_s = smem + (it & 1) * 2 * kTile * LD;
    tc::stage(k_s, LD, k_bh + kt * ks.s, ks.s, rows, kTile, D, D, k_vec);
    tc::stage(k_s + kTile * LD, LD, v_bh + kt * vs.s, vs.s, rows, kTile, D,
              D, v_vec);
    tc::cp_async_commit();
  };

  float o[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max (log2 units), rows r0, r1
  float l0 = 0.f, l1 = 0.f;          // this thread's part of the row sums

  stage_kv(0);
  for (int it = 0; it < n_tiles; ++it) {
    tc::cp_async_wait<0>();
    // tile `it` is in; every warp is done with the buffer tile it + 1 fills
    __syncthreads();
    if (it + 1 < n_tiles) stage_kv(it + 1);
    const float* k_s = smem + (it & 1) * 2 * kTile * LD;
    const float* v_s = k_s + kTile * LD;
    const int kt = k_begin + it * kTile;

    // S = Q.K^T (log2 units): B(e, key) = K[key][e]
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* k_row = k_s + (8 * nt + g) * LD + 8 * kk + t;
        uint32_t bh[2], bl[2];
        tc::split(k_row[0], bh[0], bl[0]);
        tc::split(k_row[4], bh[1], bl[1]);
        tc::mma3(s[nt], qh[kk], ql[kk], bh, bl);
      }
    }

    // masks, on tiles that need them: the ragged last tile, and tiles
    // that the causal mask or the window cut for some (row, key) pair
    if (!unmasked(q0, kTile, kt, kTile, sk, causal, window)) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = masked(s[nt][e], e < 2 ? r0 : r1,
                            kt + 8 * nt + 2 * t + (e & 1), sk, causal,
                            window);
    }

    // online softmax in registers; the four lanes of a row share its max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float alpha0 = exp2f(m0 - mx0);
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;

    // pv = P.V over the key groups.  P's C fragment holds keys 2t, 2t + 1
    // of rows r0, r1; as the A fragment, column t is key 2t and column
    // t + 4 key 2t + 1, so B's row t is V's row 2t and row t + 4 V's row
    // 2t + 1.
    float pv[DT][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ph[4], pl[4];
      tc::split(s[kk][0], ph[0], pl[0]);  // (r0, key 2t)
      tc::split(s[kk][2], ph[1], pl[1]);  // (r1, key 2t)
      tc::split(s[kk][1], ph[2], pl[2]);  // (r0, key 2t + 1)
      tc::split(s[kk][3], ph[3], pl[3]);  // (r1, key 2t + 1)
      const float* v_even = v_s + (8 * kk + 2 * t) * LD + g;
      const float* v_odd = v_even + LD;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        uint32_t bh[2], bl[2];
        tc::split(v_even[8 * dn], bh[0], bl[0]);
        tc::split(v_odd[8 * dn], bh[1], bl[1]);
        tc::mma3(pv[dn], ph, pl, bh, bl);
      }
    }
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      o[dn][0] = o[dn][0] * alpha0 + pv[dn][0];
      o[dn][1] = o[dn][1] * alpha0 + pv[dn][1];
      o[dn][2] = o[dn][2] * alpha1 + pv[dn][2];
      o[dn][3] = o[dn][3] * alpha1 + pv[dn][3];
    }
  }

  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(sum0, 1e-30f);
  const float inv1 = 1.f / fmaxf(sum1, 1e-30f);
  store_lse(lse, (long long)w.row * h + w.head, sq, r0, r1, m0, m1, sum0,
            sum1);
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = 8 * dn + 2 * t;
    if (r0 < sq)
      *reinterpret_cast<float2*>(out_bh + r0 * os.s + col) =
          make_float2(o[dn][0] * inv0, o[dn][1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<float2*>(out_bh + r1 * os.s + col) =
          make_float2(o[dn][2] * inv1, o[dn][3] * inv1);
  }
}

// ====================================================== float32, d = 128
namespace split_once {

constexpr int D = 128;
constexpr int kRows = 64;       // query rows a block: one consumer warpgroup
constexpr int kKeys = 32;       // keys a tile
constexpr int kStages = 2;
constexpr int kThreads = 256;   // splitter warpgroup, then the consumer

// TF32 planes in shared memory, K-major with the 128-byte swizzle, as
// wgmma reads TF32: a tile of R rows x D floats is D / 32 column blocks of
// R rows x 128 bytes.  Q's hi and lo planes (kRows rows), then per stage
// K's hi and lo planes (kKeys rows) and V's, transposed (D rows of kKeys
// keys), then the barriers full[kStages] and empty[kStages].
constexpr uint32_t kQPlane = kRows * D * 4;
constexpr uint32_t kKVPlane = kKeys * D * 4;
constexpr uint32_t kStage = 4 * kKVPlane;
constexpr uint32_t kBarriers = 2 * kQPlane + kStages * kStage;
constexpr size_t kSmem = kBarriers + 8 * 2 * kStages + 1024;

// Byte offset of element (r, c) in a K-major tile of `rows` rows.
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int c) {
  return (c >> 5) * rows * 128 + r * 128 +
         ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// Descriptor of the k-step of 8 TF32 columns from column `col`.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int rows,
                                            int col) {
  return hop::descriptor(tile + (col >> 5) * rows * 128 + (col & 31) * 4, 16,
                         1024, 1);
}

// P's A fragment holds keys 2t and 2t + 1 of a key group of 8 as its
// columns t and t + 4, so V's transposed plane keeps key j of each group
// at column (j odd: 4 + j / 2; j even: j / 2).
__device__ __forceinline__ int key_column(int j) {
  return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);
}

__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

// The TF32 halves of x: hi + lo = x to ~2^-22.
__device__ __forceinline__ void split4(float4 x, uint4& hi, uint4& lo) {
  tc::split(x.x, hi.x, lo.x);
  tc::split(x.y, hi.y, lo.y);
  tc::split(x.z, hi.z, lo.z);
  tc::split(x.w, hi.w, lo.w);
}

__device__ __forceinline__ void store(uint32_t addr, uint4 x) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}
__device__ __forceinline__ void store(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(x) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel_tf32_wgmma(const float* __restrict__ q,
                                      const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      float* __restrict__ out,
                                      float* __restrict__ lse, Strides qs,
                                      Strides ks, Strides vs, Strides os,
                                      int h, int kv, int sq, int sk,
                                      int causal, int window, float q_scale) {
  const Walk<kRows, kKeys> w(h, kv, sq, sk, causal, window);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (hop::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_hi = base, q_lo = base + kQPlane;
  auto k_hi = [&](int stage) { return base + 2 * kQPlane + stage * kStage; };
  auto full = [&](int stage) { return base + kBarriers + 8 * stage; };
  auto empty = [&](int stage) {
    return base + kBarriers + 8 * (kStages + stage);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      hop::mbar_init(full(i), 128);
      hop::mbar_init(empty(i), 128);
    }
  }
  __syncthreads();
  const int tid = threadIdx.x % 128;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (threadIdx.x < 128) {
    // ---- splitter: each K/V tile into its TF32 planes, once
    const float* k_bh = k + w.row * ks.b + w.kv_head * ks.h;
    const float* v_bh = v + w.row * vs.b + w.kv_head * vs.h;
    const bool k_vec = tc::aligned16(k_bh, ks.s);
    const bool v_vec = tc::aligned16(v_bh, vs.s);
    for (int it = 0; it < w.n_tiles; ++it) {
      const int stage = it % kStages;
      const int kt = w.k_begin + it * kKeys;
      // K rows warp + 4i, 16-byte column chunk `lane`; V key `lane`,
      // columns 4 (warp + 4i) onwards (kept in registers while the stage
      // drains)
      float4 kx[kKeys / 4], vx[kKeys / 4];
#pragma unroll
      for (int i = 0; i < kKeys / 4; ++i) {
        const int r = warp + 4 * i;
        kx[i] = kt + r < sk ? load4(k_bh + (kt + r) * ks.s + 4 * lane, k_vec)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        vx[i] = kt + lane < sk
                    ? load4(v_bh + (kt + lane) * vs.s + 4 * (warp + 4 * i),
                            v_vec)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (it >= kStages)
        hop::mbar_wait(empty(stage), ((it / kStages) - 1) & 1);
      const uint32_t kh = k_hi(stage), kl = kh + kKVPlane;
      const uint32_t vh = kl + kKVPlane, vl = vh + kKVPlane;
      const int col = key_column(lane);
#pragma unroll
      for (int i = 0; i < kKeys / 4; ++i) {
        uint4 hi, lo;
        const int r = warp + 4 * i;
        split4(kx[i], hi, lo);
        store(kh + swizzled(kKeys, r, 4 * lane), hi);
        store(kl + swizzled(kKeys, r, 4 * lane), lo);
        split4(vx[i], hi, lo);
        const int d0 = 4 * (warp + 4 * i);
        store(vh + swizzled(D, d0, col), hi.x);
        store(vh + swizzled(D, d0 + 1, col), hi.y);
        store(vh + swizzled(D, d0 + 2, col), hi.z);
        store(vh + swizzled(D, d0 + 3, col), hi.w);
        store(vl + swizzled(D, d0, col), lo.x);
        store(vl + swizzled(D, d0 + 1, col), lo.y);
        store(vl + swizzled(D, d0 + 2, col), lo.z);
        store(vl + swizzled(D, d0 + 3, col), lo.w);
      }
      hop::fence_proxy_async();
      hop::mbar_arrive(full(stage));
    }
  } else {
    // ---- consumer: 64 query rows, three TF32 passes on wgmma
    const int g = lane >> 2;
    const int t = lane & 3;
    const int q0 = w.q0;
    const int r0 = q0 + 16 * warp + g;
    const int r1 = r0 + 8;
    {  // Q, pre-scaled by d^-1/2 log2(e), split once; rows past sq zeros
      const float* q_bh = q + w.row * qs.b + w.head * qs.h;
      const bool q_vec = tc::aligned16(q_bh, qs.s);
#pragma unroll 4
      for (int i = 0; i < kRows / 4; ++i) {
        const int r = warp + 4 * i;
        float4 x = q0 + r < sq ? load4(q_bh + (q0 + r) * qs.s + 4 * lane,
                                       q_vec)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        x.x *= q_scale;
        x.y *= q_scale;
        x.z *= q_scale;
        x.w *= q_scale;
        uint4 hi, lo;
        split4(x, hi, lo);
        store(q_hi + swizzled(kRows, r, 4 * lane), hi);
        store(q_lo + swizzled(kRows, r, 4 * lane), lo);
      }
      hop::fence_proxy_async();
      hop::bar_sync(1, 128);
    }

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;
    float l0 = 0.f, l1 = 0.f;
    for (int it = 0; it < w.n_tiles; ++it) {
      const int stage = it % kStages;
      hop::mbar_wait(full(stage), (it / kStages) & 1);
      const int kt = w.k_begin + it * kKeys;
      const uint32_t kh = k_hi(stage), kl = kh + kKVPlane;
      const uint32_t vh = kl + kKVPlane, vl = vh + kKVPlane;

      // S = Q.K^T (log2 units): lo.hi + hi.lo + hi.hi each k-step
      float s[kKeys / 2];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const uint64_t ah = k_major(q_hi, kRows, 8 * kk);
        const uint64_t al = k_major(q_lo, kRows, 8 * kk);
        const uint64_t bh = k_major(kh, kKeys, 8 * kk);
        const uint64_t bl = k_major(kl, kKeys, 8 * kk);
        hop::wgmma_ss_m64n32k8_tf32(s, al, bh, kk > 0);
        hop::wgmma_ss_m64n32k8_tf32(s, ah, bl, 1);
        hop::wgmma_ss_m64n32k8_tf32(s, ah, bh, 1);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_registers(s);

      if (!unmasked(q0, kRows, kt, kKeys, sk, causal, window)) {
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i)
          s[i] = masked(s[i], (i & 2) ? r1 : r0,
                        kt + 8 * (i >> 2) + 2 * t + (i & 1), sk, causal,
                        window);
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float alpha0 = exp2f(m0 - mx0);
      const float alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        s[4 * j] = exp2f(s[4 * j] - m0);
        s[4 * j + 1] = exp2f(s[4 * j + 1] - m0);
        s[4 * j + 2] = exp2f(s[4 * j + 2] - m1);
        s[4 * j + 3] = exp2f(s[4 * j + 3] - m1);
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;

      // pv = P.V, summed apart from O: P's halves as register A fragments
      // (column t is key 2t, column t + 4 key 2t + 1), V^T's as B
      uint32_t ph[kKeys / 8][4], pl[kKeys / 8][4];
#pragma unroll
      for (int kk = 0; kk < kKeys / 8; ++kk) {
        tc::split(s[4 * kk], ph[kk][0], pl[kk][0]);      // (r0, key 2t)
        tc::split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);  // (r1, key 2t)
        tc::split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);  // (r0, key 2t + 1)
        tc::split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);  // (r1, key 2t + 1)
      }
      float pv[D / 2];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 8; ++kk) {
        const uint64_t bh = k_major(vh, D, 8 * kk);
        const uint64_t bl = k_major(vl, D, 8 * kk);
        hop::wgmma_rs_m64n128k8_tf32(pv, pl[kk], bh, kk > 0);
        hop::wgmma_rs_m64n128k8_tf32(pv, ph[kk], bl, 1);
        hop::wgmma_rs_m64n128k8_tf32(pv, ph[kk], bh, 1);
      }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_registers(pv);
      hop::mbar_arrive(empty(stage));
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        o[i] = o[i] * alpha0 + pv[i];
        o[i + 1] = o[i + 1] * alpha0 + pv[i + 1];
        o[i + 2] = o[i + 2] * alpha1 + pv[i + 2];
        o[i + 3] = o[i + 3] * alpha1 + pv[i + 3];
      }
    }

    const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
    const float inv0 = 1.f / fmaxf(sum0, 1e-30f);
    const float inv1 = 1.f / fmaxf(sum1, 1e-30f);
    store_lse(lse, (long long)w.row * h + w.head, sq, r0, r1, m0, m1, sum0,
              sum1);
    float* out_bh = out + w.row * os.b + w.head * os.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (r0 < sq)
        *reinterpret_cast<float2*>(out_bh + r0 * os.s + col) =
            make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < sq)
        *reinterpret_cast<float2*>(out_bh + r1 * os.s + col) =
            make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

static_assert(kSmem <= kMaxSmem, "flash_attention (d 128): shared memory");

}  // namespace split_once

// ============================================ bfloat16: wgmma and TMA
namespace wg {

constexpr int kM = 128;         // query rows a work item: two consumers of 64
constexpr int kN = 128;         // keys a tile
constexpr int kThreads = 384;   // producer warpgroup, then two consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// named barriers: consumer c may issue its products once bar kTurn + c has
// completed; each consumer's own 128 threads meet at kStore + c
constexpr int kTurn = 1;
constexpr int kStore = 3;

// Bytes of one swizzle atom's row (32, 64 or 128) and the bf16 columns it
// holds; a tile is D / atom_cols column blocks of R rows x atom_bytes.
template <int D>
__host__ __device__ constexpr int atom_bytes() {
  return D >= 64 ? 128 : 2 * D;
}
template <int D>
__host__ __device__ constexpr int atom_cols() {
  return atom_bytes<D>() / 2;
}
// the descriptors' swizzle code: 1 = 128 B, 2 = 64 B, 3 = 32 B
template <int D>
__host__ __device__ constexpr int layout() {
  return atom_bytes<D>() == 128 ? 1 : atom_bytes<D>() == 64 ? 2 : 3;
}
template <int D>
__host__ __device__ constexpr int stages() {
  return D == 128 ? 2 : 3;
}
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) {
  return (uint32_t)rows * D * 2;
}
// Two Q buffers (a work item's Q, then its O on the way out), the K ring,
// the V ring (all 1024-byte aligned: the 128-byte swizzle repeats every 8
// rows of 128 bytes), then the barriers: q_full[2], q_empty[2],
// k_full[S], k_empty[S], v_full[S], v_empty[S].
template <int D>
__host__ __device__ constexpr uint32_t k_offset(int stage) {
  return 2 * tile_bytes<D>(kM) + stage * tile_bytes<D>(kN);
}
template <int D>
__host__ __device__ constexpr uint32_t v_offset(int stage) {
  return k_offset<D>(stages<D>()) + stage * tile_bytes<D>(kN);
}
template <int D>
__host__ __device__ constexpr uint32_t barrier_offset() {
  return v_offset<D>(stages<D>());
}
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // + the barriers, + 1024 to align the base
  return barrier_offset<D>() + 8 * (4 + 4 * stages<D>()) + 1024;
}

// K-major descriptor (Q or K: d contiguous) of the k-step of 16 columns
// from column `col`, rows from `row0` of a tile of `rows` rows.
template <int D>
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int rows,
                                            int row0, int col) {
  constexpr int AB = atom_bytes<D>();
  const uint32_t addr = tile + (col / atom_cols<D>()) * rows * AB +
                        row0 * AB + (col % atom_cols<D>()) * 2;
  return hop::descriptor(addr, 16, 8 * AB, layout<D>());
}

// MN-major descriptor (V as staged: keys x d, d contiguous) of the k-step
// of 16 keys from key `key`: column blocks kN rows apart, 8-key groups 8
// rows apart.
template <int D>
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int key) {
  constexpr int AB = atom_bytes<D>();
  return hop::descriptor(tile + key * AB, kN * AB, 8 * AB, layout<D>());
}

// A tile of `rows` rows from (position, head, batch row) into `dst`, one
// box per column block.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const void* map,
                                          uint32_t bar, int rows, int pos,
                                          int head, int row) {
#pragma unroll
  for (int a = 0; a < D / atom_cols<D>(); ++a)
    hop::tma_load_4d(dst + a * rows * atom_bytes<D>(), map, bar,
                     a * atom_cols<D>(), pos, head, row);
}

// The byte offset, in a tile of kM rows as TMA writes it, of row r and
// column `col`: column block, row, then the swizzle (the 16-byte chunk
// XOR the row's place in its 8-row period; base 1024-aligned).
template <int D>
__device__ __forceinline__ uint32_t swizzled(int r, int col) {
  constexpr int AB = atom_bytes<D>();
  constexpr uint32_t mask = AB / 16 - 1;
  const uint32_t lin = (col / atom_cols<D>()) * kM * AB + r * AB +
                       (col % atom_cols<D>()) * 2;
  return lin ^ (((lin >> 7) & mask) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x by the MUFU unit alone: exp2f without fast math also scales its
// argument and result to keep results below 2^-126; those weigh nothing
// beside a row's largest weight, 1, so they are flushed to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The work item of round k of block `block` of `blocks`: rounds go left to
// right and right to left in turn, so the heavy items of the early rounds
// and the light ones of the late rounds even out across blocks.
__device__ __forceinline__ int item_of_round(int k, int block, int blocks) {
  return k * blocks + ((k & 1) ? blocks - 1 - block : block);
}

// A work item: 128 query rows of one head and batch row.  Items are
// numbered query tile outermost (under `causal` the heaviest first), then
// batch row, then head, so the query heads that share a KV head are
// neighbours and read its tiles from L2.
__device__ __forceinline__ Walk<kM, kN> item(int w, int n_q, int h, int b,
                                             int kv, int sq, int sk,
                                             int causal, int window) {
  const int qi = w / (h * b);
  const int rest = w - qi * (h * b);
  return Walk<kM, kN>(causal ? n_q - 1 - qi : qi, rest % h, rest / h, h, kv,
                      sq, sk, causal, window);
}

// One block an SM walks one work item a round (item_of_round).  A
// producer warpgroup, of which one thread issues every TMA load: each
// item's Q into the item's buffer (two, alternating), and its K and V tiles
// into their rings, running ahead across items.  Two consumer warpgroups
// of 64 query rows each take turns at the tensor cores (FlashAttention-3's
// ping-pong, on named barriers): in its turn a consumer issues S = Q.K^T
// of a tile and P.V of the one before, hands the turn over, and runs the
// online softmax while its P.V and the other's products run.  The
// output goes to the consumer's half of the item's Q buffer (which its
// products no longer read) and out by one TMA store, which overlaps the
// next item; the buffer is handed back once the store has read it.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel_bf16_wgmma(
        const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        const __grid_constant__ CUtensorMap o_map, float* __restrict__ lse,
        int b, int h, int kv, int sq, int sk, int causal, int window,
        float scale_log2) {
  constexpr int S = stages<D>();
  const int n_q = (sq + kM - 1) / kM;
  const int n_items = n_q * h * b;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (hop::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + barrier_offset<D>();
  auto q_s = [&](int qb) { return base + qb * tile_bytes<D>(kM); };
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (2 + qb); };
  auto k_full = [&](int st) { return bars + 8 * (4 + st); };
  auto k_empty = [&](int st) { return bars + 8 * (4 + S + st); };
  auto v_full = [&](int st) { return bars + 8 * (4 + 2 * S + st); };
  auto v_empty = [&](int st) { return bars + 8 * (4 + 3 * S + st); };
  auto k_s = [&](int st) { return base + k_offset<D>(st); };
  auto v_s = [&](int st) { return base + v_offset<D>(st); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hop::mbar_init(q_full(i), 1);
      hop::mbar_init(q_empty(i), 2);
    }
    for (int i = 0; i < S; ++i) {
      hop::mbar_init(k_full(i), 1);
      hop::mbar_init(k_empty(i), 2 * 128);
      hop::mbar_init(v_full(i), 1);
      hop::mbar_init(v_empty(i), 2 * 128);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the buffers and rings full
    hop::release_registers<kProducerRegs>();
    if (threadIdx.x == 0) {
      int n = 0;  // K/V tiles issued, over every item
      for (int k = 0;; ++k) {
        const int w = item_of_round(k, blockIdx.x, gridDim.x);
        if (w >= n_items) break;
        const Walk<kM, kN> it =
            item(w, n_q, h, b, kv, sq, sk, causal, window);
        const int qb = k & 1;
        if (k >= 2) hop::mbar_wait(q_empty(qb), ((k >> 1) - 1) & 1);
        hop::mbar_arrive_expect_tx(q_full(qb), tile_bytes<D>(kM));
        load_tile<D>(q_s(qb), &q_map, q_full(qb), kM, it.q0, it.head,
                     it.row);
        for (int i = 0; i < it.n_tiles; ++i, ++n) {
          const int st = n % S;
          const int kt = it.k_begin + i * kN;
          if (n >= S) hop::mbar_wait(k_empty(st), ((n / S) - 1) & 1);
          hop::mbar_arrive_expect_tx(k_full(st), tile_bytes<D>(kN));
          load_tile<D>(k_s(st), &k_map, k_full(st), kN, kt, it.kv_head,
                       it.row);
          if (n >= S) hop::mbar_wait(v_empty(st), ((n / S) - 1) & 1);
          hop::mbar_arrive_expect_tx(v_full(st), tile_bytes<D>(kN));
          load_tile<D>(v_s(st), &v_map, v_full(st), kN, kt, it.kv_head,
                       it.row);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    hop::claim_registers<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int g = (tid & 31) >> 2;
    const int t = tid & 3;
    const int my_turn = kTurn + c, other_turn = kTurn + 1 - c;
    if (c == 1) hop::bar_arrive(kTurn, 256);  // consumer 0 goes first

    int n = 0;              // K/V tiles consumed before this item
    int stored = -1;        // the Q buffer whose O store is in flight
    for (int k = 0;; ++k) {
      const int w = item_of_round(k, blockIdx.x, gridDim.x);
      if (w >= n_items) break;
      const Walk<kM, kN> it =
          item(w, n_q, h, b, kv, sq, sk, causal, window);
      const bool last_item =
          item_of_round(k + 1, blockIdx.x, gridDim.x) >= n_items;
      const int qb = k & 1;
      const int rows0 = it.q0 + 64 * c;  // this warpgroup's first row
      const int r0 = rows0 + 16 * (tid >> 5) + g;
      const int r1 = r0 + 8;

      float o[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      float m0 = kNegInf, m1 = kNegInf;  // running max (log2 units)
      float l0 = 0.f, l1 = 0.f;          // this thread's part of the sums
      float s[kN / 2];
      uint32_t p[kN / 16][4];            // the last tile's P, bf16
      float a0 = 1.f, a1 = 1.f;          // the last tile's rescale of O

      // A turn: wait for this consumer's turn, issue its products (each
      // turn's sequence is fixed, so no wgmma sits on a divergent path),
      // let the other consumer issue.  A middle turn issues S of its tile
      // first and P.V of the last tile after it, and waits for S alone
      // before the softmax, which runs beside its own P.V as well as the
      // other consumer's products (FlashAttention-3's order); O is
      // rescaled and P rounded once P.V is done.
      auto turn_begin = [&]() {
        hop::bar_sync(my_turn, 256);
        hop::fence_registers(o);
        hop::wgmma_fence();
      };
      auto turn_end = [&](bool grant) {
        hop::wgmma_commit();
        if (grant) hop::bar_arrive(other_turn, 256);
        hop::wgmma_wait<0>();
        hop::fence_registers(s);
        hop::fence_registers(o);
      };
      auto issue_s = [&](int st) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hop::wgmma_ss_m64n128k16(s, k_major<D>(q_s(qb), kM, 64 * c, 16 * kk),
                                   k_major<D>(k_s(st), kN, 0, 16 * kk),
                                   kk > 0);
      };
      auto issue_pv = [&](int st) {
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk)
          hop::wgmma_rs<D>(o, p[kk], mn_major<D>(v_s(st), 16 * kk), 1);
      };
      // the online softmax of tile i: its weights in s (f32), m, l and the
      // rescale factors for O
      auto softmax = [&](int i) {
        const int kt = it.k_begin + i * kN;
        float mx0 = m0, mx1 = m1;
        if (unmasked(rows0, 64, kt, kN, sk, causal, window)) {
          // no mask on the tile: the row max of the raw scores, scaled
          // once; each weight is 2^(s scale - m) by one fused multiply-add
          float r0x = -INFINITY, r1x = -INFINITY;
#pragma unroll
          for (int j = 0; j < kN / 8; ++j) {
            r0x = fmaxf(r0x, fmaxf(s[4 * j], s[4 * j + 1]));
            r1x = fmaxf(r1x, fmaxf(s[4 * j + 2], s[4 * j + 3]));
          }
          mx0 = fmaxf(mx0, quad_max(r0x) * scale_log2);
          mx1 = fmaxf(mx1, quad_max(r1x) * scale_log2);
#pragma unroll
          for (int j = 0; j < kN / 8; ++j) {
            s[4 * j] = fmaf(s[4 * j], scale_log2, -mx0);
            s[4 * j + 1] = fmaf(s[4 * j + 1], scale_log2, -mx0);
            s[4 * j + 2] = fmaf(s[4 * j + 2], scale_log2, -mx1);
            s[4 * j + 3] = fmaf(s[4 * j + 3], scale_log2, -mx1);
          }
        } else {
          // scale in f32, then the masks
#pragma unroll
          for (int j = 0; j < kN / 2; ++j)
            s[j] = masked(s[j] * scale_log2, (j & 2) ? r1 : r0,
                          kt + 8 * (j >> 2) + 2 * t + (j & 1), sk, causal,
                          window);
#pragma unroll
          for (int j = 0; j < kN / 8; ++j) {
            mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
            mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
          }
          mx0 = quad_max(mx0);
          mx1 = quad_max(mx1);
#pragma unroll
          for (int j = 0; j < kN / 8; ++j) {
            s[4 * j] -= mx0;
            s[4 * j + 1] -= mx0;
            s[4 * j + 2] -= mx1;
            s[4 * j + 3] -= mx1;
          }
        }
        const float alpha0 = ex2(m0 - mx0);
        const float alpha1 = ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          s[4 * j] = ex2(s[4 * j]);
          s[4 * j + 1] = ex2(s[4 * j + 1]);
          s[4 * j + 2] = ex2(s[4 * j + 2]);
          s[4 * j + 3] = ex2(s[4 * j + 3]);
          sum0 += s[4 * j] + s[4 * j + 1];
          sum1 += s[4 * j + 2] + s[4 * j + 3];
        }
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
        a0 = alpha0;
        a1 = alpha1;
      };
      // P in bf16 for the next turn's P.V, and O rescaled, once the last
      // P.V is done
      auto to_p = [&]() {
        const float alpha0 = a0, alpha1 = a1;
#pragma unroll
        for (int kk = 0; kk < kN / 16; ++kk) {
          p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
          p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
          p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
          p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
#pragma unroll
        for (int j = 0; j < D / 2; j += 4) {
          o[j] *= alpha0;
          o[j + 1] *= alpha0;
          o[j + 2] *= alpha1;
          o[j + 3] *= alpha1;
        }
      };

      hop::mbar_wait(q_full(qb), (k >> 1) & 1);
      // turn 0: S of tile 0
      hop::mbar_wait(k_full(n % S), (n / S) & 1);
      turn_begin();
      issue_s(n % S);
      turn_end(true);
      if (stored >= 0 && tid == 0) {
        // the last item's O has left its Q buffer: hand it back
        hop::bulk_wait_read<0>();
        hop::mbar_arrive(q_empty(stored));
      }
      hop::mbar_arrive(k_empty(n % S));
      softmax(0);
      to_p();
      // turn i: S of tile i, then P.V of tile i - 1
      for (int i = 1; i < it.n_tiles; ++i) {
        const int st = (n + i) % S, pst = (n + i - 1) % S;
        hop::mbar_wait(k_full(st), ((n + i) / S) & 1);
        hop::mbar_wait(v_full(pst), ((n + i - 1) / S) & 1);
        turn_begin();
        issue_s(st);
        hop::wgmma_commit();
        issue_pv(pst);
        hop::wgmma_commit();
        hop::bar_arrive(other_turn, 256);
        hop::wgmma_wait<1>();
        hop::fence_registers(s);
        hop::mbar_arrive(k_empty(st));
        softmax(i);
        hop::wgmma_wait<0>();
        hop::fence_registers(o);
        hop::mbar_arrive(v_empty(pst));
        to_p();
      }
      // the last turn: P.V of the last tile; consumer 1's very last turn
      // has no turn of consumer 0 after it to grant
      {
        const int pst = (n + it.n_tiles - 1) % S;
        hop::mbar_wait(v_full(pst), ((n + it.n_tiles - 1) / S) & 1);
        turn_begin();
        issue_pv(pst);
        turn_end(!(c == 1 && last_item));
        hop::mbar_arrive(v_empty(pst));
      }
      n += it.n_tiles;

      // ---- epilogue: O into this consumer's half of the Q buffer, then
      // out by TMA (rows past sq are not written)
      const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
      const float inv0 = 1.f / fmaxf(sum0, 1e-30f);
      const float inv1 = 1.f / fmaxf(sum1, 1e-30f);
      store_lse(lse, (long long)it.row * h + it.head, sq, r0, r1, m0, m1,
                sum0, sum1);
      unsigned char* q_gen =
          smem_raw + (q_s(qb) - hop::smem_addr(smem_raw));
      const int rr0 = 64 * c + 16 * (tid >> 5) + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(q_gen + swizzled<D>(rr0, col)) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(q_gen + swizzled<D>(rr0 + 8, col)) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      hop::fence_proxy_async();
      hop::bar_sync(kStore + c, 128);
      if (tid == 0) {
        if (rows0 < sq) {
#pragma unroll
          for (int a = 0; a < D / atom_cols<D>(); ++a)
            hop::tma_store_4d(&o_map,
                              q_s(qb) + a * kM * atom_bytes<D>() +
                                  64 * c * atom_bytes<D>(),
                              a * atom_cols<D>(), rows0, it.head, it.row);
        }
        hop::bulk_commit();
      }
      stored = qb;
    }
    if (stored >= 0 && tid == 0) hop::bulk_wait_read<0>();
  }
}

// cuTensorMapEncodeTiled, a driver-API call, through the runtime's entry
// point lookup (the library links no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (d, position, head, batch row) of a bf16 tensor given by
// its element strides, boxes of one column block x `rows` rows.  A
// dimension of extent 1 is never stepped; its stride is set to a
// contiguous one, which TMA takes whatever the view's was.
template <int D>
bool tensor_map(CUtensorMap* map, const void* base, Strides st, int s,
                int heads, int b, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)s,
                              (cuuint64_t)heads, (cuuint64_t)b};
  long long el[3] = {st.s, st.h, st.b};
  long long contiguous = D;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) el[i] = contiguous;
    contiguous = el[i] * (long long)dims[i + 1];
  }
  const cuuint64_t strides[3] = {(cuuint64_t)el[0] * 2, (cuuint64_t)el[1] * 2,
                                 (cuuint64_t)el[2] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)atom_cols<D>(), (cuuint32_t)rows, 1,
                             1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      atom_bytes<D>() == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : atom_bytes<D>() == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The card's SM count, once a device.
int sm_count() {
  static int counts[64] = {0};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64)
    return 0;
  if (counts[device] == 0)
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount,
                           device);
  return counts[device];
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, const Strides* strides, int b, int h, int kv,
                   int sq, int sk, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= kMaxSmem, "flash_attention (bf16): shared memory");
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!tensor_map<D>(&q_map, q, strides[0], sq, h, b, kM) ||
      !tensor_map<D>(&k_map, k, strides[1], sk, kv, b, kN) ||
      !tensor_map<D>(&v_map, v, strides[2], sk, kv, b, kN) ||
      !tensor_map<D>(&o_map, out, strides[3], sq, h, b, kM / 2))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel_bf16_wgmma<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)((sq + kM - 1) / kM) * h * b;
  const int sms = sm_count();
  if (sms <= 0 || items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  kernel<<<grid, kThreads, smem, stream>>>(q_map, k_map, v_map, o_map, lse, b,
                                           h, kv, sq, sk, causal, window,
                                           scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------- launches
template <typename Kernel>
cudaError_t launch_f32(Kernel kernel, size_t smem, int rows, int threads,
                       const void* q,
                       const void* k, const void* v, void* out, float* lse,
                       const Strides* strides, int b, int h, int kv, int sq,
                       int sk, int causal, int window, float scale,
                       cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + rows - 1) / rows, h, b);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse,
      strides[0], strides[1], strides[2], strides[3], h, kv, sq, sk, causal,
      window, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        void* out, float* lse, const Strides* strides, int b,
                        int h, int kv, int sq, int sk, int causal, int window,
                        float scale, cudaStream_t stream) {
  static_assert(smem_bytes<D>() <= kMaxSmem, "flash_attention: smem");
  return launch_f32(flash_attention_kernel<D>, smem_bytes<D>(), kTile,
                    kThreads, q, k, v, out, lse, strides, b, h, kv, sq, sk,
                    causal, window, scale, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, position) for q, k, v and
// out in turn; the last dimension of each is contiguous.  lse: null, or
// (b, h, sq) f32 for the rows' log-sum-exp (the backward's).  dtype: 0 =
// float32, 1 = bfloat16; window <= 0 means none.  Routes by dtype and head
// dim alone: bfloat16 to wgmma and TMA (whose bases and strides the caller
// has checked to be 16-byte aligned), float32 to three TF32 passes (d 128
// split once).  Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse_ptr,
                                     const long long* strides, int b, int h,
                                     int kv, int sq, int sk, int d,
                                     int causal, int window, int dtype,
                                     float scale, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kv < 1 || h % kv != 0 ||
      sq < 1 || sk < 1)
    return cudaErrorInvalidValue;
  Strides s[4];
  for (int i = 0; i < 4; ++i)
    s[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_ptr);
  if (dtype == 0) {
    switch (d) {
      case 16:
        return launch_tf32<16>(q, k, v, out, lse, s, b, h, kv, sq, sk,
                               causal, window, scale, st);
      case 32:
        return launch_tf32<32>(q, k, v, out, lse, s, b, h, kv, sq, sk,
                               causal, window, scale, st);
      case 64:
        return launch_tf32<64>(q, k, v, out, lse, s, b, h, kv, sq, sk,
                               causal, window, scale, st);
      case 128:
        return launch_f32(split_once::flash_attention_kernel_tf32_wgmma,
                          split_once::kSmem, split_once::kRows,
                          split_once::kThreads, q, k, v, out, lse, s, b, h,
                          kv, sq, sk, causal, window, scale, st);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 16:
        return wg::launch<16>(q, k, v, out, lse, s, b, h, kv, sq, sk,
                              causal, window, scale, st);
      case 32:
        return wg::launch<32>(q, k, v, out, lse, s, b, h, kv, sq, sk,
                              causal, window, scale, st);
      case 64:
        return wg::launch<64>(q, k, v, out, lse, s, b, h, kv, sq, sk,
                              causal, window, scale, st);
      case 128:
        return wg::launch<128>(q, k, v, out, lse, s, b, h, kv, sq, sk,
                               causal, window, scale, st);
    }
  }
  return cudaErrorInvalidValue;
}

// The dynamic shared memory a launch of this dtype and head dim takes, in
// bytes (ptxas reports static shared memory only); -1 if none is built.
extern "C" int repro_flash_smem_bytes(int dtype, int d) {
  if (dtype == 0) {
    switch (d) {
      case 16: return (int)smem_bytes<16>();
      case 32: return (int)smem_bytes<32>();
      case 64: return (int)smem_bytes<64>();
      case 128: return (int)split_once::kSmem;
    }
  } else if (dtype == 1) {
    switch (d) {
      case 16: return (int)wg::smem_bytes<16>();
      case 32: return (int)wg::smem_bytes<32>();
      case 64: return (int)wg::smem_bytes<64>();
      case 128: return (int)wg::smem_bytes<128>();
    }
  }
  return -1;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
