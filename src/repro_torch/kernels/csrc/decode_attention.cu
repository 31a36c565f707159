// Single-token decode attention (split-KV flash-decoding) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `decode_attention` in
// src/repro/kernels/decode_attention.py.  Computes, for every batch row and
// query head,
//
//     out = softmax(q . k^T * d^-1/2, keys at or past lengths[row] masked) . v
//
// with f32 accumulators, the finite mask value -1e30 and the denominator
// floored at 1e-30, output in q's dtype.  A row with no valid key weighs
// all s keys equally (the mean of V), as the reference does.
//
// Layouts: q (b, h, d); k, v (b, s, kv, d) with kv dividing h (GQA: query
// head i reads KV head i / (h / kv), so K/V are never repeated in memory);
// lengths (b,) int32; out (b, h, d).  All contiguous.
//
// Dtypes (q, K/V): (f32, f32), (bf16, bf16), and (f32, bf16), a bf16
// decode cache under f32 params.  K/V are read and staged in their own
// dtype and widened to f32 as each staged element is read, so a bf16 cache
// costs half the bytes of an f32 one and is never copied; q is widened
// once into shared memory, and `out` takes q's dtype.
//
// What bounds it: bytes.  Each K/V element feeds at most h/kv (here <= 8 a
// block) multiply-adds, far below the ~20 f32 operations per byte the card
// needs before compute is the limit, so the least time is the K and V rows
// each row attends to, read once, over the memory rate.  The products stay
// on CUDA cores: tensor cores would not move a bound set by bytes.
//
// The design keeps enough bytes in flight to reach the memory rate, at any
// batch and cache length:
//
// 1. A split plan (`plan_splits` in ../decode_attention.py, from the shapes
//    alone, never from `lengths`, so the serving path gains no sync) cuts
//    the cache axis into `splits` ranges of whole key tiles, so that
//    splits x kv x b blocks fill the card several times over.
// 2. `decode_split_kernel`: one block of 4 warps per (split, KV head, group
//    of up to 8 query heads, row).  It streams its key range in tiles of
//    kTileElems elements, K and V staged in their own dtype by 16-byte
//    `cp.async`, double-buffered: one barrier per tile, and the next tile's
//    copy overlaps this tile's work (the first tile's copy also overlaps
//    the read of `lengths`).  Each warp takes a quarter of the tile and
//    keeps its own online softmax in log2 units (one exp2f a weight).  A
//    lane computes whole dot products for its (head, key) pairs, with no
//    shuffle per pair; a head's keys sit in an aligned group of lanes (its
//    key count rounded up to a power of two), so its maximum and sum take
//    a few xor shuffles, every head of the warp at once.  Lanes hold the
//    accumulators as float4 slots of (head, channel).  At the end the four warps merge through shared memory.  A
//    range no longer than one warp's share of a tile (the serving shapes)
//    goes to warp 0 alone, which writes the result itself, with no merge.
//    A range that starts past its row's valid prefix writes an empty
//    partial (m = -1e30, l = 0, acc = 0) and exits.  With one split the
//    block writes `out` itself, so a call is one launch.
// 3. `decode_combine_kernel`, only when splits > 1: one warp per (row,
//    query head) merges the partials, m* = max m_i and
//    out = sum 2^(m_i - m*) acc_i / max(sum 2^(m_i - m*) l_i, 1e-30);
//    an empty split weighs exactly 0.
//
// The partials (splits, b, h) x {m, l} and (splits, b, h, d) come from
// `torch.empty` in the wrapper, so a CUDA graph captures a call whole.
// q is held in shared memory as f32: every lane of a warp reads the same
// element (a broadcast), and at d = 256 it would not fit in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupMax = 8;  // query heads per block
// Elements of one K (and one V) tile: kTileElems / D keys per tile.
constexpr int kTileElems = 4096;
constexpr int kStages = 2;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements from shared memory, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// q (f32, shared memory) . k (a staged row, in its own dtype), D terms:
// eight 16-byte reads of each in flight before their products, and four
// sums, so the reads and the adds do not wait on each other in turn.
template <int D, typename T>
__device__ __forceinline__ float dot_row(const float* q, const T* k) {
  constexpr int kBatch = D / 4 < 8 ? D / 4 : 8;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e0 = 0; e0 < D; e0 += 4 * kBatch) {
    float4 kk[kBatch], qq[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) kk[i] = load4(k + e0 + 4 * i);
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      qq[i] = *reinterpret_cast<const float4*>(q + e0 + 4 * i);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      s[0] = fmaf(qq[i].x, kk[i].x, s[0]);
      s[1] = fmaf(qq[i].y, kk[i].y, s[1]);
      s[2] = fmaf(qq[i].z, kk[i].z, s[2]);
      s[3] = fmaf(qq[i].w, kk[i].w, s[3]);
    }
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

template <typename T, int D>
struct Plan {
  static constexpr int kTileKeys = kTileElems / D;
  static constexpr int kWarpKeys = kTileKeys / kWarps;  // keys a warp takes
  // A staged row: D elements and one 16-byte chunk of padding, so that
  // lanes reading eight consecutive rows by 16 bytes hit distinct banks.
  static constexpr int kLds = D + 16 / sizeof(T);
  static constexpr int kSlots = kGroupMax * D / 4 / 32;  // float4s a lane
  static constexpr size_t kTileBytes =
      (size_t)kStages * 2 * kTileKeys * kLds * sizeof(T);
  // the warps' merge reuses the tiles: each warp's accumulators
  static constexpr size_t kMergeBytes =
      sizeof(float) * kWarps * kGroupMax * D;
  static constexpr size_t kFront =
      kTileBytes > kMergeBytes ? kTileBytes : kMergeBytes;
  // then q (f32), each warp's scores/weights, and each warp's m, l and
  // rescale factors
  static constexpr size_t kSmem =
      kFront + sizeof(float) * (kGroupMax * D +
                                kWarps * kGroupMax * kWarpKeys +
                                kWarps * 3 * kGroupMax);
  static_assert(kWarpKeys >= 1, "a tile must give every warp a key");
  static_assert(kSlots >= 1, "a lane must hold at least one slot");
  static_assert(kFront % 16 == 0, "q must stay 16-byte aligned");
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ part, int b,
                        int h, int s, int kv, int head_blocks, int splits,
                        int keys_per_split, float scale, bool vec) {
  using P = Plan<KV, D>;
  constexpr int TK = P::kTileKeys;
  constexpr int KW = P::kWarpKeys;
  constexpr int LDS = P::kLds;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int split = blockIdx.x;
  const int hb = head_blocks == 1 ? 0 : blockIdx.y % head_blocks;
  const int kvh = head_blocks == 1 ? blockIdx.y : blockIdx.y / head_blocks;
  const int row = blockIdx.z;
  const int group = h / kv;
  const int g_first = hb * kGroupMax;
  const int gb = min(kGroupMax, group - g_first);  // heads of this block
  const int head0 = kvh * group + g_first;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* tiles = reinterpret_cast<KV*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(smem_raw + P::kFront);
  float* sc = q_s + kGroupMax * D + warp * kGroupMax * KW;
  float* ml = q_s + kGroupMax * D + kWarps * kGroupMax * KW;

  const size_t key_stride = (size_t)kv * D;
  const KV* k_row = k + ((size_t)row * s * kv + kvh) * D;
  const KV* v_row = v + ((size_t)row * s * kv + kvh) * D;
  const int begin = split * keys_per_split;
  // Stage tile t of the keys [begin, stop).
  auto issue = [&](int t, int stop) {
    const int key0 = begin + t * TK;
    const int rows = min(TK, stop - key0);
    KV* k_s = tiles + (size_t)(t % kStages) * 2 * TK * LDS;
    tc::stage(k_s, LDS, k_row + key0 * key_stride, (long long)key_stride,
              rows, rows, D, D, vec);
    tc::stage(k_s + TK * LDS, LDS, v_row + key0 * key_stride,
              (long long)key_stride, rows, rows, D, D, vec);
    tc::cp_async_commit();
  };
  // Tile 0 and q go in flight before lengths[row] arrives, so the two
  // loads overlap: tile 0 is read whatever the row's length (at most one
  // tile past its valid prefix).
  issue(0, min(begin + keys_per_split, s));
  const T* q_row = q + ((size_t)row * h + head0) * D;
  for (int i = tid; i < gb * D; i += kThreads) q_s[i] = tc::to_float(q_row[i]);

  const int length = lengths[row];
  // A key at or past `length` scores -1e30.  When at least one key is
  // valid, such a key's weight exp(-1e30 - m) is exactly 0 in f32, so only
  // the valid prefix is read; a row with no valid key scores every key
  // -1e30 and gets the mean of V.
  const bool masked = length < 1;
  const int n_keys = masked ? s : min(length, s);
  const int end = min(begin + keys_per_split, n_keys);

  const size_t bh = (size_t)b * h;
  float* part_ml = part;
  float* part_acc = part + 2 * (size_t)splits * bh;
  const size_t part_row = ((size_t)split * b + row) * h + head0;

  if (begin >= end) {  // only with splits > 1: an empty partial
    tc::cp_async_wait<0>();
    for (int i = tid; i < gb * D; i += kThreads) {
      part_acc[part_row * D + i] = 0.f;
      if (i % D == 0) {
        part_ml[2 * (part_row + i / D)] = kNegInf;
        part_ml[2 * (part_row + i / D) + 1] = 0.f;
      }
    }
    return;
  }
  const int n_tiles = (end - begin + TK - 1) / TK;
  // scores in log2 units, so that each weight is one exp2f
  const float scale_log2 = scale * 1.44269504088896341f;

  // Each warp's online-softmax state, the same in all its lanes: m and l
  // of each head, and the last tile's rescale factor.
  float* m_w = ml + warp * 3 * kGroupMax;
  float* l_w = m_w + kGroupMax;
  float* alpha = l_w + kGroupMax;
  if (lane < kGroupMax) {
    m_w[lane] = kNegInf;
    l_w[lane] = 0.f;
  }
  float4 acc[P::kSlots];
#pragma unroll
  for (int i = 0; i < P::kSlots; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // A range of at most one warp's share of a tile (the serving shapes) goes
  // to warp 0 alone, which then writes the result itself: no merge.
  const bool one_warp = end - begin <= KW;

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<0>();
    // tile t is in (and q, on the first pass); every warp is done with
    // the buffer that tile t + 1 fills
    __syncthreads();
    if (t + 1 < n_tiles) issue(t + 1, end);

    const KV* k_s = tiles + (size_t)(t % kStages) * 2 * TK * LDS;
    const KV* v_s = k_s + TK * LDS;
    const int tile_len = min(TK, end - (begin + t * TK));
    // this warp's keys: a quarter of the tile, spread evenly when it is
    // short
    const int per_warp =
        one_warp ? tile_len : (tile_len + kWarps - 1) / kWarps;
    const int j0 = warp * per_warp;
    const int nw = max(0, min(per_warp, tile_len - j0));
    if (nw == 0) continue;  // warp-uniform; no barrier below

    // scores and online softmax, one lane a (head, key) pair: `span`
    // lanes a head (nw rounded up to a power of two, at most 32), so each
    // head's keys sit in an aligned group of lanes whose maximum and sum
    // take a few xor shuffles, the heads of a pass at once.  A lane
    // computes whole dot products (no shuffle per pair) and reads back
    // only its own scores.
    int log_span = 0;
    while ((1 << log_span) < nw && log_span < 5) ++log_span;
    const int span = 1 << log_span;
    for (int g0 = 0; g0 < gb; g0 += 32 >> log_span) {
      const int g = g0 + (lane >> log_span);
      const int first = lane & (span - 1);
      const bool live = g < gb;
      float* row_sc = sc + (live ? g : 0) * KW;
      float x = kNegInf;
      for (int jj = first; live && jj < nw; jj += span) {
        const float score =
            masked ? kNegInf
                   : dot_row<D>(q_s + g * D, k_s + (j0 + jj) * LDS) *
                         scale_log2;
        row_sc[jj] = score;
        x = fmaxf(x, score);
      }
      for (int off = span / 2; off > 0; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      const float m_old = live ? m_w[g] : kNegInf;
      const float m_new = fmaxf(m_old, x);
      float sum = 0.f;
      for (int jj = first; live && jj < nw; jj += span) {
        const float w = exp2f(row_sc[jj] - m_new);
        row_sc[jj] = w;
        sum += w;
      }
      for (int off = span / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (live && first == 0) {
        const float a = exp2f(m_old - m_new);
        l_w[g] = l_w[g] * a + sum;
        m_w[g] = m_new;
        alpha[g] = a;
      }
    }
    __syncwarp();

    // acc = acc * alpha + p . V over the warp's keys, float4 slots of
    // (head, channel)
#pragma unroll
    for (int i = 0; i < P::kSlots; ++i) {
      const int slot = lane + 32 * i;
      if (slot < gb * (D / 4)) {
        const int g = slot / (D / 4);
        const int e = (slot - g * (D / 4)) * 4;
        const float a = alpha[g];
        float4 o = acc[i];
        o.x *= a;
        o.y *= a;
        o.z *= a;
        o.w *= a;
        const float* w = sc + g * KW;
        const KV* vp = v_s + j0 * LDS + e;
#pragma unroll 4
        for (int jj = 0; jj < nw; ++jj) {
          const float pw = w[jj];
          const float4 vv = load4(vp + jj * LDS);
          o.x = fmaf(pw, vv.x, o.x);
          o.y = fmaf(pw, vv.y, o.y);
          o.z = fmaf(pw, vv.z, o.z);
          o.w = fmaf(pw, vv.w, o.w);
        }
        acc[i] = o;
      }
    }
  }

  T* out_row = out + ((size_t)row * h + head0) * D;
  if (one_warp) {  // warp 0 holds the whole range
    if (warp == 0) {
      __syncwarp();
#pragma unroll
      for (int i = 0; i < P::kSlots; ++i) {
        const int slot = lane + 32 * i;
        if (slot < gb * (D / 4)) {
          const int g = slot / (D / 4);
          const int e = (slot - g * (D / 4)) * 4;
          const float o[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
          const float inv = 1.f / fmaxf(l_w[g], 1e-30f);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (splits == 1)
              out_row[g * D + e + c] = from_float<T>(o[c] * inv);
            else
              part_acc[(part_row + g) * D + e + c] = o[c];
          }
          if (splits > 1 && e == 0) {
            part_ml[2 * (part_row + g)] = m_w[g];
            part_ml[2 * (part_row + g) + 1] = l_w[g];
          }
        }
      }
    }
    return;
  }

  // merge the four warps: each writes its accumulators over the tiles,
  // which every warp is done with
  __syncthreads();
  float* aa = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < P::kSlots; ++i) {
    const int slot = lane + 32 * i;
    if (slot < gb * (D / 4))
      *reinterpret_cast<float4*>(aa + warp * kGroupMax * D + slot * 4) =
          acc[i];
  }
  __syncthreads();

  for (int i = tid; i < gb * D; i += kThreads) {
    const int g = i / D;
    float mx = ml[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      mx = fmaxf(mx, ml[w * 3 * kGroupMax + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* mw = ml + w * 3 * kGroupMax;
      const float wt = exp2f(mw[g] - mx);
      den = fmaf(wt, mw[kGroupMax + g], den);
      num = fmaf(wt, aa[w * kGroupMax * D + i], num);
    }
    if (splits == 1) {
      out_row[i] = from_float<T>(num / fmaxf(den, 1e-30f));
    } else {
      part_acc[part_row * D + i] = num;
      if (i - g * D == 0) {
        part_ml[2 * (part_row + g)] = mx;
        part_ml[2 * (part_row + g) + 1] = den;
      }
    }
  }
}

// One warp per (row, query head): merges the splits' partials.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                          int bh, int splits) {
  constexpr int PER = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int rh = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (rh >= bh) return;
  const float* part_ml = part;
  const float* part_acc = part + 2 * (size_t)splits * bh;
  float mx = kNegInf;
  for (int i = 0; i < splits; ++i)
    mx = fmaxf(mx, part_ml[2 * ((size_t)i * bh + rh)]);
  float den = 0.f;
  float num[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) num[j] = 0.f;
  for (int i = 0; i < splits; ++i) {
    const size_t r = (size_t)i * bh + rh;
    const float wt = exp2f(part_ml[2 * r] - mx);
    den = fmaf(wt, part_ml[2 * r + 1], den);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane + 32 * j;
      if (e < D) num[j] = fmaf(wt, part_acc[r * D + e], num[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = lane + 32 * j;
    if (e < D)
      out[(size_t)rh * D + e] = from_float<T>(num[j] / fmaxf(den, 1e-30f));
  }
}

// T: q's and out's type; KV: K's and V's.
template <typename T, typename KV, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, void* part, int b, int h,
                   int s, int kv, int splits, int keys_per_split, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Plan<KV, D>::kSmem;
  static_assert(smem <= kMaxSmem, "decode tiles exceed shared memory");
  auto kernel = decode_split_kernel<T, KV, D>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int head_blocks = (h / kv + kGroupMax - 1) / kGroupMax;
  const bool vec = ((reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid(splits, kv * head_blocks, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), static_cast<float*>(part), b, h, s, kv,
      head_blocks, splits, keys_per_split, scale, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int bh = b * h;
  decode_combine_kernel<T, D><<<(bh + kWarps - 1) / kWarps, kThreads, 0,
                                stream>>>(static_cast<const float*>(part),
                                          static_cast<T*>(out), bh, splits);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              const void* lengths, void* out, void* part,
                              int b, int h, int s, int kv, int d, int splits,
                              int keys_per_split, float scale,
                              cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, KV, 16>(q, k, v, lengths, out, part, b, h, s, kv,
                               splits, keys_per_split, scale, stream);
    case 32:
      return launch<T, KV, 32>(q, k, v, lengths, out, part, b, h, s, kv,
                               splits, keys_per_split, scale, stream);
    case 64:
      return launch<T, KV, 64>(q, k, v, lengths, out, part, b, h, s, kv,
                               splits, keys_per_split, scale, stream);
    case 128:
      return launch<T, KV, 128>(q, k, v, lengths, out, part, b, h, s, kv,
                                splits, keys_per_split, scale, stream);
    case 256:
      return launch<T, KV, 256>(q, k, v, lengths, out, part, b, h, s, kv,
                                splits, keys_per_split, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (q and out) and kv_dtype (K and V): 0 = float32, 1 = bfloat16; the
// pairs (0, 0), (1, 1) and (0, 1).  `part` holds splits * b * h * (d + 2)
// floats and is read only when splits > 1.  The key ranges of the splits,
// keys_per_split each, must cover s with none empty.  Returns the
// launches' cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, void* part, int b, int h,
                                      int s, int kv, int d, int dtype,
                                      int kv_dtype, int splits,
                                      int keys_per_split, float scale,
                                      void* stream) {
  if (b < 1 || b > 65535 || kv < 1 || h % kv != 0 || s < 1 || splits < 1 ||
      keys_per_split < 1 || (long long)splits * keys_per_split < s ||
      (long long)(splits - 1) * keys_per_split >= s ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && kv_dtype == 0)
    return dispatch_head_dim<float, float>(q, k, v, lengths, out, part, b, h,
                                           s, kv, d, splits, keys_per_split,
                                           scale, st);
  if (dtype == 1 && kv_dtype == 1)
    return dispatch_head_dim<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, lengths, out, part, b, h, s, kv, d, splits, keys_per_split,
        scale, st);
  if (dtype == 0 && kv_dtype == 1)
    return dispatch_head_dim<float, __nv_bfloat16>(
        q, k, v, lengths, out, part, b, h, s, kv, d, splits, keys_per_split,
        scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
