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
// multiply-adds over (2 b h sq + 2 b kv sk) d elements.  Both products run
// on tensor cores, f32-accurate in three TF32 passes (tf32_mma.cuh), whose
// least time is 3x the f32 work over the card's TF32 rate.
//
// The design, FlashAttention-2 style:
// - one block of 4 warps per (query tile of 64, head, batch row), 16 query
//   rows per warp; with `causal`, the heaviest query tiles launch first;
// - Q's fragments, pre-scaled by d^-1/2 log2(e) and split into hi and lo
//   once, stay in registers for the whole key loop (at d = 128, in shared
//   memory, split as they are read);
// - K and V tiles of 64 keys are double-buffered in shared memory by
//   16-byte cp.async, tile t + 1 loading while tile t is multiplied, with
//   one barrier per tile; bf16 tiles are copied as they are and widened to
//   f32 as fragments are loaded;
// - S = Q.K^T and P.V by mma.sync m16n8k8; each tile's P.V is summed apart
//   and added to O in f32;
// - the online softmax stays in registers: row max and sum over the four
//   lanes that share a row;
// - the score fragment becomes P.V's A fragment without shuffles: A's
//   column t stands for key 2t and column t + 4 for key 2t + 1, and V's
//   rows are read in the same order;
// - masks are applied only on tiles that need them, and key tiles that the
//   causal mask or the window empties for the whole query tile are skipped;
// - head dims 16, 32, 64 and 128: at d = 16 a row is 64 bytes in f32 and
//   32 in bf16, whole 16-byte cp.async chunks either way, and S = Q.K^T
//   takes two k-steps of 8 (the transformer policy's preset runs there).
// wgmma (which needs V transposed in shared memory for TF32), TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // queries per block (16 per warp), keys per tile
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

struct Strides {
  long long b, h, s;
};

// Shared-memory row length in elements: d plus a pad that keeps the rows
// 16-byte aligned and the fragment loads free of bank conflicts.
template <typename T, int D>
__host__ __device__ constexpr int row_len() {
  return D + (sizeof(T) == 4 ? 4 : 8);
}

// Q's fragments stay in registers, split into hi and lo once, up to
// d = 64; at d = 128 the registers go to O and the tile's P.V, and Q waits
// in shared memory, split as it is read.
template <int D>
__host__ __device__ constexpr bool q_in_registers() {
  return D <= 64;
}

// Two stages of K and V tiles, then the Q tile when it is not in registers.
template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return (2 * 2 + (q_in_registers<D>() ? 0 : 1)) * (size_t)kTile *
         row_len<T, D>() * sizeof(T);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           Strides qs, Strides ks, Strides vs, Strides os,
                           int h, int kv, int sq, int sk, int causal,
                           int window, float q_scale) {
  constexpr int LD = row_len<T, D>();
  constexpr int KT = D / 8;      // k-steps of S = Q.K^T
  constexpr int NT = kTile / 8;  // key groups of 8
  constexpr int DT = D / 8;      // output column groups of 8
  constexpr bool kQRegs = q_in_registers<D>();
  const int tile = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kTile;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int kv_head = head / (h / kv);
  const T* q_bh = q + row * qs.b + head * qs.h;
  const T* k_bh = k + row * ks.b + kv_head * ks.h;
  const T* v_bh = v + row * vs.b + kv_head * vs.h;
  T* out_bh = out + row * os.b + head * os.h;

  // this thread's rows of the tile: r0 (c0, c1, a0, a2) and r1 = r0 + 8
  const int r0 = q0 + 16 * warp + g;
  const int r1 = r0 + 8;

  uint32_t qh[kQRegs ? KT : 1][4], ql[kQRegs ? KT : 1][4];
  T* q_s = smem + 2 * 2 * kTile * LD;  // when Q is not in registers
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int e = 8 * kk + t;
      tc::split(r0 < sq ? tc::to_float(q_bh[r0 * qs.s + e]) * q_scale : 0.f,
                qh[kk][0], ql[kk][0]);
      tc::split(r1 < sq ? tc::to_float(q_bh[r1 * qs.s + e]) * q_scale : 0.f,
                qh[kk][1], ql[kk][1]);
      tc::split(
          r0 < sq ? tc::to_float(q_bh[r0 * qs.s + e + 4]) * q_scale : 0.f,
          qh[kk][2], ql[kk][2]);
      tc::split(
          r1 < sq ? tc::to_float(q_bh[r1 * qs.s + e + 4]) * q_scale : 0.f,
          qh[kk][3], ql[kk][3]);
    }
  } else {  // rows past sq are zeros; committed with the first K/V tile
    tc::stage(q_s, LD, q_bh + q0 * qs.s, qs.s, min(kTile, sq - q0), kTile,
              D, D, tc::aligned16(q_bh, qs.s));
  }

  // The keys this query tile walks: [k_begin, k_end).  A masked key inside
  // it scores -1e30, which weighs 0 once a row has seen a valid key and
  // weighs all keys equally in a row that sees none; a key past sk weighs
  // 0.  Rows whose band lies wholly past the last key
  // (i - (sk - 1) >= window) see none; the last row of the tile is the
  // first to do so, and then the tile walks every key, as the oracle's mean
  // of V needs.
  const int q_last = min(q0 + kTile, sq) - 1;
  int k_begin = 0;
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
  const int n_tiles = (k_end - k_begin + kTile - 1) / kTile;
  const bool k_vec = tc::aligned16(k_bh, ks.s);
  const bool v_vec = tc::aligned16(v_bh, vs.s);

  auto stage_kv = [&](int it) {
    const int kt = k_begin + it * kTile;
    const int rows = min(kTile, sk - kt);
    T* k_s = smem + (it & 1) * 2 * kTile * LD;
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
    const T* k_s = smem + (it & 1) * 2 * kTile * LD;
    const T* v_s = k_s + kTile * LD;
    const int kt = k_begin + it * kTile;

    // S = Q.K^T (log2 units): B(e, key) = K[key][e]
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = qh[kk][e];
          al[e] = ql[kk][e];
        }
      } else {
        const T* q_row = q_s + (16 * warp + g) * LD + 8 * kk + t;
        tc::split(tc::to_float(q_row[0]) * q_scale, ah[0], al[0]);
        tc::split(tc::to_float(q_row[8 * LD]) * q_scale, ah[1], al[1]);
        tc::split(tc::to_float(q_row[4]) * q_scale, ah[2], al[2]);
        tc::split(tc::to_float(q_row[8 * LD + 4]) * q_scale, ah[3], al[3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* k_row = k_s + (8 * nt + g) * LD + 8 * kk + t;
        uint32_t bh[2], bl[2];
        tc::split(tc::to_float(k_row[0]), bh[0], bl[0]);
        tc::split(tc::to_float(k_row[4]), bh[1], bl[1]);
        tc::mma3(s[nt], ah, al, bh, bl);
      }
    }

    // masks, on tiles that need them: the ragged last tile, and tiles
    // that the causal mask or the window cut for some (row, key) pair
    const bool whole =
        kt + kTile <= sk &&
        (!causal || (kt + kTile - 1 <= q0 &&
                     (window <= 0 || q0 + kTile - 1 - kt < window)));
    if (!whole) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? r0 : r1;
          const int j = kt + 8 * nt + 2 * t + (e & 1);
          if (j >= sk)
            s[nt][e] = -INFINITY;
          else if (causal && (j > i || (window > 0 && i - j >= window)))
            s[nt][e] = kNegInf;
        }
    }

    // online softmax in registers; the four lanes of a row share its max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
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
    // 2t + 1.  The tile's sum starts from zero and is added to O in f32:
    // tensor cores do not round their sums to nearest, and a running O fed
    // through every tile's mma would gather that error.
    float pv[DT][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ph[4], pl[4];
      tc::split(s[kk][0], ph[0], pl[0]);  // (r0, key 2t)
      tc::split(s[kk][2], ph[1], pl[1]);  // (r1, key 2t)
      tc::split(s[kk][1], ph[2], pl[2]);  // (r0, key 2t + 1)
      tc::split(s[kk][3], ph[3], pl[3]);  // (r1, key 2t + 1)
      const T* v_even = v_s + (8 * kk + 2 * t) * LD + g;
      const T* v_odd = v_even + LD;
#pragma unroll
      for (int dn = 0; dn < DT; ++dn) {
        uint32_t bh[2], bl[2];
        tc::split(tc::to_float(v_even[8 * dn]), bh[0], bl[0]);
        tc::split(tc::to_float(v_odd[8 * dn]), bh[1], bl[1]);
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

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = 8 * dn + 2 * t;
    if (r0 < sq)
      store2(out_bh + r0 * os.s + col, o[dn][0] * inv0, o[dn][1] * inv0);
    if (r1 < sq)
      store2(out_bh + r1 * os.s + col, o[dn][2] * inv1, o[dn][3] * inv1);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const Strides* strides, int b, int h, int kv, int sq,
                   int sk, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static_assert(smem <= kMaxSmem, "flash_attention: shared memory");
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + kTile - 1) / kTile, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), strides[0], strides[1],
      strides[2], strides[3], h, kv, sq, sk, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              void* out, const Strides* strides, int b, int h,
                              int kv, int sq, int sk, int d, int causal,
                              int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, strides, b, h, kv, sq, sk, causal,
                           window, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, strides, b, h, kv, sq, sk, causal,
                           window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, strides, b, h, kv, sq, sk, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, strides, b, h, kv, sq, sk, causal,
                            window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, position) for q, k, v and
// out in turn; the last dimension of each is contiguous.  dtype: 0 =
// float32, 1 = bfloat16; window <= 0 means none.  Returns the launch's
// cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out,
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
  if (dtype == 0)
    return dispatch_head_dim<float>(q, k, v, out, s, b, h, kv, sq, sk, d,
                                    causal, window, scale, st);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, out, s, b, h, kv, sq, sk,
                                            d, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
