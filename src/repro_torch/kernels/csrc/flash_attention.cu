// Flash attention (forward) for Hopper (sm_90a).
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
// memory); out (b, h, sq, d).  All contiguous.  Any sq, sk >= 1 (the
// Pallas kernel needs multiples of its block): the ragged last tiles are
// masked here.
//
// What bounds it: operations.  Each K/V element is used by the 64 queries
// of a tile for 2 multiply-adds, and a causal call does about
// 2 b h sq sk d multiply-adds over (2 b h sq + 2 b kv sk) d elements, far
// above the ~20 f32 operations per byte the card needs before compute is
// the limit.  The design: one block of 256 threads per (query tile of 64,
// head, batch row); K and V tiles of 64 keys staged in shared memory as
// f32; each thread keeps a 4 x 4 micro-tile of scores and a 4 x d/16
// micro-tile of the output accumulator in registers; the running max and
// denominator live in shared memory.  Key tiles that the causal mask or
// the window empties for the whole query tile are skipped.  Tensor cores
// (wgmma), TMA staging and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;  // 16 x 16: (ty, tx)
constexpr int kTile = 64;      // queries per block, keys per tile
constexpr int kWarps = kThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int offset = 16; offset > 0; offset >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int offset = 16; offset > 0; offset >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, offset));
  return x;
}

// Shared memory, in floats: the q and K tiles (kTile rows of D + 1, padded
// against bank conflicts), the V tile (kTile * D), the score tile
// (kTile * (kTile + 1)), and the running max, denominator and rescale
// factor (kTile each).
template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  return 2 * (size_t)kTile * (D + 1) + (size_t)kTile * D +
         (size_t)kTile * (kTile + 1) + 3 * (size_t)kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int h,
                           int kv, int sq, int sk, int causal, int window,
                           float scale) {
  constexpr int DC = D / 16;  // output columns per thread: tx + 16 c
  constexpr int DP = D + 1;
  constexpr int SP = kTile + 1;
  const int q0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;              // kTile * DP
  float* k_s = q_s + kTile * DP;  // kTile * DP
  float* v_s = k_s + kTile * DP;  // kTile * D
  float* s_s = v_s + kTile * D;   // kTile * SP
  float* m_s = s_s + kTile * SP;  // kTile
  float* l_s = m_s + kTile;       // kTile
  float* alpha_s = l_s + kTile;   // kTile

  const int kv_head = head / (h / kv);
  const T* q_bh = q + ((size_t)row * h + head) * sq * D;
  const T* k_bh = k + ((size_t)row * kv + kv_head) * sk * D;
  const T* v_bh = v + ((size_t)row * kv + kv_head) * sk * D;
  T* out_bh = out + ((size_t)row * h + head) * sq * D;

  for (int idx = tid; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int e = idx - r * D;
    q_s[r * DP + e] =
        q0 + r < sq ? to_float(q_bh[(size_t)(q0 + r) * D + e]) : 0.f;
  }
  for (int r = tid; r < kTile; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // The keys this query tile walks: [k_begin, k_end).  A key outside the
  // range has no weight (-inf); a masked key inside it scores -1e30, which
  // weighs 0 once a row has seen a valid key and weighs all keys equally in
  // a row that sees none.  Rows whose band lies wholly past the last key
  // (i - (sk - 1) >= window) see none; the last row of the tile is the
  // first to do so, and then the tile walks every key, as the oracle's
  // mean of V needs.
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

  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kTile) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int r = idx / D;
      const int e = idx - r * D;
      const bool in = kt + r < k_end;
      const size_t offset = (size_t)(kt + r) * D + e;
      k_s[r * DP + e] = in ? to_float(k_bh[offset]) : 0.f;
      v_s[idx] = in ? to_float(v_bh[offset]) : 0.f;
    }
    __syncthreads();

    // scores: a 4 x 4 micro-tile per thread
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
    for (int e = 0; e < D; ++e) {
      float qr[4], kr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qr[r] = q_s[(ty + 16 * r) * DP + e];
#pragma unroll
      for (int c = 0; c < 4; ++c) kr[c] = k_s[(tx + 16 * c) * DP + e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] += qr[r] * kr[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = kt + tx + 16 * c;
        float value = -INFINITY;
        if (j < k_end) {
          bool seen = true;
          if (causal) {
            seen = i >= j;
            if (window > 0) seen = seen && i - j < window;
          }
          value = seen ? sc[r][c] * scale : kNegInf;
        }
        s_s[(ty + 16 * r) * SP + tx + 16 * c] = value;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, 8 rows per warp
    for (int r = warp; r < kTile; r += kWarps) {
      float* p = s_s + r * SP;
      const float s0 = p[lane];
      const float s1 = p[lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      p[lane] = p0;
      p[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float alpha = alpha_s[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    for (int jj = 0; jj < kTile; ++jj) {
      float vr[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vr[c] = v_s[jj * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float w = s_s[(ty + 16 * r) * SP + jj];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] += w * vr[c];
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i < sq) {
      const float inv = 1.f / fmaxf(l_s[ty + 16 * r], 1e-30f);
#pragma unroll
      for (int c = 0; c < DC; ++c)
        out_bh[(size_t)i * D + tx + 16 * c] = from_float<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int h, int kv, int sq, int sk, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<D>();
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
      static_cast<const T*>(v), static_cast<T*>(out), h, kv, sq, sk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              void* out, int b, int h, int kv, int sq, int sk,
                              int d, int causal, int window, float scale,
                              cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, out, b, h, kv, sq, sk, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, b, h, kv, sq, sk, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, h, kv, sq, sk, causal, window,
                            scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means none.  Returns the
// launch's cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int h,
                                     int kv, int sq, int sk, int d,
                                     int causal, int window, int dtype,
                                     float scale, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kv < 1 || h % kv != 0 ||
      sq < 1 || sk < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(q, k, v, out, b, h, kv, sq, sk, d, causal,
                                    window, scale, st);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, out, b, h, kv, sq, sk, d,
                                            causal, window, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
