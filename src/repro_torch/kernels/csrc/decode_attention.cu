// Single-token decode attention (flash-decoding) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `decode_attention` in
// src/repro/kernels/decode_attention.py.  Computes, for every batch row and
// query head,
//
//     out = softmax(q . k^T * d^-1/2, keys at or past lengths[row] masked) . v
//
// with f32 accumulators, an online softmax over key tiles, the finite mask
// value -1e30 and the denominator floored at 1e-30, output in q's dtype.
//
// Layouts: q (b, h, d); k, v (b, s, kv, d) with kv dividing h (GQA: query
// head i reads KV head i / (h / kv), so K/V are never repeated in memory);
// lengths (b,) int32; out (b, h, d).  All contiguous.
//
// What bounds it: bytes.  Each K/V element is used for h/kv multiply-adds,
// far below the ~20 f32 operations per byte the card needs before compute
// is the limit, so the least time is the K and V rows read once over the
// memory rate.  The design reads each K/V row once for all h/kv query heads
// that share it: one block per (KV head, row), K/V tiles staged in shared
// memory as f32, scores reduced across a warp, and the online softmax
// carried in shared memory from tile to tile.  The loop stops at the valid
// prefix (see `n_keys`), so only the keys a row attends to are read.
// Splitting along the cache axis, cp.async/TMA and tensor cores are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Elements of one K (and one V) tile: kTileElems / D keys per tile.
constexpr int kTileElems = 4096;
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

template <int D>
__host__ __device__ constexpr int tile_keys() {
  return kTileElems / D;
}

// Shared memory, in floats: q and the accumulator (group * D each), the K
// and V tiles (TK * D each), the tile's scores/weights (group * TK), and the
// running max, denominator and rescale factor (group each).
template <int D>
__host__ __device__ size_t smem_floats(int group) {
  constexpr int TK = tile_keys<D>();
  return 2 * (size_t)group * D + 2 * (size_t)TK * D + (size_t)group * TK +
         3 * (size_t)group;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int32_t* __restrict__ lengths,
                            T* __restrict__ out, int h, int s, int kv,
                            float scale) {
  constexpr int TK = tile_keys<D>();
  const int group = h / kv;
  const int kvh = blockIdx.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc_s = q_s + group * D;
  float* k_s = acc_s + group * D;
  float* v_s = k_s + TK * D;
  float* p_s = v_s + TK * D;
  float* m_s = p_s + group * TK;
  float* l_s = m_s + group;
  float* alpha_s = l_s + group;

  const int length = lengths[row];
  // A key at or past `length` scores -1e30.  When at least one key is
  // valid, such a key's weight exp(-1e30 - m) is exactly 0 in f32, so the
  // loop stops at the valid prefix.  A row with no valid key weighs all s
  // keys equally (the mean of V), as the reference does; it never gives NaN.
  const int n_keys = length >= 1 ? min(length, s) : s;

  const size_t head0 = (size_t)row * h + (size_t)kvh * group;
  const T* q_row = q + head0 * D;
  for (int i = tid; i < group * D; i += kThreads) {
    q_s[i] = to_float(q_row[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const size_t key_stride = (size_t)kv * D;
  const size_t base = ((size_t)row * s * kv + kvh) * D;
  const T* k_row = k + base;
  const T* v_row = v + base;

  for (int start = 0; start < n_keys; start += TK) {
    const int tile = min(TK, n_keys - start);
    for (int i = tid; i < tile * D; i += kThreads) {
      const int j = i / D;
      const int e = i - j * D;
      const size_t offset = (size_t)(start + j) * key_stride + e;
      k_s[i] = to_float(k_row[offset]);
      v_s[i] = to_float(v_row[offset]);
    }
    __syncthreads();

    // Scores: one warp per (query head, key) pair, reduced across the warp.
    for (int pair = warp; pair < group * tile; pair += kWarps) {
      const int g = pair / tile;
      const int j = pair - g * tile;
      float dot = 0.f;
      for (int e = lane; e < D; e += 32) dot += q_s[g * D + e] * k_s[j * D + e];
      dot = warp_sum(dot);
      if (lane == 0)
        p_s[g * TK + j] = (start + j < length) ? dot * scale : kNegInf;
    }
    __syncthreads();

    // Online softmax: one warp per query head.
    for (int g = warp; g < group; g += kWarps) {
      float* p = p_s + g * TK;
      float tile_max = kNegInf;
      for (int j = lane; j < tile; j += 32) tile_max = fmaxf(tile_max, p[j]);
      tile_max = warp_max(tile_max);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, tile_max);
      float sum = 0.f;
      for (int j = lane; j < tile; j += 32) {
        const float w = expf(p[j] - m_new);
        p[j] = w;
        sum += w;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V, one thread per (query head, channel).
    for (int i = tid; i < group * D; i += kThreads) {
      const int g = i / D;
      const int e = i - g * D;
      const float* p = p_s + g * TK;
      float a = acc_s[i] * alpha_s[g];
      for (int j = 0; j < tile; ++j) a += p[j] * v_s[j * D + e];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  T* out_row = out + head0 * D;
  for (int i = tid; i < group * D; i += kThreads)
    out_row[i] = from_float<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int b, int h, int s, int kv,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>(h / kv);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = decode_attention_kernel<T, D>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(kv, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), h, s, kv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              const void* lengths, void* out, int b, int h,
                              int s, int kv, int d, float scale,
                              cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, out, b, h, s, kv, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, b, h, s, kv, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, b, h, s, kv, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, b, h, s, kv, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, out, b, h, s, kv, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, int b, int h, int s, int kv,
                                      int d, int dtype, float scale,
                                      void* stream) {
  if (b < 1 || kv < 1 || h % kv != 0 || s < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(q, k, v, lengths, out, b, h, s, kv, d,
                                    scale, st);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, lengths, out, b, h, s, kv,
                                            d, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
