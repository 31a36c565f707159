// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan` in
// src/repro/kernels/ssd_scan.py.  For every batch row and head, with the
// per-step log decay dA_t = dt_t * A and its inclusive cumulative sum cum_t
// inside each chunk of Q steps:
//
//   y_i   = sum_{j<=i in the chunk} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . S                   (S: state entering it)
//   S    <- exp(cum_last) S + sum_j B_j (dt_j exp(cum_last - cum_j) x_j)^T
//
// in f32, from an optional initial state h0, returning y (f32) and the
// final state.  Every decay is formed from a difference that is <= 0
// (cum_i - cum_j for j <= i, cum_last - cum_j, cum_i itself), never as
// exp(cum_i) * exp(-cum_j): with A down to -64 the sums reach the
// thousands and exp(-cum_j) would overflow.  The cumulative sum is kept in
// f64: at those magnitudes one f32 ulp is ~1e-4, and a block scan adds in
// another order than a sequential one, so the difference of two f32 sums
// would carry that error into the weight of every pair near the diagonal.
//
// Layouts: x (b, s, h, p) f32 or bf16; dt (b, s, h) f32; A (h,) f32;
// B, C (b, s, n) in x's type (one group, shared by every head); h0 and the
// final state (b, h, n, p) f32; y (b, s, h, p) f32.  All contiguous.
//
// What bounds it: operations.  A chunk does about Q^2 (n + p) / 2 + 2 Q n p
// multiply-adds per head for Q (p + 2n) / h + Q p bytes read, far above
// the ~20 f32 operations per byte the card needs before compute is the
// limit.  The design: the TPU grid walks the chunks in order and carries
// the state in VMEM; here one block per (head, batch row) loops over the
// chunks itself, with the (n, p) state in shared memory.  A whole chunk of
// B and C (256 x n f32) does not fit beside it at n = 128, so the chunk is
// cut into tiles of 64 rows: for each tile of outputs the block walks the
// tiles of inputs at or below the diagonal, forms the 64 x 64 decayed score
// tile in shared memory, and accumulates its product with x in registers
// (a 4 x p/16 micro-tile per thread).  The chunk's cumulative sum is a
// block scan over warp shuffles.  Tensor cores (wgmma), TMA staging and
// splitting the chunk loop across blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;        // 16 x 16: (ty, tx)
constexpr int kTile = 64;            // rows per tile of a chunk
constexpr int kMaxChunk = 256;       // one cumulative sum per thread
constexpr int kMaxState = 128;       // n
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory, in floats: the chunk's cumulative sums and one partial
// sum per warp (f64, so two floats each, first for alignment), the state
// (n * P), C and B tiles (kTile rows of n + 1, padded against bank
// conflicts), the x tile (kTile * P), the score tile (kTile * (kTile + 1))
// and the chunk's dt (kMaxChunk).
__host__ __device__ inline size_t smem_floats(int n, int p) {
  return 2 * ((size_t)kMaxChunk + kThreads / 32) + (size_t)n * p +
         2 * (size_t)kTile * (n + 1) + (size_t)kTile * p +
         (size_t)kTile * (kTile + 1) + (size_t)kMaxChunk;
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ h0,
                    float* __restrict__ y, float* __restrict__ final_state,
                    int s, int h, int n, int chunk) {
  constexpr int PC = P / 16;  // output columns per thread: tx + 16 c
  const int head = blockIdx.x;
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int np = n + 1;

  extern __shared__ __align__(16) float smem[];
  double* cum_s = reinterpret_cast<double*>(smem);  // kMaxChunk
  double* warp_s = cum_s + kMaxChunk;                // kThreads / 32
  float* state = reinterpret_cast<float*>(warp_s + kThreads / 32);  // n * P
  float* c_s = state + (size_t)n * P;        // kTile * np
  float* b_s = c_s + kTile * np;             // kTile * np
  float* x_s = b_s + kTile * np;             // kTile * P
  float* g_s = x_s + kTile * P;              // kTile * (kTile + 1)
  float* dt_s = g_s + kTile * (kTile + 1);   // kMaxChunk

  const float a = A[head];
  const size_t state_off = ((size_t)row * h + head) * n * P;
  for (int i = tid; i < n * P; i += kThreads)
    state[i] = h0 != nullptr ? h0[state_off + i] : 0.f;

  const size_t step = (size_t)h * P;  // x and y: one time step
  const T* x_bh = x + (size_t)row * s * step + (size_t)head * P;
  float* y_bh = y + (size_t)row * s * step + (size_t)head * P;
  const float* dt_bh = dt + (size_t)row * s * h + head;
  const T* B_b = Bm + (size_t)row * s * n;
  const T* C_b = Cm + (size_t)row * s * n;

  for (int c0 = 0; c0 < s; c0 += chunk) {
    // ---- dt and the chunk's inclusive cumulative sum of dA = dt * A, in
    // f64 (see the note at the top)
    double v = 0.0;
    if (tid < chunk) {
      const float d = dt_bh[(size_t)(c0 + tid) * h];
      dt_s[tid] = d;
      v = (double)(d * a);
    }
    for (int off = 1; off < 32; off <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) warp_s[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += warp_s[w];
    if (tid < chunk) cum_s[tid] = v;
    __syncthreads();
    const double cum_last = cum_s[chunk - 1];

    // ---- y, one tile of kTile output rows at a time
    for (int i0 = 0; i0 < chunk; i0 += kTile) {
      for (int idx = tid; idx < kTile * n; idx += kThreads) {
        const int r = idx / n;
        const int k = idx - r * n;
        c_s[r * np + k] = i0 + r < chunk
                              ? to_float(C_b[(size_t)(c0 + i0 + r) * n + k])
                              : 0.f;
      }
      float acc[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] = 0.f;

      // input tiles at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        __syncthreads();  // the previous tile's readers are done
        for (int idx = tid; idx < kTile * n; idx += kThreads) {
          const int r = idx / n;
          const int k = idx - r * n;
          b_s[r * np + k] = j0 + r < chunk
                                ? to_float(B_b[(size_t)(c0 + j0 + r) * n + k])
                                : 0.f;
        }
        for (int idx = tid; idx < kTile * P; idx += kThreads) {
          const int r = idx / P;
          const int e = idx - r * P;
          x_s[idx] = j0 + r < chunk
                         ? to_float(x_bh[(size_t)(c0 + j0 + r) * step + e])
                         : 0.f;
        }
        __syncthreads();

        // G[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
        for (int k = 0; k < n; ++k) {
          float cr[4], br[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cr[r] = c_s[(ty + 16 * r) * np + k];
#pragma unroll
          for (int c = 0; c < 4; ++c) br[c] = b_s[(tx + 16 * c) * np + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[r][c] += cr[r] * br[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            const bool keep = j <= i && i < chunk;
            g_s[(ty + 16 * r) * (kTile + 1) + tx + 16 * c] =
                keep ? g[r][c] * expf((float)(cum_s[i] - cum_s[j])) * dt_s[j]
                     : 0.f;
          }
        }
        __syncthreads();

        // acc += G . x
        for (int jj = 0; jj < kTile; ++jj) {
          float xr[PC];
#pragma unroll
          for (int c = 0; c < PC; ++c) xr[c] = x_s[jj * P + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float w = g_s[(ty + 16 * r) * (kTile + 1) + jj];
#pragma unroll
            for (int c = 0; c < PC; ++c) acc[r][c] += w * xr[c];
          }
        }
      }

      // the carried state's part: exp(cum_i) C_i . S
      float off[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) off[r][c] = 0.f;
      for (int k = 0; k < n; ++k) {
        float sr[PC];
#pragma unroll
        for (int c = 0; c < PC; ++c) sr[c] = state[k * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cv = c_s[(ty + 16 * r) * np + k];
#pragma unroll
          for (int c = 0; c < PC; ++c) off[r][c] += cv * sr[c];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i < chunk) {
          const float decay = expf((float)cum_s[i]);
          float* y_row = y_bh + (size_t)(c0 + i) * step;
#pragma unroll
          for (int c = 0; c < PC; ++c)
            y_row[tx + 16 * c] = acc[r][c] + decay * off[r][c];
        }
      }
      __syncthreads();  // c_s is reloaded for the next tile
    }

    // ---- state <- exp(cum_last) state + sum_j B_j (w_j x_j)^T, with
    // w_j = dt_j exp(cum_last - cum_j); 64 state rows per pass
    const float chunk_decay = expf((float)cum_last);
    for (int k0 = 0; k0 < n; k0 += kTile) {
      float acc[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] = 0.f;
      for (int j0 = 0; j0 < chunk; j0 += kTile) {
        __syncthreads();
        for (int idx = tid; idx < kTile * n; idx += kThreads) {
          const int r = idx / n;
          const int k = idx - r * n;
          b_s[r * np + k] = j0 + r < chunk
                                ? to_float(B_b[(size_t)(c0 + j0 + r) * n + k])
                                : 0.f;
        }
        for (int idx = tid; idx < kTile * P; idx += kThreads) {
          const int r = idx / P;
          const int e = idx - r * P;
          const int j = j0 + r;
          x_s[idx] = j < chunk
                         ? to_float(x_bh[(size_t)(c0 + j) * step + e]) *
                               dt_s[j] * expf((float)(cum_last - cum_s[j]))
                         : 0.f;
        }
        __syncthreads();
        for (int jj = 0; jj < kTile; ++jj) {
          float xr[PC];
#pragma unroll
          for (int c = 0; c < PC; ++c) xr[c] = x_s[jj * P + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int k = k0 + ty + 16 * r;
            const float bv = k < n ? b_s[jj * np + k] : 0.f;
#pragma unroll
            for (int c = 0; c < PC; ++c) acc[r][c] += bv * xr[c];
          }
        }
      }
      // each thread owns its state entries: no other thread reads them
      // until the barrier below
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + ty + 16 * r;
        if (k < n) {
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            float* entry = state + k * P + tx + 16 * c;
            *entry = chunk_decay * *entry + acc[r][c];
          }
        }
      }
    }
    __syncthreads();  // the state, dt_s and cum_s are read and rewritten
  }

  for (int i = tid; i < n * P; i += kThreads)
    final_state[state_off + i] = state[i];
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* h0, void* y,
                   void* final_state, int b, int s, int h, int n, int chunk,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(n, P);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<T, P>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(final_state), s, h, n,
      chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* h0,
                              void* y, void* final_state, int b, int s, int h,
                              int p, int n, int chunk, cudaStream_t stream) {
  switch (p) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, h0, y, final_state, b, s, h, n,
                           chunk, stream);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, h0, y, final_state, b, s, h, n,
                           chunk, stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, h0, y, final_state, b, s, h, n,
                           chunk, stream);
    case 128:
      return launch<T, 128>(x, dt, A, Bm, Cm, h0, y, final_state, b, s, h, n,
                            chunk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of x, B and C: 0 = float32, 1 = bfloat16.  h0 may be null (a zero
// initial state).  Returns the launch's cudaError_t.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* h0,
                              void* y, void* final_state, int b, int s, int h,
                              int p, int n, int chunk, int dtype,
                              void* stream) {
  if (b < 1 || b > 65535 || h < 1 || s < 1 || n < 1 || n > kMaxState ||
      chunk < 1 || chunk > kMaxChunk || s % chunk != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(x, dt, A, Bm, Cm, h0, y, final_state, b, s,
                                    h, p, n, chunk, st);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y,
                                            final_state, b, s, h, p, n, chunk,
                                            st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
