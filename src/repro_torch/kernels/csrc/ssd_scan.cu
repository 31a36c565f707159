// Mamba2 SSD chunk scan for Hopper (sm_90a), on tensor cores.
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
// f64: at those magnitudes one f32 ulp is ~1e-4, and the difference of two
// f32 sums would carry that error into the weight of every pair near the
// diagonal.
//
// Layouts: x (b, s, h, p) f32 or bf16; dt (b, s, h) f32; A (h,) f32;
// B, C (b, s, n) in x's type (one group, shared by every head); h0 and the
// final state (b, h, n, p) f32; y (b, s, h, p) f32.  All contiguous.
// Scratch, from the caller: cum (b, s, h) f64, G (b, nc, Q, Q) f32 and the
// chunk states (b, nc, h, n, p) f32, nc = s / Q.
//
// What bounds it: operations.  Per chunk, C.B^T over the Q (Q + 1) / 2
// pairs once for all heads (they share B and C), then per head the
// decay-weighted scores times x, C times the entering state and the chunk
// state, Q n p multiply-adds each: far above the ~20 operations per byte
// the card needs before compute is the limit.  Every product runs on
// tensor cores, f32-accurate in three TF32 passes (tf32_mma.cuh).  The
// design is the chunked SSD of Mamba2 (arXiv:2405.21060 section 7): the
// TPU grid walks the chunks in order and carries the state in VMEM; here
// only the short state recurrence is serial, in four kernels launched in
// order on one stream:
//   1. scores, grid (chunk x tile pair, b): the f64 cumulative sums of
//      every head, and G = C.B^T once per (batch row, chunk) for all heads,
//      one 64 x 64 tile at or below the diagonal per block;
//   2. chunk states, grid (chunk x n-tile, h, b): S_c = B^T (w x) over the
//      chunk, w_j = dt_j exp(cum_last - cum_j), all chunks in parallel;
//   3. state passing, grid (n p / 256, h, b): S_in(c + 1) = exp(cum_last)
//      S_in(c) + S_c from h0 or zero, written over S_c, and the final
//      state: the one serial pass, short and memory-bound;
//   4. chunk scan, grid (row tile x chunk, h, b): y for 64 rows, the
//      decay-weighted G tile built in registers from G and the f64 sums
//      (below the diagonal as G_ij u_i w_j, with per-tile factors <= 1),
//      times x over the tiles at or below the diagonal, plus
//      (exp(cum_i) C_i).S_in; the heaviest row tiles launch first.
// Tiles of x, B, C, G and the states are staged in shared memory by
// 16-byte cp.async, double-buffered in kernels 2 and 4; bf16 x, B and C
// are copied as they are and widened to f32 as fragments are loaded.
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kTile = 64;       // rows per tile of a chunk
constexpr int kMaxChunk = 256;
constexpr int kMaxState = 128;  // n
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// Shared-memory row pads, in elements, that keep rows 16-byte aligned and
// the fragment loads free of bank conflicts: kPadCol for tiles whose
// product sums along a row (lanes read down 8 rows, 4 columns), kPadRow for
// tiles whose product sums down the columns (4 rows, 8 columns).
template <typename T>
constexpr int kPadCol = sizeof(T) == 4 ? 4 : 8;
constexpr int kPadRow = 8;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

template <typename T>
__device__ __forceinline__ bool whole_chunks(int cols) {
  return cols % (16 / (int)sizeof(T)) == 0;
}

// ------------------------------------------------- 1. cumulative sums, G
template <typename T>
__host__ __device__ constexpr size_t scores_smem(int n) {
  return 2 * (size_t)kTile * (round_up(n, 8) + kPadCol<T>) * sizeof(T);
}

// The lower-triangle tile pair `pair` of a chunk: (ti, tj), tj <= ti.
__device__ __forceinline__ void tile_pair(int pair, int& ti, int& tj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= pair) ++ti;
  tj = pair - ti * (ti + 1) / 2;
}

template <typename T>
__global__ void __launch_bounds__(256)
    ssd_scores_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, double* __restrict__ cum,
                      float* __restrict__ G, int s, int h, int n, int chunk) {
  constexpr int kBatch = 16;  // loads in flight per thread
  const int tiles = (chunk + kTile - 1) / kTile;
  const int pairs = tiles * (tiles + 1) / 2;
  const int c = blockIdx.x / pairs;
  const int pair = blockIdx.x - c * pairs;
  const int nc = gridDim.x / pairs;
  const int row = blockIdx.y;
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;

  // the chunk's inclusive cumulative sums of dt * A, in f64, one head per
  // thread in order, the heads spread over the chunk's blocks (coalesced:
  // neighbouring heads are neighbours in dt)
  for (int head = pair * blockDim.x + threadIdx.x; head < h;
       head += pairs * blockDim.x) {
    const float a = A[head];
    const float* d = dt + t0 * h + head;
    double* out = cum + t0 * h + head;
    double acc = 0.0;
    for (int i0 = 0; i0 < chunk; i0 += kBatch) {
      float step[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        step[u] = i0 + u < chunk ? d[(size_t)(i0 + u) * h] : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (i0 + u < chunk) {
          acc += (double)(step[u] * a);
          out[(size_t)(i0 + u) * h] = acc;
        }
    }
  }

  // G[i][j] = C_i . B_j on this block's 64 x 64 tile; each warp takes 16
  // rows x 32 columns
  int ti, tj;
  tile_pair(pair, ti, tj);
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const int np = round_up(n, 8);
  const int ld = np + kPadCol<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* c_s = reinterpret_cast<T*>(smem_raw);
  T* b_s = c_s + kTile * ld;
  const T* C0 = Cm + (t0 + i0) * n;
  const T* B0 = Bm + (t0 + j0) * n;
  const bool vec = tc::aligned16(C0, n) && tc::aligned16(B0, n) &&
                   whole_chunks<T>(n);
  tc::stage(c_s, ld, C0, n, min(kTile, chunk - i0), kTile, n, np, vec);
  tc::stage(b_s, ld, B0, n, min(kTile, chunk - j0), kTile, n, np, vec);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = 16 * (warp >> 1);
  const int wc = 32 * (warp & 1);
  float acc[4][4] = {};
  tc::warp_mma3<4>(
      acc, np,
      [&](int r, int k) { return tc::to_float(c_s[(wr + r) * ld + k]); },
      [&](int k, int col) { return tc::to_float(b_s[(wc + col) * ld + k]); });
  float* G_c = G + ((size_t)row * nc + c) * chunk * chunk;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + wr + (lane >> 2) + (e < 2 ? 0 : 8);
      const int j = j0 + wc + 8 * nt + 2 * (lane & 3) + (e & 1);
      if (i < chunk && j < chunk) G_c[(size_t)i * chunk + j] = acc[nt][e];
    }
}

// ----------------------------------------------------- 2. chunk states
template <typename T, int P>
__host__ __device__ constexpr size_t states_smem(int n) {
  return kMaxChunk * sizeof(float) +
         2 * (size_t)kTile *
             (round_up(n < kTile ? n : kTile, 16) + kPadRow + P + kPadRow) *
             sizeof(T);
}

template <typename T, int P>
__global__ void __launch_bounds__(128)
    ssd_states_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Bm,
                      const double* __restrict__ cum, float* __restrict__ S,
                      int s, int h, int n, int chunk) {
  constexpr int LDX = P + kPadRow;
  const int ntn = (n + kTile - 1) / kTile;
  const int c = blockIdx.x / ntn;
  const int n0 = (blockIdx.x - c * ntn) * kTile;
  const int nc = gridDim.x / ntn;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nn = min(kTile, n - n0);       // state rows of this block
  const int nnp = round_up(nn, 16);
  const int ldb = nnp + kPadRow;
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);  // kMaxChunk
  T* tiles_s = reinterpret_cast<T*>(w_s + kMaxChunk);
  const int stage_len = kTile * (ldb + LDX);

  // w_j = dt_j exp(cum_last - cum_j), 0 past the chunk
  const double last = cum[(t0 + chunk - 1) * h + head];
  for (int j = threadIdx.x; j < kMaxChunk; j += blockDim.x)
    w_s[j] = j < chunk ? dt[(t0 + j) * h + head] *
                             expf((float)(last - cum[(t0 + j) * h + head]))
                       : 0.f;

  const T* B0 = Bm + t0 * n + n0;
  const T* x0 = x + t0 * h * P + (size_t)head * P;
  const bool b_vec = tc::aligned16(B0, n) && whole_chunks<T>(nn);
  const bool x_vec = tc::aligned16(x0, (long long)h * P);
  const int tiles = (chunk + kTile - 1) / kTile;
  auto stage = [&](int it) {
    const int j0 = it * kTile;
    const int rows = min(kTile, chunk - j0);
    T* b_s = tiles_s + (it & 1) * stage_len;
    tc::stage(b_s, ldb, B0 + (size_t)j0 * n, n, rows, kTile, nn, nnp, b_vec);
    tc::stage(b_s + kTile * ldb, LDX, x0 + (size_t)j0 * h * P,
              (long long)h * P, rows, kTile, P, P, x_vec);
    tc::cp_async_commit();
  };

  // warp w: state rows n0 + wr .. + 16, all P columns
  const int wr = 16 * warp;
  float acc[P / 8][4] = {};
  stage(0);
  for (int it = 0; it < tiles; ++it) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile `it` and w_s are in; the other buffer is free
    if (it + 1 < tiles) stage(it + 1);
    if (wr < nn) {
      const T* b_s = tiles_s + (it & 1) * stage_len;
      const T* x_s = b_s + kTile * ldb;
      const float* w = w_s + it * kTile;
      tc::warp_mma3<P / 8>(
          acc, kTile,
          [&](int r, int k) { return tc::to_float(b_s[k * ldb + wr + r]); },
          [&](int k, int col) {
            return tc::to_float(x_s[k * LDX + col]) * w[k];
          });
    }
  }

  float* S_c = S + (((size_t)row * nc + c) * h + head) * n * P;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr + g + 8 * half;
    if (r < nn) {
      float* out = S_c + (size_t)(n0 + r) * P;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt)
        *reinterpret_cast<float2*>(out + 8 * nt + 2 * t) = make_float2(
            acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// ------------------------------------------------------- 3. state passing
__global__ void __launch_bounds__(256)
    ssd_pass_kernel(const double* __restrict__ cum,
                    const float* __restrict__ h0, float* __restrict__ S,
                    float* __restrict__ final_state, int s, int h, int np,
                    int chunk, int nc) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= np) return;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  constexpr int kBatch = 8;  // chunks whose loads are in flight together
  const size_t off = ((size_t)row * h + head) * np + idx;
  float state = h0 != nullptr ? h0[off] : 0.f;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float decay[kBatch], chunk_state[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        decay[u] = expf((float)cum[((size_t)row * s + (size_t)c * chunk +
                                    chunk - 1) * h + head]);
        chunk_state[u] = S[(((size_t)row * nc + c) * h + head) * np + idx];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u;
      if (c < nc) {
        // the state entering chunk c
        S[(((size_t)row * nc + c) * h + head) * np + idx] = state;
        state = decay[u] * state + chunk_state[u];
      }
    }
  }
  final_state[off] = state;
}

// ---------------------------------------------------------- 4. chunk scan
// Shared memory of the chunk scan, in bytes: the chunk's cumulative sums
// (f64) and dt, the row decays exp(cum_i), each warp's factors of an
// off-diagonal tile (16 rows, 64 columns), then two buffers of a G tile and
// an x tile.  The C tile and the entering state are used once, before the
// loop, and share the second buffer's space.
constexpr size_t kOutputHead =
    kMaxChunk * (sizeof(double) + sizeof(float)) +
    (kTile + 4 * (16 + kTile)) * sizeof(float);

template <typename T, int P>
__host__ __device__ constexpr size_t output_ring_len() {
  return (size_t)kTile *
         ((kTile + 4) * sizeof(float) + (P + kPadRow) * sizeof(T));
}

template <typename T, int P>
__host__ __device__ constexpr size_t output_once_len(int n) {
  return (size_t)kTile * (round_up(n, 8) + kPadCol<T>) * sizeof(T) +
         (size_t)round_up(n, 8) * (P + kPadRow) * sizeof(float);
}

template <typename T, int P>
__host__ __device__ constexpr size_t output_smem(int n) {
  return kOutputHead + output_ring_len<T, P>() +
         (output_once_len<T, P>(n) > output_ring_len<T, P>()
              ? output_once_len<T, P>(n)
              : output_ring_len<T, P>());
}

template <typename T, int P>
__global__ void __launch_bounds__(128)
    ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Cm,
                      const double* __restrict__ cum,
                      const float* __restrict__ G,
                      const float* __restrict__ S, float* __restrict__ y,
                      int s, int h, int n, int chunk) {
  constexpr int LDX = P + kPadRow;
  constexpr int LDS = P + kPadRow;
  constexpr int LDG = kTile + 4;
  const int n_row_tiles = (chunk + kTile - 1) / kTile;
  const int c = blockIdx.x / n_row_tiles;
  const int ti = n_row_tiles - 1 - (blockIdx.x - c * n_row_tiles);
  const int nc = gridDim.x / n_row_tiles;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i0 = ti * kTile;
  const int rows = min(kTile, chunk - i0);
  const int np = round_up(n, 8);
  const int ldc = np + kPadCol<T>;
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum_s = reinterpret_cast<double*>(smem_raw);  // kMaxChunk
  float* dt_s = reinterpret_cast<float*>(cum_s + kMaxChunk);
  float* dec_s = dt_s + kMaxChunk;                     // kTile
  // warp w: rows i0 + wr .. + 16, all P columns, with its factors of an
  // off-diagonal tile: u (16 rows) and w (64 columns)
  const int wr = 16 * warp;
  float* u_s = dec_s + kTile + warp * (16 + kTile);
  float* w_s = u_s + 16;
  unsigned char* ring = smem_raw + kOutputHead;
  constexpr size_t ring_len = output_ring_len<T, P>();
  T* c_s = reinterpret_cast<T*>(ring + ring_len);      // kTile x ldc
  float* st_s = reinterpret_cast<float*>(c_s + kTile * ldc);  // np x LDS

  const T* C0 = Cm + (t0 + i0) * n;
  const float* st = S + (((size_t)row * nc + c) * h + head) * n * P;
  const float* G_c = G + ((size_t)row * nc + c) * chunk * chunk +
                     (size_t)i0 * chunk;
  const T* x0 = x + t0 * h * P + (size_t)head * P;
  const bool c_vec = tc::aligned16(C0, n) && whole_chunks<T>(n);
  const bool st_vec = tc::aligned16(st, P);
  const bool g_vec = tc::aligned16(G_c, chunk) && chunk % 4 == 0;
  const bool x_vec = tc::aligned16(x0, (long long)h * P);
  auto stage = [&](int tj) {  // into buffer tj & 1
    const int j0 = tj * kTile;
    float* g_s = reinterpret_cast<float*>(ring + (tj & 1) * ring_len);
    T* x_s = reinterpret_cast<T*>(g_s + kTile * LDG);
    tc::stage(g_s, LDG, G_c + j0, chunk, rows, kTile,
              min(kTile, chunk - j0), kTile, g_vec);
    tc::stage(x_s, LDX, x0 + (size_t)j0 * h * P, (long long)h * P,
              min(kTile, chunk - j0), kTile, P, P, x_vec);
  };

  tc::stage(c_s, ldc, C0, n, rows, kTile, n, np, c_vec);
  tc::stage(st_s, LDS, st, P, n, np, P, P, st_vec);
  stage(0);
  tc::cp_async_commit();
  for (int j = threadIdx.x; j < min(chunk, i0 + kTile); j += blockDim.x) {
    cum_s[j] = cum[(t0 + j) * h + head];
    dt_s[j] = dt[(t0 + j) * h + head];
  }
  for (int r = threadIdx.x; r < kTile; r += blockDim.x)
    dec_s[r] = r < rows ? expf((float)cum[(t0 + i0 + r) * h + head]) : 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();

  // first the entering state: (exp(cum_i) C_i) . S_in
  float acc[P / 8][4] = {};
  tc::warp_mma3<P / 8>(
      acc, np,
      [&](int r, int k) {
        return tc::to_float(c_s[(wr + r) * ldc + k]) * dec_s[wr + r];
      },
      [&](int k, int col) { return st_s[k * LDS + col]; });

  // then (G_ij exp(cum_i - cum_j) dt_j) . x_j over the tiles j <= i
  for (int tj = 0; tj <= ti; ++tj) {
    tc::cp_async_wait<0>();
    // tile tj is in; every warp is done with the other buffer (at tj = 0,
    // with the C tile and the state that share it)
    __syncthreads();
    if (tj < ti) {
      stage(tj + 1);
      tc::cp_async_commit();
    }
    const int j0 = tj * kTile;
    const float* g_s =
        reinterpret_cast<const float*>(ring + (tj & 1) * ring_len);
    const T* x_s = reinterpret_cast<const T*>(g_s + kTile * LDG);
    auto x_at = [&](int k, int col) {
      return tc::to_float(x_s[k * LDX + col]);
    };
    if (tj < ti) {
      // Below the diagonal every i > ref = j0 + 63 >= j, so the decay
      // factors as exp(cum_i - cum_ref) exp(cum_ref - cum_j), both <= 1:
      // u_i, and w_j = exp(cum_ref - cum_j) dt_j, each from an f64
      // difference; rows past the chunk weigh 0.
      const double ref = cum_s[j0 + kTile - 1];
      const int lane_row = i0 + wr + (lane & 15);
      __syncwarp();  // the warp's lanes are done with the last tile's factors
      if (lane < 16)
        u_s[lane] = lane_row < chunk ? expf((float)(cum_s[lane_row] - ref))
                                     : 0.f;
      w_s[lane] = expf((float)(ref - cum_s[j0 + lane])) * dt_s[j0 + lane];
      w_s[lane + 32] =
          expf((float)(ref - cum_s[j0 + lane + 32])) * dt_s[j0 + lane + 32];
      __syncwarp();
      tc::warp_mma3<P / 8>(
          acc, kTile,
          [&](int r, int k) {
            return g_s[(wr + r) * LDG + k] * u_s[r] * w_s[k];
          },
          x_at);
    } else {
      // the diagonal tile: each weight from its own f64 difference; keys
      // past the warp's last row are all masked
      tc::warp_mma3<P / 8>(
          acc, wr + 16,
          [&](int r, int k) {
            const int i = i0 + wr + r;
            const int j = j0 + k;
            return j <= i && i < chunk
                       ? g_s[(wr + r) * LDG + k] *
                             expf((float)(cum_s[i] - cum_s[j])) * dt_s[j]
                       : 0.f;
          },
          x_at);
    }
  }

  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr + g + 8 * half;
    if (r < rows) {
      float* out = y + ((t0 + i0 + r) * h + head) * P;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt)
        *reinterpret_cast<float2*>(out + 8 * nt + 2 * t) = make_float2(
            acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* h0, void* y,
                   void* final_state, void* cum, void* G, void* S, int b,
                   int s, int h, int n, int chunk, cudaStream_t stream) {
  const int nc = s / chunk;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const float* dtf = static_cast<const float*>(dt);
  double* cumd = static_cast<double*>(cum);
  float* Gf = static_cast<float*>(G);
  float* Sf = static_cast<float*>(S);
  cudaError_t err;

  const size_t smem1 = scores_smem<T>(n);
  if ((err = allow_smem(ssd_scores_kernel<T>, smem1)) != cudaSuccess)
    return err;
  const int tiles = (chunk + kTile - 1) / kTile;
  ssd_scores_kernel<T>
      <<<dim3(nc * tiles * (tiles + 1) / 2, b), 256, smem1, stream>>>(
      dtf, static_cast<const float*>(A), Bt, Ct, cumd, Gf, s, h, n, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem2 = states_smem<T, P>(n);
  if ((err = allow_smem(ssd_states_kernel<T, P>, smem2)) != cudaSuccess)
    return err;
  const int ntn = (n + kTile - 1) / kTile;
  ssd_states_kernel<T, P><<<dim3(nc * ntn, h, b), 128, smem2, stream>>>(
      xt, dtf, Bt, cumd, Sf, s, h, n, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_pass_kernel<<<dim3((n * P + 255) / 256, h, b), 256, 0, stream>>>(
      cumd, static_cast<const float*>(h0), Sf,
      static_cast<float*>(final_state), s, h, n * P, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem4 = output_smem<T, P>(n);
  if ((err = allow_smem(ssd_output_kernel<T, P>, smem4)) != cudaSuccess)
    return err;
  const int row_tiles = (chunk + kTile - 1) / kTile;
  ssd_output_kernel<T, P><<<dim3(nc * row_tiles, h, b), 128, smem4, stream>>>(
      xt, dtf, Ct, cumd, Gf, Sf, static_cast<float*>(y), s, h, n, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* h0,
                              void* y, void* final_state, void* cum, void* G,
                              void* S, int b, int s, int h, int p, int n,
                              int chunk, cudaStream_t stream) {
  switch (p) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, h0, y, final_state, cum, G, S, b,
                           s, h, n, chunk, stream);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, h0, y, final_state, cum, G, S, b,
                           s, h, n, chunk, stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, h0, y, final_state, cum, G, S, b,
                           s, h, n, chunk, stream);
    case 128:
      return launch<T, 128>(x, dt, A, Bm, Cm, h0, y, final_state, cum, G, S,
                            b, s, h, n, chunk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of x, B and C: 0 = float32, 1 = bfloat16.  h0 may be null (a zero
// initial state).  cum (b, s, h) f64, G (b, s / chunk, chunk, chunk) f32
// and S (b, s / chunk, h, n, p) f32 are scratch that the call overwrites
// before it reads.  Launches four kernels on `stream`; returns the first
// launch error.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* h0,
                              void* y, void* final_state, void* cum, void* G,
                              void* S, int b, int s, int h, int p, int n,
                              int chunk, int dtype, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || s < 1 || n < 1 ||
      n > kMaxState || chunk < 1 || chunk > kMaxChunk || s % chunk != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(x, dt, A, Bm, Cm, h0, y, final_state, cum,
                                    G, S, b, s, h, p, n, chunk, st);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y,
                                            final_state, cum, G, S, b, s, h,
                                            p, n, chunk, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
