// The Mamba2 SSD chunk scan's backward for Hopper (sm_90a), on tensor
// cores.
//
// The backward of the forward kernel in ssd_scan.cu, which replaces the
// Pallas TPU kernel `_ssd_kernel` / `ssd_scan` in
// src/repro/kernels/ssd_scan.py; the JAX package differentiates the plain
// `models/ssm.py::ssd_chunked`, whose gradients these are.  Per batch row
// and head, in each chunk of Q steps, with the forward's notation (a_t =
// dt_t A, cum its inclusive sum in the chunk, G = C.B^T, S the state
// entering the chunk), f_ij = exp(cum_i - cum_j) dt_j for j <= i, W = G o f
// and w_j = exp(cum_Q - cum_j) dt_j; given dy and the gradient dS' of the
// state leaving each chunk (grad_final for the last):
//
//   dS     = exp(cum_Q) dS' + sum_i exp(cum_i) C_i dy_i^T   (dh0: chunk 0's)
//   dx_j   = sum_{i>=j} W_ij dy_i + w_j dS'^T B_j
//   dG_ij  = (dy_i . x_j) f_ij
//   dC_i   = sum_j dG_ij B_j + exp(cum_i) S dy_i       (summed over heads)
//   dB_j   = sum_i dG_ij C_i + w_j dS' x_j             (summed over heads)
//
// and dt, A through d.cum: with E_ij = (dy_i . x_j) G_ij exp(cum_i -
// cum_j) and R_ij = E_ij dt_j, d.cum_i gets sum_j R_ij - sum_i' R_i'i,
// the entering state's dy_i . (exp(cum_i) S^T C_i), and -T_i, T_j = dt_j
// V_j, V_j = exp(cum_Q - cum_j) B_j . (dS' x_j); d.cum_Q also gets
// sum_j T_j + exp(cum_Q) <S, dS'>.  d.a is d.cum's reverse cumulative sum
// in the chunk, ddt_t = sum_i E_it + V_t + A d.a_t, and dA = sum over
// (b, s) of dt_t d.a_t.  Mamba2's chunked SSD backward (arXiv:2405.21060
// section 7), split as its reference implementation splits it: chunk
// scan, chunk state, state passing and cumulative sums backwards.
//
// The forward's numerics are kept: every decay from a difference <= 0 of
// the f64 cumulative sums (off-diagonal tiles factored as the forward
// does, u_i w_j with both factors <= 1), products in three TF32 passes
// with f32 accumulation (tf32_mma.cuh).  Reused from the forward, which
// the autograd Function keeps: the f64 sums `cum`, the scores `G` and the
// states entering each chunk (the state-passing launch writes them over
// the chunk states; the output launch only reads them).
//
// Layouts: x, B, C and their grads in x's type (f32 or bf16), dy (b, s, h,
// p) f32, the rest as the forward's.  All contiguous.
//
// What bounds it: operations (Q^2 p products per head and chunk, as in the
// forward).  Six launches in order on one stream, no atomics, every sum in
// a fixed order, so the gradients are deterministic:
//   1. local states, grid (chunk x n-tile, h, b): L_c = sum_i exp(cum_i)
//      C_i dy_i^T, all chunks in parallel;
//   2. state passing backwards, grid (n p / 1024, h, b): dS' of every
//      chunk from grad_final, over L_c, dh0, and each block's part of
//      <S, dS'> per chunk;
//   3. rows, grid (row tile x chunk, h, b): for 64 rows i, the entering
//      state's product S dy_i and its d.cum term, then over the column
//      tiles j <= i: dW = dy x^T, dG and sum_j R_ij in registers, and
//      dC_i += dG B (dG as the register A operand): per-head dC;
//   4. columns, grid (column tile x chunk, h, b): for 64 columns j, the
//      state terms (dx += w_j B_j dS', dB = w_j dS' x_j and V_j), then over
//      the row tiles i >= j: dW^T = x dy^T, dG^T, sum_i E_ij, and dB_j +=
//      dG^T C, dx_j += W^T dy (W^T rebuilt in registers): dx, per-head dB;
//   5. dt, one thread a (batch row, chunk, head): d.cum, its reverse sum
//      in f64, ddt, and dt . d.a per chunk;
//   6. sums over heads (dB, dC) and over (b, chunk) (dA), in order.
// Tiles are staged in shared memory by 16-byte cp.async; bf16 x, B and C
// are widened to f32 as fragments are loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kTile = 64;       // rows per tile of a chunk
constexpr int kMaxChunk = 256;
constexpr int kMaxState = 128;  // n
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared-memory row lengths, in elements, that keep rows 16-byte aligned
// and the fragment loads free of bank conflicts: `row_pad` for tiles read
// along their rows (an A operand, or a B operand read as B[k][n] = X[n][k])
// and for tiles whose B rows are read in the fragment order 2t, 2t + 1
// (frag_mma3); `col_pad` for tiles read down their columns in the order t,
// t + 4 (warp_mma3's B[k][n] = X[k][n]).
template <typename T>
__host__ __device__ constexpr int row_pad(int cols) {
  return cols + (sizeof(T) == 4 ? 4 : 8);
}
__host__ __device__ constexpr int col_pad(int cols) { return cols + 8; }

template <typename T>
__device__ __forceinline__ bool whole_chunks(int cols) {
  return cols % (16 / (int)sizeof(T)) == 0;
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

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The states' width in the products whose output columns run over n: 64
// or 128 (compile time; columns past n are zeros).
__host__ __device__ constexpr int state_width(int n) {
  return n <= 64 ? 64 : 128;
}

// ----------------------------------------------------------- 1. local dS
template <typename T, int P>
__host__ __device__ constexpr size_t local_smem(int n) {
  return kMaxChunk * sizeof(float) +
         2 * (size_t)kTile *
             (col_pad(round_up(n < kTile ? n : kTile, 16)) * sizeof(T) +
              col_pad(P) * sizeof(float));
}

template <typename T, int P>
__global__ void __launch_bounds__(128)
    ssd_bwd_local_kernel(const float* __restrict__ dy,
                         const T* __restrict__ Cm,
                         const double* __restrict__ cum,
                         float* __restrict__ dS, int s, int h, int n,
                         int chunk) {
  constexpr int LDY = col_pad(P);
  const int ntn = (n + kTile - 1) / kTile;
  const int c = blockIdx.x / ntn;
  const int n0 = (blockIdx.x - c * ntn) * kTile;
  const int nc = gridDim.x / ntn;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nn = min(kTile, n - n0);
  const int nnp = round_up(nn, 16);
  const int ldc = col_pad(nnp);
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* u_s = reinterpret_cast<float*>(smem_raw);  // kMaxChunk
  unsigned char* ring = smem_raw + kMaxChunk * sizeof(float);
  const size_t c_len = (size_t)kTile * ldc * sizeof(T);
  const size_t stage_len = c_len + (size_t)kTile * LDY * sizeof(float);

  // u_i = exp(cum_i) <= 1, 0 past the chunk
  for (int i = threadIdx.x; i < kMaxChunk; i += blockDim.x)
    u_s[i] = i < chunk ? expf((float)cum[(t0 + i) * h + head]) : 0.f;

  const T* C0 = Cm + t0 * n + n0;
  const float* y0 = dy + t0 * h * P + (size_t)head * P;
  const bool c_vec = tc::aligned16(C0, n) && whole_chunks<T>(nn);
  const bool y_vec = tc::aligned16(y0, (long long)h * P);
  const int tiles = (chunk + kTile - 1) / kTile;
  auto stage = [&](int it) {
    const int i0 = it * kTile;
    const int rows = min(kTile, chunk - i0);
    unsigned char* buf = ring + (it & 1) * stage_len;
    tc::stage(reinterpret_cast<T*>(buf), ldc, C0 + (size_t)i0 * n, n, rows,
              kTile, nn, nnp, c_vec);
    tc::stage(reinterpret_cast<float*>(buf + c_len), LDY,
              y0 + (size_t)i0 * h * P, (long long)h * P, rows, kTile, P, P,
              y_vec);
    tc::cp_async_commit();
  };

  // warp w: state rows n0 + wr .. + 16, all P columns
  const int wr = 16 * warp;
  float acc[P / 8][4] = {};
  stage(0);
  for (int it = 0; it < tiles; ++it) {
    tc::cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < tiles) stage(it + 1);
    if (wr < nn) {
      const unsigned char* buf = ring + (it & 1) * stage_len;
      const T* c_s = reinterpret_cast<const T*>(buf);
      const float* y_s = reinterpret_cast<const float*>(buf + c_len);
      const float* u = u_s + it * kTile;
      tc::warp_mma3<P / 8>(
          acc, kTile,
          [&](int r, int k) { return tc::to_float(c_s[k * ldc + wr + r]); },
          [&](int k, int col) { return y_s[k * LDY + col] * u[k]; });
    }
  }

  float* L = dS + (((size_t)row * nc + c) * h + head) * n * P;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr + g + 8 * half;
    if (r < nn) {
      float* out = L + (size_t)(n0 + r) * P;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        out[8 * nt + 2 * t] = acc[nt][2 * half];
        out[8 * nt + 2 * t + 1] = acc[nt][2 * half + 1];
      }
    }
  }
}

// -------------------------------------------- 2. state passing backwards
// A block takes kPassSpan elements of one (batch row, head)'s state, and
// writes its part of <S, dS'> per chunk; the dt kernel sums the parts in
// order.
constexpr int kPassThreads = 256;
constexpr int kPassPer = 4;
constexpr int kPassSpan = kPassThreads * kPassPer;

__host__ __device__ constexpr int pass_blocks(int np) {
  return (np + kPassSpan - 1) / kPassSpan;
}

__global__ void __launch_bounds__(kPassThreads)
    ssd_bwd_pass_kernel(const double* __restrict__ cum,
                        const float* __restrict__ S_in,
                        const float* __restrict__ grad_final,
                        float* __restrict__ dS, float* __restrict__ dh0,
                        float* __restrict__ inner, int s, int h, int np,
                        int chunk, int nc) {
  const int blk = blockIdx.x;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int tid = threadIdx.x;
  const int base = blk * kPassSpan;
  __shared__ float warp_sums[kPassThreads / 32];
  float state[kPassPer];
  const size_t off0 = ((size_t)row * h + head) * np;
#pragma unroll
  for (int u = 0; u < kPassPer; ++u) {
    const int idx = base + tid + u * kPassThreads;
    state[u] = idx < np ? grad_final[off0 + idx] : 0.f;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const float decay = expf((float)cum[((size_t)row * s + (size_t)c * chunk +
                                         chunk - 1) * h + head]);
    const size_t off = (((size_t)row * nc + c) * h + head) * np;
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < kPassPer; ++u) {
      const int idx = base + tid + u * kPassThreads;
      if (idx < np) {
        const float local = dS[off + idx];
        dS[off + idx] = state[u];  // dS' of chunk c
        part += S_in[off + idx] * state[u];
        state[u] = decay * state[u] + local;
      }
    }
    // <S, dS'> over the block, in a fixed order
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, m);
    if ((tid & 31) == 0) warp_sums[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int w = 0; w < kPassThreads / 32; ++w) sum += warp_sums[w];
      inner[(((size_t)row * nc + c) * h + head) * gridDim.x + blk] = sum;
    }
    __syncthreads();
  }
  if (dh0 != nullptr) {
#pragma unroll
    for (int u = 0; u < kPassPer; ++u) {
      const int idx = base + tid + u * kPassThreads;
      if (idx < np) dh0[off0 + idx] = state[u];
    }
  }
}

// Shared head of kernels 3 and 4: the chunk's f64 sums and dt, 64 floats
// (the rows' exp(cum_i) in 3, an off-diagonal tile's u_i in 4), and each
// warp's factors of an off-diagonal tile (u: 16 rows, w: 64 columns).
constexpr size_t kHead =
    kMaxChunk * (sizeof(double) + sizeof(float)) +
    (kTile + 4 * (16 + kTile)) * sizeof(float);

// ------------------------------------------------------------- 3. rows
// Shared memory after the head: dy and C for the block's rows, then the
// space the entering state takes once and then each column tile's x, B
// and G.
template <typename T, int P, int NB>
__host__ __device__ constexpr size_t rows_once() {
  return (size_t)NB * row_pad<float>(P) * sizeof(float);
}
template <typename T, int P, int NB>
__host__ __device__ constexpr size_t rows_loop() {
  return (size_t)kTile * (row_pad<T>(P) * sizeof(T) +
                          row_pad<T>(NB) * sizeof(T) +
                          row_pad<float>(kTile) * sizeof(float));
}
template <typename T, int P, int NB>
__host__ __device__ constexpr size_t rows_smem() {
  return kHead +
         (size_t)kTile * (row_pad<float>(P) * sizeof(float) +
                          row_pad<T>(NB) * sizeof(T)) +
         (rows_once<T, P, NB>() > rows_loop<T, P, NB>()
              ? rows_once<T, P, NB>()
              : rows_loop<T, P, NB>());
}

template <typename T, int P, int NB>
__global__ void __launch_bounds__(128)
    ssd_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const T* __restrict__ Bm, const T* __restrict__ Cm,
                        const double* __restrict__ cum,
                        const float* __restrict__ G,
                        const float* __restrict__ S_in,
                        const float* __restrict__ dy,
                        float* __restrict__ dC_part,
                        float* __restrict__ row_terms, int b, int s, int h,
                        int n, int chunk) {
  constexpr int LDY = row_pad<float>(P);
  constexpr int LDX = row_pad<T>(P);
  constexpr int LDN = row_pad<T>(NB);
  constexpr int LDS = row_pad<float>(P);
  constexpr int LDG = row_pad<float>(kTile);
  const int n_row_tiles = (chunk + kTile - 1) / kTile;
  const int c = blockIdx.x / n_row_tiles;
  const int ti = n_row_tiles - 1 - (blockIdx.x - c * n_row_tiles);
  const int nc = gridDim.x / n_row_tiles;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int i0 = ti * kTile;
  const int rows = min(kTile, chunk - i0);
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;
  const int wr = 16 * warp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum_s = reinterpret_cast<double*>(smem_raw);  // kMaxChunk
  float* dt_s = reinterpret_cast<float*>(cum_s + kMaxChunk);
  float* dec_s = dt_s + kMaxChunk;  // kTile: exp(cum_i) of the block's rows
  float* u_s = dec_s + kTile + warp * (16 + kTile);
  float* w_s = u_s + 16;
  float* dy_s = reinterpret_cast<float*>(smem_raw + kHead);  // kTile x LDY
  T* c_s = reinterpret_cast<T*>(dy_s + kTile * LDY);           // kTile x LDN
  unsigned char* space = reinterpret_cast<unsigned char*>(c_s + kTile * LDN);
  float* st_s = reinterpret_cast<float*>(space);  // NB x LDS, once
  T* x_s = reinterpret_cast<T*>(space);           // kTile x LDX, a tile
  T* b_s = x_s + kTile * LDX;                     // kTile x LDN
  float* g_s = reinterpret_cast<float*>(b_s + kTile * LDN);  // kTile x LDG

  const float* y0 = dy + (t0 + i0) * h * P + (size_t)head * P;
  const T* C0 = Cm + (t0 + i0) * n;
  const float* st = S_in + (((size_t)row * nc + c) * h + head) * n * P;
  const bool y_vec = tc::aligned16(y0, (long long)h * P);
  const bool c_vec = tc::aligned16(C0, n) && whole_chunks<T>(n);
  tc::stage(dy_s, LDY, y0, (long long)h * P, rows, kTile, P, P, y_vec);
  tc::stage(c_s, LDN, C0, n, rows, kTile, n, NB, c_vec);
  tc::stage(st_s, LDS, st, P, n, NB, P, P, tc::aligned16(st, P));
  tc::cp_async_commit();
  for (int j = threadIdx.x; j < min(chunk, i0 + kTile); j += blockDim.x) {
    cum_s[j] = cum[(t0 + j) * h + head];
    dt_s[j] = dt[(t0 + j) * h + head];
  }
  for (int r = threadIdx.x; r < kTile; r += blockDim.x)
    dec_s[r] = r < rows ? expf((float)cum[(t0 + i0 + r) * h + head]) : 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();

  // the entering state: acc = (exp(cum_i) dy_i) S^T, and its d.cum term
  // dy_i . (exp(cum_i) S^T C_i) = C_i . acc_i
  float acc[NB / 8][4] = {};
  tc::warp_mma3<NB / 8>(
      acc, P,
      [&](int r, int k) { return dy_s[(wr + r) * LDY + k] * dec_s[wr + r]; },
      [&](int k, int col) { return st_s[col * LDS + k]; });
  float ent0 = 0.f, ent1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NB / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wr + g + (e < 2 ? 0 : 8);
      const float v =
          acc[nt][e] * tc::to_float(c_s[r * LDN + 8 * nt + 2 * t + (e & 1)]);
      if (e < 2)
        ent0 += v;
      else
        ent1 += v;
    }
  ent0 = quad_sum(ent0);
  ent1 = quad_sum(ent1);

  // over the column tiles j <= i: dW = dy x^T, then dG and R's row sums,
  // and dC += dG B
  const T* x0 = x + t0 * h * P + (size_t)head * P;
  const T* B0 = Bm + t0 * n;
  const float* G_c = G + ((size_t)row * nc + c) * chunk * chunk +
                     (size_t)i0 * chunk;
  const bool x_vec = tc::aligned16(x0, (long long)h * P);
  const bool b_vec = tc::aligned16(B0, n) && whole_chunks<T>(n);
  const bool g_vec = tc::aligned16(G_c, chunk) && chunk % 4 == 0;
  float rsum0 = 0.f, rsum1 = 0.f;
  for (int tj = 0; tj <= ti; ++tj) {
    __syncthreads();  // every warp is done with the space (state or tile)
    const int j0 = tj * kTile;
    const int cols = min(kTile, chunk - j0);
    tc::stage(x_s, LDX, x0 + (size_t)j0 * h * P, (long long)h * P, cols,
              kTile, P, P, x_vec);
    tc::stage(b_s, LDN, B0 + (size_t)j0 * n, n, cols, kTile, n, NB, b_vec);
    tc::stage(g_s, LDG, G_c + j0, chunk, rows, kTile, cols, kTile, g_vec);
    tc::cp_async_commit();
    if (tj < ti) {
      // below the diagonal every i > ref = j0 + 63 >= j: exp(cum_i -
      // cum_j) = u_i w_j, both <= 1 (rows past the chunk weigh 0)
      const double ref = cum_s[j0 + kTile - 1];
      const int lane_row = i0 + wr + (lane & 15);
      if (lane < 16)
        u_s[lane] = lane_row < chunk ? expf((float)(cum_s[lane_row] - ref))
                                     : 0.f;
      w_s[lane] = expf((float)(ref - cum_s[j0 + lane]));
      w_s[lane + 32] = expf((float)(ref - cum_s[j0 + lane + 32]));
    }
    tc::cp_async_wait<0>();
    __syncthreads();

    float dw[kTile / 8][4] = {};
    tc::warp_mma3<kTile / 8>(
        dw, P,
        [&](int r, int k) { return dy_s[(wr + r) * LDY + k]; },
        [&](int k, int col) { return tc::to_float(x_s[col * LDX + k]); });
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = wr + g + (e < 2 ? 0 : 8);  // row in the tile
        const int jl = 8 * nt + 2 * t + (e & 1);  // column in the tile
        const int i = i0 + rl;
        const int j = j0 + jl;
        float ex;
        if (tj < ti)
          ex = u_s[rl - wr] * w_s[jl];
        else
          ex = j <= i && i < chunk ? expf((float)(cum_s[i] - cum_s[j]))
                                   : 0.f;
        const float d = j < chunk ? dt_s[j] : 0.f;
        const float r = dw[nt][e] * g_s[rl * LDG + jl] * ex * d;  // R_ij
        if (e < 2)
          rsum0 += r;
        else
          rsum1 += r;
        dw[nt][e] *= ex * d;  // dG_ij
      }
    tc::frag_mma3<NB / 8, kTile / 8>(acc, dw, [&](int k, int col) {
      return tc::to_float(b_s[k * LDN + col]);
    });
  }
  rsum0 = quad_sum(rsum0);
  rsum1 = quad_sum(rsum1);

  // per-head dC, and the rows' terms R's row sum and the entering state's
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = wr + g + 8 * half;
    if (rl < rows) {
      const size_t at = (t0 + i0 + rl) * h + head;
      float* out = dC_part + at * n;
#pragma unroll
      for (int nt = 0; nt < NB / 8; ++nt) {
        const int col = 8 * nt + 2 * t;
        if (col < n) out[col] = acc[nt][2 * half];
        if (col + 1 < n) out[col + 1] = acc[nt][2 * half + 1];
      }
      if (t == 0) {
        const size_t plane = (size_t)b * s * h;
        row_terms[at] = half ? rsum1 : rsum0;
        row_terms[plane + at] = half ? ent1 : ent0;
      }
    }
  }
}

// ---------------------------------------------------------- 4. columns
// Shared memory after the head and exp(cum_Q - cum_j) of the block's
// columns: x for the block's columns, then the space that B and dS' take
// once and then each row tile's dy, C and G.
template <typename T, int P, int NB>
__host__ __device__ constexpr size_t cols_once() {
  return (size_t)kTile * row_pad<T>(NB) * sizeof(T) +
         (size_t)NB * row_pad<float>(P) * sizeof(float);
}
template <typename T, int P, int NB>
__host__ __device__ constexpr size_t cols_loop() {
  return (size_t)kTile * (row_pad<float>(P) * sizeof(float) +
                          row_pad<T>(NB) * sizeof(T) +
                          row_pad<float>(kTile) * sizeof(float));
}
template <typename T, int P, int NB>
__host__ __device__ constexpr size_t cols_smem() {
  return kHead + kTile * sizeof(float) +
         (size_t)kTile * row_pad<T>(P) * sizeof(T) +
         (cols_once<T, P, NB>() > cols_loop<T, P, NB>()
              ? cols_once<T, P, NB>()
              : cols_loop<T, P, NB>());
}

template <typename T, int P, int NB>
__global__ void __launch_bounds__(128)
    ssd_bwd_cols_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const T* __restrict__ Bm, const T* __restrict__ Cm,
                        const double* __restrict__ cum,
                        const float* __restrict__ G,
                        const float* __restrict__ dS,
                        const float* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ dB_part,
                        float* __restrict__ col_terms, int b, int s, int h,
                        int n, int chunk) {
  constexpr int LDY = row_pad<float>(P);
  constexpr int LDX = row_pad<T>(P);
  constexpr int LDN = row_pad<T>(NB);
  constexpr int LDD = row_pad<float>(P);
  constexpr int LDG = row_pad<float>(kTile);
  const int n_tiles = (chunk + kTile - 1) / kTile;
  const int c = blockIdx.x / n_tiles;
  const int tj = blockIdx.x - c * n_tiles;  // the lightest column tiles last
  const int nc = gridDim.x / n_tiles;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int j0 = tj * kTile;
  const int cols = min(kTile, chunk - j0);
  const int np = round_up(n, 8);
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;
  const int wr = 16 * warp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum_s = reinterpret_cast<double*>(smem_raw);  // kMaxChunk
  float* dt_s = reinterpret_cast<float*>(cum_s + kMaxChunk);
  // u_i of an off-diagonal row tile, and this warp's copy of the w_j
  float* u_s = dt_s + kMaxChunk;  // kTile
  float* w_s = u_s + kTile + warp * (16 + kTile) + 16;
  float* end_s = reinterpret_cast<float*>(smem_raw + kHead);  // kTile
  T* x_s = reinterpret_cast<T*>(end_s + kTile);               // kTile x LDX
  unsigned char* space = reinterpret_cast<unsigned char*>(x_s + kTile * LDX);
  T* b_s = reinterpret_cast<T*>(space);                      // once
  float* ds_s = reinterpret_cast<float*>(b_s + kTile * LDN);  // NB x LDD
  float* dy_s = reinterpret_cast<float*>(space);             // a tile
  T* c_s = reinterpret_cast<T*>(dy_s + kTile * LDY);          // kTile x LDN
  float* g_s = reinterpret_cast<float*>(c_s + kTile * LDN);   // kTile x LDG

  const T* x0 = x + (t0 + j0) * h * P + (size_t)head * P;
  const T* B0 = Bm + (t0 + j0) * n;
  const float* dsp = dS + (((size_t)row * nc + c) * h + head) * n * P;
  const bool x_vec = tc::aligned16(x0, (long long)h * P);
  const bool b_vec = tc::aligned16(B0, n) && whole_chunks<T>(n);
  tc::stage(x_s, LDX, x0, (long long)h * P, cols, kTile, P, P, x_vec);
  tc::stage(b_s, LDN, B0, n, cols, kTile, n, NB, b_vec);
  tc::stage(ds_s, LDD, dsp, P, n, NB, P, P, tc::aligned16(dsp, P));
  tc::cp_async_commit();
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    cum_s[i] = cum[(t0 + i) * h + head];
    dt_s[i] = dt[(t0 + i) * h + head];
  }
  __syncthreads();
  const double last = cum_s[chunk - 1];
  for (int r = threadIdx.x; r < kTile; r += blockDim.x)
    end_s[r] = r < cols ? expf((float)(last - cum_s[j0 + r])) : 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();

  // the state terms first.  dB: acc_b = (exp(cum_Q - cum_j) x_j) dS'^T,
  // V_j = B_j . acc_b_j, then times dt_j
  float acc_b[NB / 8][4] = {};
  tc::warp_mma3<NB / 8>(
      acc_b, P,
      [&](int r, int k) {
        return tc::to_float(x_s[(wr + r) * LDX + k]) * end_s[wr + r];
      },
      [&](int k, int col) { return ds_s[col * LDD + k]; });
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NB / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wr + g + (e < 2 ? 0 : 8);
      const float v =
          acc_b[nt][e] * tc::to_float(b_s[r * LDN + 8 * nt + 2 * t + (e & 1)]);
      if (e < 2)
        v0 += v;
      else
        v1 += v;
    }
  v0 = quad_sum(v0);
  v1 = quad_sum(v1);
  const int ja = wr + g, jb = ja + 8;  // this thread's columns in the tile
  const float dt_a = ja < cols ? dt_s[j0 + ja] : 0.f;
  const float dt_b = jb < cols ? dt_s[j0 + jb] : 0.f;
#pragma unroll
  for (int nt = 0; nt < NB / 8; ++nt) {
    acc_b[nt][0] *= dt_a;
    acc_b[nt][1] *= dt_a;
    acc_b[nt][2] *= dt_b;
    acc_b[nt][3] *= dt_b;
  }
  // dx: acc_x = (w_j B_j) dS'
  float acc_x[P / 8][4] = {};
  tc::warp_mma3<P / 8>(
      acc_x, np,
      [&](int r, int k) {
        const int j = wr + r;
        return tc::to_float(b_s[j * LDN + k]) * end_s[j] *
               (j < cols ? dt_s[j0 + j] : 0.f);
      },
      [&](int k, int col) { return ds_s[k * LDD + col]; });

  // over the row tiles i >= j: dW^T = x dy^T, E's column sums, dB += dG^T
  // C, then dx += W^T dy
  const float* y_base = dy + t0 * h * P + (size_t)head * P;
  const T* C_base = Cm + t0 * n;
  const bool y_vec = tc::aligned16(y_base, (long long)h * P);
  const bool c_vec = tc::aligned16(C_base, n) && whole_chunks<T>(n);
  const float* G_c = G + ((size_t)row * nc + c) * chunk * chunk + j0;
  const bool g_vec = tc::aligned16(G_c, chunk) && chunk % 4 == 0;
  const double ref = cum_s[min(j0 + kTile, chunk) - 1];
  if (cols == kTile) {
    // below the diagonal every i > ref = j0 + 63 >= j: exp(cum_i - cum_j)
    // = exp(cum_i - ref) w_j, w_j = exp(ref - cum_j) <= 1 fixed for the
    // block (each warp keeps its own copy)
    w_s[lane] = expf((float)(ref - cum_s[j0 + lane]));
    w_s[lane + 32] = expf((float)(ref - cum_s[j0 + lane + 32]));
  }
  float esum0 = 0.f, esum1 = 0.f;
  for (int ti = tj; ti < n_tiles; ++ti) {
    __syncthreads();  // every warp is done with the space
    const int i0 = ti * kTile;
    const int rows = min(kTile, chunk - i0);
    tc::stage(dy_s, LDY, y_base + (size_t)i0 * h * P, (long long)h * P, rows,
              kTile, P, P, y_vec);
    tc::stage(c_s, LDN, C_base + (size_t)i0 * n, n, rows, kTile, n, NB,
              c_vec);
    tc::stage(g_s, LDG, G_c + (size_t)i0 * chunk, chunk, rows, kTile, cols,
              kTile, g_vec);
    tc::cp_async_commit();
    if (ti > tj)  // u_i = exp(cum_i - ref) <= 1, 0 past the chunk
      for (int r = threadIdx.x; r < kTile; r += blockDim.x)
        u_s[r] = r < rows ? expf((float)(cum_s[i0 + r] - ref)) : 0.f;
    tc::cp_async_wait<0>();
    __syncthreads();

    float dwt[kTile / 8][4] = {};
    tc::warp_mma3<kTile / 8>(
        dwt, P,
        [&](int r, int k) { return tc::to_float(x_s[(wr + r) * LDX + k]); },
        [&](int k, int col) { return dy_s[col * LDY + k]; });
    // element (row j, column i) of the transposed tile: W^T = G o f,
    // dG^T = dW^T o f, E = dW^T G exp(cum_i - cum_j)
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = wr + g + (e < 2 ? 0 : 8);
        const int il = 8 * nt + 2 * t + (e & 1);
        const int i = i0 + il;
        const int j = j0 + jl;
        float ex;
        if (ti > tj)
          ex = u_s[il] * w_s[jl];
        else
          ex = j <= i && i < chunk ? expf((float)(cum_s[i] - cum_s[j]))
                                   : 0.f;
        const float gv = g_s[il * LDG + jl];
        const float d = j < chunk ? dt_s[j] : 0.f;
        const float ev = dwt[nt][e] * gv * ex;
        if (e < 2)
          esum0 += ev;
        else
          esum1 += ev;
        dwt[nt][e] *= ex * d;  // dG^T
      }
    tc::frag_mma3<NB / 8, kTile / 8>(acc_b, dwt, [&](int k, int col) {
      return tc::to_float(c_s[k * LDN + col]);
    });
    // W^T = G o f, rebuilt in the same registers
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = wr + g + (e < 2 ? 0 : 8);
        const int il = 8 * nt + 2 * t + (e & 1);
        const int i = i0 + il;
        const int j = j0 + jl;
        float ex;
        if (ti > tj)
          ex = u_s[il] * w_s[jl];
        else
          ex = j <= i && i < chunk ? expf((float)(cum_s[i] - cum_s[j]))
                                   : 0.f;
        const float d = j < chunk ? dt_s[j] : 0.f;
        dwt[nt][e] = g_s[il * LDG + jl] * ex * d;
      }
    tc::frag_mma3<P / 8, kTile / 8>(acc_x, dwt, [&](int k, int col) {
      return dy_s[k * LDY + col];
    });
  }
  esum0 = quad_sum(esum0);
  esum1 = quad_sum(esum1);

  const size_t plane = (size_t)b * s * h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int jl = wr + g + 8 * half;
    if (jl < cols) {
      const size_t at = (t0 + j0 + jl) * h + head;
      T* out = dx + at * P;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        out[8 * nt + 2 * t] = from_float<T>(acc_x[nt][2 * half]);
        out[8 * nt + 2 * t + 1] = from_float<T>(acc_x[nt][2 * half + 1]);
      }
      float* outb = dB_part + at * n;
#pragma unroll
      for (int nt = 0; nt < NB / 8; ++nt) {
        const int col = 8 * nt + 2 * t;
        if (col < n) outb[col] = acc_b[nt][2 * half];
        if (col + 1 < n) outb[col + 1] = acc_b[nt][2 * half + 1];
      }
      if (t == 0) {
        col_terms[at] = half ? esum1 : esum0;
        col_terms[plane + at] = half ? v1 : v0;
      }
    }
  }
}

// ---------------------------------------------------------------- 5. dt
// One thread a (batch row, chunk, head): d.cum from the rows' and columns'
// terms, its reverse sum in f64 within the chunk, ddt, and dt . d.a for
// dA.  terms: R's row sums, the entering state's, E's column sums, V.
__global__ void __launch_bounds__(128)
    ssd_bwd_dt_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const double* __restrict__ cum,
                      const float* __restrict__ inner,
                      const float* __restrict__ terms,
                      float* __restrict__ ddt, float* __restrict__ dA_part,
                      int b, int s, int h, int chunk, int nc, int parts) {
  const int hb = (h + blockDim.x - 1) / blockDim.x;
  const int c = blockIdx.x / hb;
  const int head = (blockIdx.x - c * hb) * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (head >= h) return;
  const size_t plane = (size_t)b * s * h;
  const float* row_sum = terms;
  const float* entering = terms + plane;
  const float* col_sum = terms + 2 * plane;
  const float* vv = terms + 3 * plane;
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;
  double tail = 0.0;
  for (int j = 0; j < chunk; ++j) {
    const size_t at = (t0 + j) * h + head;
    tail += (double)dt[at] * vv[at];
  }
  const size_t last = (t0 + chunk - 1) * h + head;
  const float* part_of = inner + (((size_t)row * nc + c) * h + head) * parts;
  float dot = 0.f;  // <S, dS'>, the pass kernel's parts in order
  for (int k = 0; k < parts; ++k) dot += part_of[k];
  tail += exp(cum[last]) * (double)dot;
  const double a = A[head];
  double da = 0.0, part = 0.0;
  for (int i = chunk - 1; i >= 0; --i) {
    const size_t at = (t0 + i) * h + head;
    const double d = dt[at];
    da += (double)row_sum[at] - d * col_sum[at] + entering[at] - d * vv[at] +
          (i == chunk - 1 ? tail : 0.0);
    ddt[at] = (float)((double)col_sum[at] + vv[at] + a * da);
    part += d * da;
  }
  dA_part[((size_t)row * nc + c) * h + head] = (float)part;
}

// ---------------------------------------------------------- 6. the sums
// dB, dC (b, s, n) = sums over heads of the per-head parts, in order;
// dA (h) = the sum over (b, chunk) of the parts, in order.
template <typename T>
__global__ void __launch_bounds__(256)
    ssd_bwd_sum_kernel(const float* __restrict__ dB_part,
                       const float* __restrict__ dC_part,
                       const float* __restrict__ dA_part, T* __restrict__ dB,
                       T* __restrict__ dC, float* __restrict__ dA,
                       long long bsn, int h, int n, int bnc) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < bsn) {
    const long long bs = idx / n;
    const int col = (int)(idx - bs * n);
    float sb = 0.f, sc = 0.f;
    for (int head = 0; head < h; ++head) {
      const long long at = (bs * h + head) * n + col;
      sb += dB_part[at];
      sc += dC_part[at];
    }
    dB[idx] = from_float<T>(sb);
    dC[idx] = from_float<T>(sc);
  } else if (idx < bsn + h) {
    const int head = (int)(idx - bsn);
    float sum = 0.f;
    for (int k = 0; k < bnc; ++k) sum += dA_part[(long long)k * h + head];
    dA[head] = sum;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *cum, *G, *S_in, *dy, *grad_final;
  void *dx, *ddt, *dA, *dB, *dC, *dh0;
  void *dS, *inner, *terms, *dB_part, *dC_part, *dA_part;
  int b, s, h, n, chunk;
};

template <typename T, int P, int NB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int nc = a.s / a.chunk;
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const float* dt = static_cast<const float*>(a.dt);
  const double* cum = static_cast<const double*>(a.cum);
  const float* dy = static_cast<const float*>(a.dy);
  float* dS = static_cast<float*>(a.dS);
  float* terms = static_cast<float*>(a.terms);
  const size_t plane = (size_t)a.b * a.s * a.h;
  const int tiles = (a.chunk + kTile - 1) / kTile;
  cudaError_t err;

  const size_t smem1 = local_smem<T, P>(a.n);
  if ((err = allow_smem(ssd_bwd_local_kernel<T, P>, smem1)) != cudaSuccess)
    return err;
  const int ntn = (a.n + kTile - 1) / kTile;
  ssd_bwd_local_kernel<T, P><<<dim3(nc * ntn, a.h, a.b), 128, smem1,
                               stream>>>(dy, Cm, cum, dS, a.s, a.h, a.n,
                                         a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int parts = pass_blocks(a.n * P);
  ssd_bwd_pass_kernel<<<dim3(parts, a.h, a.b), kPassThreads, 0, stream>>>(
      cum, static_cast<const float*>(a.S_in),
      static_cast<const float*>(a.grad_final), dS,
      static_cast<float*>(a.dh0), static_cast<float*>(a.inner), a.s, a.h,
      a.n * P, a.chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr size_t smem3 = rows_smem<T, P, NB>();
  static_assert(smem3 <= kMaxSmem, "ssd backward (rows): shared memory");
  if ((err = allow_smem(ssd_bwd_rows_kernel<T, P, NB>, smem3)) !=
      cudaSuccess)
    return err;
  ssd_bwd_rows_kernel<T, P, NB><<<dim3(nc * tiles, a.h, a.b), 128, smem3,
                                  stream>>>(
      x, dt, Bm, Cm, cum, static_cast<const float*>(a.G),
      static_cast<const float*>(a.S_in), dy,
      static_cast<float*>(a.dC_part), terms, a.b, a.s, a.h, a.n, a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr size_t smem4 = cols_smem<T, P, NB>();
  static_assert(smem4 <= kMaxSmem, "ssd backward (columns): shared memory");
  if ((err = allow_smem(ssd_bwd_cols_kernel<T, P, NB>, smem4)) !=
      cudaSuccess)
    return err;
  ssd_bwd_cols_kernel<T, P, NB><<<dim3(nc * tiles, a.h, a.b), 128, smem4,
                                  stream>>>(
      x, dt, Bm, Cm, cum, static_cast<const float*>(a.G), dS, dy,
      static_cast<T*>(a.dx), static_cast<float*>(a.dB_part),
      terms + 2 * plane, a.b, a.s, a.h, a.n, a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int hb = (a.h + 127) / 128;
  ssd_bwd_dt_kernel<<<dim3(nc * hb, a.b), 128, 0, stream>>>(
      dt, static_cast<const float*>(a.A), cum,
      static_cast<const float*>(a.inner), terms, static_cast<float*>(a.ddt),
      static_cast<float*>(a.dA_part), a.b, a.s, a.h, a.chunk, nc, parts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long bsn = (long long)a.b * a.s * a.n;
  const long long blocks = (bsn + a.h + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_bwd_sum_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(a.dB_part),
      static_cast<const float*>(a.dC_part),
      static_cast<const float*>(a.dA_part), static_cast<T*>(a.dB),
      static_cast<T*>(a.dC), static_cast<float*>(a.dA), bsn, a.h, a.n,
      a.b * nc);
  return cudaGetLastError();
}

template <typename T, int NB>
cudaError_t dispatch_head_dim(const Args& a, int p, cudaStream_t stream) {
  switch (p) {
    case 16: return launch<T, 16, NB>(a, stream);
    case 32: return launch<T, 32, NB>(a, stream);
    case 64: return launch<T, 64, NB>(a, stream);
    case 128: return launch<T, 128, NB>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const Args& a, int p, cudaStream_t stream) {
  return state_width(a.n) == 64 ? dispatch_head_dim<T, 64>(a, p, stream)
                                : dispatch_head_dim<T, 128>(a, p, stream);
}

}  // namespace

// dtype of x, B, C and their grads: 0 = float32, 1 = bfloat16.  cum (b, s,
// h) f64, G (b, s / chunk, chunk, chunk) f32 and S_in (b, s / chunk, h, n,
// p) f32 are the forward's scratch as it left it; dy (b, s, h, p) and
// grad_final (b, h, n, p) f32.  dh0 may be null (no h0).  Scratch that the
// call overwrites before it reads: dS (b, s / chunk, h, n, p), inner (b,
// s / chunk, h, repro_ssd_bwd_pass_blocks(n, p)), dA_part (b, s / chunk,
// h), terms (4, b, s, h), dB_part and dC_part (b, s, h, n), all f32.
// Launches six kernels on `stream`; returns the first launch error.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* cum, const void* G, const void* S_in,
    const void* dy, const void* grad_final, void* dx, void* ddt, void* dA,
    void* dB, void* dC, void* dh0, void* dS, void* inner, void* terms,
    void* dB_part, void* dC_part, void* dA_part, int b, int s, int h, int p,
    int n, int chunk, int dtype, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || s < 1 || n < 1 ||
      n > kMaxState || chunk < 1 || chunk > kMaxChunk || s % chunk != 0)
    return cudaErrorInvalidValue;
  const Args a{x,  dt,    A,     Bm,    Cm,      cum,     G,      S_in,
               dy, grad_final,      dx,    ddt,     dA,      dB,     dC,
               dh0, dS,    inner, terms, dB_part, dC_part, dA_part,
               b,  s,     h,     n,     chunk};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, p, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, p, st);
  return cudaErrorInvalidValue;
}

// The blocks the state-passing launch gives one (batch row, head): the
// last extent of the `inner` scratch.
extern "C" int repro_ssd_bwd_pass_blocks(int n, int p) {
  return pass_blocks(n * p);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
