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
//   dC_i   = sum_j (sum_h dG_ij) B_j + sum_h exp(cum_i) S dy_i
//   dB_j   = sum_i (sum_h dG_ij) C_i + sum_h w_j dS' x_j
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
// The products the function needs, and no others: per head and chunk, dW =
// dy x^T once for each tile pair (i >= j) of 64 steps, W^T dy, and the four
// state products (C dy^T, S dy, B dS', dS' x); once for all heads, as B
// and C are one group, (sum_h dG) B and (sum_h dG)^T C.  Five launches in
// order on one stream, no atomics, every sum in a fixed order, so the
// gradients are deterministic:
//   1. local states, grid (chunk x n-tile, h, b): L_c = sum_i exp(cum_i)
//      C_i dy_i^T, all chunks in parallel;
//   2. state passing backwards, grid (n p / 1024, h, b): dS' of every
//      chunk from grad_final, over L_c, dh0, and each block's part of
//      <S, dS'> per chunk;
//   3. pairs, grid (column tile x chunk, head group of 8, b): for 64 steps
//      j and each head of the group in order: the rows' terms of the same
//      steps as i (S dy_i, its d.cum term), the state terms (dx = w_j B_j
//      dS', w_j dS' x_j, V_j), then over the row tiles i >= j: dW^T = x_j
//      dy_i^T once, E's column sums, R's column sums (a part a tile pair),
//      dG^T added into the group's sum (one 64 x 64 f32 tile a pair and
//      group, the block's own, in head order), and dx_j += W^T dy_i (W^T
//      rebuilt in registers); dx is final; the group's sums of the state
//      terms of dB and dC go out the same way;
//   4. dt, one thread a (batch row, chunk, head): d.cum (R's parts summed
//      in tile order), its reverse sum in f64, ddt, and dt . d.a per chunk;
//   5. sums, grid (tile x chunk x {dC, dB}, b + 1): dG summed over the
//      groups in order, then dC_t = sum_j dG_tj B_j or dB_t = sum_i dG_it^T
//      C_i, plus the groups' state terms in order; the extra row of blocks
//      sums dA over (b, chunk) in order.
// Products in three TF32 passes of mma.sync with f32 accumulation
// (tf32_mma.cuh); tiles are staged in shared memory by 16-byte cp.async;
// bf16 x, B and C are widened to f32 as fragments are loaded.
//
// The forward's numerics are kept: every decay from a difference <= 0 of
// the f64 cumulative sums (off-diagonal tiles factored as the forward
// does, u_i w_j with both factors <= 1), d.cum's reverse sum in f64.
// Reused from the forward, which the autograd Function keeps: the f64 sums
// `cum`, the scores `G` and the states entering each chunk (the
// state-passing launch writes them over the chunk states; the output
// launch only reads them).
//
// Layouts: x, B, C and their grads in x's type (f32 or bf16), dy (b, s, h,
// p) f32, the rest as the forward's.  All contiguous.
//
// What bounds it: operations (ssd_bwd_bound in chip_smoke.py counts them).

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

// Shared head of the pairs kernel: the chunk's f64 sums and dt, 64 floats
// (an off-diagonal tile's u_i), and each warp's factors of an off-diagonal
// tile (u: 16 rows, w: 64 columns).
constexpr size_t kHead =
    kMaxChunk * (sizeof(double) + sizeof(float)) +
    (kTile + 4 * (16 + kTile)) * sizeof(float);

// Heads whose dG the pairs kernel sums before the products with B and C.
constexpr int kGroup = 8;

__host__ __device__ constexpr int pair_index(int ti, int tj) {
  return ti * (ti + 1) / 2 + tj;
}

// ----------------------------------------------------------- 3. pairs
// Shared memory after the head: exp(cum_Q - cum_j) and exp(cum_j) of the
// block's 64 steps, the warps' partial column sums of R, x_j of the head,
// then the space that each phase of a head takes in turn: the rows' terms
// (dy_j, S and C_j), the state terms (B_j and dS'), the pairs (dy_i and
// G_ij).  The group's dG^T tiles are summed in place in dG_part (the block
// owns them), so that three blocks fit an SM.
template <typename T, int P, int NB>
struct Pairs {
  static constexpr int LDY = row_pad<float>(P);  // dy, S and dS' rows
  static constexpr int LDX = row_pad<T>(P);
  static constexpr int LDN = row_pad<T>(NB);
  static constexpr int LDG = row_pad<float>(kTile);
  static constexpr size_t small = kHead + (2 + 4) * kTile * sizeof(float);
  static constexpr size_t x = small;
  static constexpr size_t space_at = x + (size_t)kTile * LDX * sizeof(T);
  static constexpr size_t rows_phase =
      (size_t)(kTile + NB) * LDY * sizeof(float) +
      (size_t)kTile * LDN * sizeof(T);
  static constexpr size_t state_phase =
      (size_t)kTile * LDN * sizeof(T) + (size_t)NB * LDY * sizeof(float);
  static constexpr size_t pairs_phase =
      (size_t)kTile * (LDY + LDG) * sizeof(float);
  static constexpr size_t space =
      rows_phase > state_phase
          ? (rows_phase > pairs_phase ? rows_phase : pairs_phase)
          : (state_phase > pairs_phase ? state_phase : pairs_phase);
  static constexpr size_t bytes = space_at + space;
};

template <typename T, int P, int NB>
__global__ void __launch_bounds__(128, 1)
    ssd_bwd_pairs_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const T* __restrict__ Bm, const T* __restrict__ Cm,
                         const double* __restrict__ cum,
                         const float* __restrict__ G,
                         const float* __restrict__ S_in,
                         const float* __restrict__ dS,
                         const float* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ dG_part,
                         float* __restrict__ state_part,
                         float* __restrict__ terms,
                         float* __restrict__ r_part, int b, int s, int h,
                         int n, int chunk, int groups) {
  using L = Pairs<T, P, NB>;
  constexpr int LDY = L::LDY, LDX = L::LDX, LDN = L::LDN, LDG = L::LDG;
  const int tiles = (chunk + kTile - 1) / kTile;
  const int c = blockIdx.x / tiles;
  const int tj = blockIdx.x - c * tiles;
  const int nc = gridDim.x / tiles;
  const int grp = blockIdx.y;
  const int row = blockIdx.z;
  const int h0 = grp * kGroup;
  const int h1 = min(h, h0 + kGroup);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int j0 = tj * kTile;
  const int cols = min(kTile, chunk - j0);
  const int np = round_up(n, 8);
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;
  const size_t plane = (size_t)b * s * h;
  const int wr = 16 * warp;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum_s = reinterpret_cast<double*>(smem_raw);  // kMaxChunk
  float* dt_s = reinterpret_cast<float*>(cum_s + kMaxChunk);
  float* u_s = dt_s + kMaxChunk;  // kTile: an off-diagonal tile's u_i
  float* w_s = u_s + kTile + warp * (16 + kTile) + 16;  // this warp's w_j
  float* end_s = reinterpret_cast<float*>(smem_raw + kHead);  // kTile
  float* dec_s = end_s + kTile;                               // kTile
  float* rp_s = dec_s + kTile;                                // 4 x kTile
  T* x_s = reinterpret_cast<T*>(smem_raw + L::x);
  unsigned char* space = smem_raw + L::space_at;
  // the rows' phase
  float* dyj_s = reinterpret_cast<float*>(space);  // kTile x LDY
  float* st_s = dyj_s + kTile * LDY;               // NB x LDY
  T* c_s = reinterpret_cast<T*>(st_s + NB * LDY);   // kTile x LDN
  // the state phase
  T* b_s = reinterpret_cast<T*>(space);                      // kTile x LDN
  float* ds_s = reinterpret_cast<float*>(b_s + kTile * LDN);  // NB x LDY
  // the pairs phase
  float* dy_s = reinterpret_cast<float*>(space);  // kTile x LDY
  float* g_s = dy_s + kTile * LDY;                // kTile x LDG

  const T* B0 = Bm + (t0 + j0) * n;
  const T* C0 = Cm + (t0 + j0) * n;
  const bool b_vec = tc::aligned16(B0, n) && whole_chunks<T>(n);
  const bool c_vec = tc::aligned16(C0, n) && whole_chunks<T>(n);
  const int pairs = tiles * (tiles + 1) / 2;
  float* dG_group =
      dG_part + (((size_t)row * nc + c) * groups + grp) * pairs * (kTile * kTile);
  const float* G_c = G + ((size_t)row * nc + c) * chunk * chunk + j0;
  const bool g_vec = tc::aligned16(G_c, chunk) && chunk % 4 == 0;
  const double* cum_c = cum + t0 * h;
  const float* dt_c = dt + t0 * h;

  // the group's state terms of dB and dC, (2, b, s, groups, n), summed in
  // place over the heads in order (each element stays with one thread)
  const size_t splane = (size_t)b * s * groups * n;
  float* state_g = state_part + ((t0 + j0) * groups + grp) * n;
  for (int head = h0; head < h1; ++head) {
    __syncthreads();  // every warp is done with the last head's tiles
    const T* x0 = x + (t0 + j0) * h * P + (size_t)head * P;
    const float* yj = dy + (t0 + j0) * h * P + (size_t)head * P;
    const float* st = S_in + (((size_t)row * nc + c) * h + head) * n * P;
    const bool x_vec = tc::aligned16(x0, (long long)h * P);
    const bool y_vec = tc::aligned16(yj, (long long)h * P);
    tc::stage(x_s, LDX, x0, (long long)h * P, cols, kTile, P, P, x_vec);
    tc::stage(dyj_s, LDY, yj, (long long)h * P, cols, kTile, P, P, y_vec);
    tc::stage(st_s, LDY, st, P, n, NB, P, P, tc::aligned16(st, P));
    tc::stage(c_s, LDN, C0, n, cols, kTile, n, NB, c_vec);
    tc::cp_async_commit();
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
      cum_s[i] = cum_c[(size_t)i * h + head];
      dt_s[i] = dt_c[(size_t)i * h + head];
    }
    __syncthreads();
    const double last = cum_s[chunk - 1];
    for (int r = threadIdx.x; r < kTile; r += blockDim.x) {
      end_s[r] = r < cols ? expf((float)(last - cum_s[j0 + r])) : 0.f;
      dec_s[r] = r < cols ? expf((float)cum_s[j0 + r]) : 0.f;
    }
    tc::cp_async_wait<0>();
    __syncthreads();

    // the rows' terms of this tile's steps as i: acc = (exp(cum_i) dy_i)
    // S^T, the head's state term of dC, and the entering state's d.cum term
    // dy_i . (exp(cum_i) S^T C_i) = C_i . acc_i; 64 state columns a pass
    {
      float ent0 = 0.f, ent1 = 0.f;
#pragma unroll 1
      for (int n0 = 0; n0 < NB; n0 += kTile) {
        float acc[kTile / 8][4] = {};
        tc::warp_mma3<kTile / 8>(
            acc, P,
            [&](int r, int k) { return dyj_s[(wr + r) * LDY + k] * dec_s[wr + r]; },
            [&](int k, int col) { return st_s[(n0 + col) * LDY + k]; });
#pragma unroll
        for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wr + g + (e < 2 ? 0 : 8);
            const int col = n0 + 8 * nt + 2 * t + (e & 1);
            const float cv = tc::to_float(c_s[r * LDN + col]);
            if (e < 2)
              ent0 += acc[nt][e] * cv;
            else
              ent1 += acc[nt][e] * cv;
            if (r < cols && col < n) {
              float* at = state_g + splane + (size_t)r * groups * n + col;
              *at = head == h0 ? acc[nt][e] : *at + acc[nt][e];
            }
          }
      }
      ent0 = quad_sum(ent0);
      ent1 = quad_sum(ent1);
      if (t == 0) {
        if (wr + g < cols) terms[(t0 + j0 + wr + g) * h + head] = ent0;
        if (wr + g + 8 < cols)
          terms[(t0 + j0 + wr + g + 8) * h + head] = ent1;
      }
    }
    __syncthreads();  // every warp is done with dy_j and S

    // the state terms of this tile's steps as j.  acc_b = (exp(cum_Q -
    // cum_j) x_j) dS'^T: V_j = B_j . acc_b_j, and dt_j acc_b the head's state
    // term of dB; dx: acc_x = (w_j B_j) dS'
    const float* dsp = dS + (((size_t)row * nc + c) * h + head) * n * P;
    tc::stage(b_s, LDN, B0, n, cols, kTile, n, NB, b_vec);
    tc::stage(ds_s, LDY, dsp, P, n, NB, P, P, tc::aligned16(dsp, P));
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    float v0 = 0.f, v1 = 0.f;
    const int ja = wr + g, jb = ja + 8;  // this thread's steps in the tile
    const float dt_a = ja < cols ? dt_s[j0 + ja] : 0.f;
    const float dt_b = jb < cols ? dt_s[j0 + jb] : 0.f;
#pragma unroll 1
    for (int n0 = 0; n0 < NB; n0 += kTile) {  // 64 state columns a pass
      float acc_b[kTile / 8][4] = {};
      tc::warp_mma3<kTile / 8>(
          acc_b, P,
          [&](int r, int k) {
            return tc::to_float(x_s[(wr + r) * LDX + k]) * end_s[wr + r];
          },
          [&](int k, int col) { return ds_s[(n0 + col) * LDY + k]; });
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e < 2 ? ja : jb;
          const int col = n0 + 8 * nt + 2 * t + (e & 1);
          const float v = acc_b[nt][e] * tc::to_float(b_s[r * LDN + col]);
          if (e < 2)
            v0 += v;
          else
            v1 += v;
          if (r < cols && col < n) {
            float* at = state_g + (size_t)r * groups * n + col;
            const float v = acc_b[nt][e] * (e < 2 ? dt_a : dt_b);
            *at = head == h0 ? v : *at + v;
          }
        }
    }
    v0 = quad_sum(v0);
    v1 = quad_sum(v1);
    float acc_x[P / 8][4] = {};
    tc::warp_mma3<P / 8>(
        acc_x, np,
        [&](int r, int k) {
          const int j = wr + r;
          return tc::to_float(b_s[j * LDN + k]) * end_s[j] *
                 (j < cols ? dt_s[j0 + j] : 0.f);
        },
        [&](int k, int col) { return ds_s[k * LDY + col]; });

    // the pairs (i >= j): dW^T = x_j dy_i^T once; E's column sums and R's
    // row sums (per tile, summed in order by the dt kernel); dG^T into the
    // group's sum; dx_j += W^T dy_i (W^T rebuilt in registers)
    const float* y_base = dy + t0 * h * P + (size_t)head * P;
    const bool yi_vec = tc::aligned16(y_base, (long long)h * P);
    const double ref = cum_s[min(j0 + kTile, chunk) - 1];
    if (cols == kTile) {
      // below the diagonal every i > ref = j0 + 63 >= j: exp(cum_i - cum_j)
      // = exp(cum_i - ref) w_j, w_j = exp(ref - cum_j) <= 1 (each warp
      // keeps its own copy)
      w_s[lane] = expf((float)(ref - cum_s[j0 + lane]));
      w_s[lane + 32] = expf((float)(ref - cum_s[j0 + lane + 32]));
    }
    float esum0 = 0.f, esum1 = 0.f;
    for (int ti = tj; ti < tiles; ++ti) {
      __syncthreads();  // every warp is done with the space
      const int i0 = ti * kTile;
      const int rows = min(kTile, chunk - i0);
      tc::stage(dy_s, LDY, y_base + (size_t)i0 * h * P, (long long)h * P,
                rows, kTile, P, P, yi_vec);
      tc::stage(g_s, LDG, G_c + (size_t)i0 * chunk, chunk, rows, kTile, cols,
                kTile, g_vec);
      tc::cp_async_commit();
      // the group's dG^T tile of this pair so far (the heads before this
      // one), loaded while the tiles arrive
      float* dgt = dG_group + (size_t)pair_index(ti, tj) * (kTile * kTile);
      float2 old[kTile / 8][2];
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          old[nt][half] =
              head == h0 ? make_float2(0.f, 0.f)
                         : __ldcg(reinterpret_cast<const float2*>(
                               dgt + (wr + g + 8 * half) * kTile + 8 * nt +
                               2 * t));
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
      // element (row j, column i) of the transposed tile
      float rcol[kTile / 8][2];
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        rcol[nt][0] = rcol[nt][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = wr + g + (e < 2 ? 0 : 8);
          const int il = 8 * nt + 2 * t + (e & 1);
          const int i = i0 + il;
          const int jj = j0 + jl;
          float ex;
          if (ti > tj)
            ex = u_s[il] * w_s[jl];
          else
            ex = jj <= i && i < chunk ? expf((float)(cum_s[i] - cum_s[jj]))
                                      : 0.f;
          const float gv = g_s[il * LDG + jl];
          const float d = jj < chunk ? dt_s[jj] : 0.f;
          const float ev = dwt[nt][e] * gv * ex;  // E_ij
          if (e < 2)
            esum0 += ev;
          else
            esum1 += ev;
          rcol[nt][e & 1] += ev * d;              // R_ij
          const float dgv = dwt[nt][e] * ex * d;  // dG_ij of this head
          float& sum = (e & 1) ? old[nt][e >> 1].y : old[nt][e >> 1].x;
          sum = head == h0 ? dgv : sum + dgv;
          dwt[nt][e] = gv * ex * d;  // W_ij, for dx
        }
#pragma unroll
        for (int half = 0; half < 2; ++half)
          __stcg(reinterpret_cast<float2*>(dgt + (wr + g + 8 * half) * kTile +
                                           8 * nt + 2 * t),
                 old[nt][half]);
      }
      // R's column sums over this tile's j, in a fixed order: the warp's
      // rows (lanes of one t), then the four warps
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v = rcol[nt][q];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) rp_s[warp * kTile + 8 * nt + 2 * t + q] = v;
        }
      tc::frag_mma3<P / 8, kTile / 8>(acc_x, dwt, [&](int k, int col) {
        return dy_s[k * LDY + col];
      });
      __syncthreads();
      if (threadIdx.x < rows) {
        const int il = threadIdx.x;
        const float sum = ((rp_s[il] + rp_s[kTile + il]) + rp_s[2 * kTile + il]) +
                          rp_s[3 * kTile + il];
        r_part[((t0 + i0 + il) * tiles + tj) * h + head] = sum;
      }
    }
    esum0 = quad_sum(esum0);
    esum1 = quad_sum(esum1);

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
        if (t == 0) {
          terms[plane + at] = half ? esum1 : esum0;
          terms[2 * plane + at] = half ? v1 : v0;
        }
      }
    }
  }

}

// ---------------------------------------------------------------- 4. dt
// A block a (chunk, 8 heads, batch row): first, all threads, each step's
// part of d.cum (R's row sum from the pairs kernel's per-tile parts, in
// order, E's column sum, the entering state's term, V) into shared memory;
// then one thread a head: d.cum's reverse sum in f64 within the chunk, ddt,
// and dt . d.a for dA.  terms: entering, E's column sums, V, each (b, s,
// h).
constexpr int kDtHeads = 8;
constexpr int kDtThreads = 256;
__host__ __device__ constexpr size_t dt_smem(int chunk) {
  return (size_t)chunk * kDtHeads * (3 * sizeof(double) + sizeof(float));
}

__global__ void __launch_bounds__(kDtThreads)
    ssd_bwd_dt_kernel(const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const double* __restrict__ cum,
                      const float* __restrict__ inner,
                      const float* __restrict__ terms,
                      const float* __restrict__ r_part,
                      float* __restrict__ ddt, float* __restrict__ dA_part,
                      int b, int s, int h, int chunk, int nc, int parts) {
  const int hb = (h + kDtHeads - 1) / kDtHeads;
  const int c = blockIdx.x / hb;
  const int h0 = (blockIdx.x - c * hb) * kDtHeads;
  const int row = blockIdx.y;
  const int tiles = (chunk + kTile - 1) / kTile;
  const size_t plane = (size_t)b * s * h;
  const float* entering = terms;
  const float* col_sum = terms + plane;
  const float* vv = terms + 2 * plane;
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* part_s = reinterpret_cast<double*>(smem_raw);  // d.cum's part
  double* tv_s = part_s + chunk * kDtHeads;               // dt_j V_j
  double* cv_s = tv_s + chunk * kDtHeads;                 // E's sum + V
  float* d_s = reinterpret_cast<float*>(cv_s + chunk * kDtHeads);  // dt
  for (int idx = threadIdx.x; idx < chunk * kDtHeads; idx += blockDim.x) {
    const int i = idx / kDtHeads;
    const int head = h0 + (idx - i * kDtHeads);
    if (head >= h) continue;
    const size_t at = (t0 + i) * h + head;
    float row_sum = 0.f;  // sum_j R_ij, tile by tile
    for (int jt = 0; jt <= i / kTile; ++jt)
      row_sum += r_part[((t0 + i) * tiles + jt) * h + head];
    const double d = dt[at];
    part_s[idx] =
        (double)row_sum - d * col_sum[at] + entering[at] - d * vv[at];
    tv_s[idx] = d * vv[at];
    cv_s[idx] = (double)col_sum[at] + vv[at];
    d_s[idx] = dt[at];
  }
  __syncthreads();
  const int hl = threadIdx.x;
  const int head = h0 + hl;
  if (hl >= kDtHeads || head >= h) return;
  double tail = 0.0;
  for (int j = 0; j < chunk; ++j) tail += tv_s[j * kDtHeads + hl];
  const size_t last = (t0 + chunk - 1) * h + head;
  const float* part_of = inner + (((size_t)row * nc + c) * h + head) * parts;
  float dot = 0.f;  // <S, dS'>, the pass kernel's parts in order
  for (int k = 0; k < parts; ++k) dot += part_of[k];
  tail += exp(cum[last]) * (double)dot;
  const double a = A[head];
  double da = 0.0, part = 0.0;
  for (int i = chunk - 1; i >= 0; --i) {
    const int idx = i * kDtHeads + hl;
    da += part_s[idx] + (i == chunk - 1 ? tail : 0.0);
    ddt[(t0 + i) * h + head] = (float)(cv_s[idx] + a * da);
    part += (double)d_s[idx] * da;
  }
  dA_part[((size_t)row * nc + c) * h + head] = (float)part;
}

// ---------------------------------------------------------- 5. the sums
// A block a (tile t of 64 steps, chunk, batch row): the groups' dG^T tiles
// summed in group order, then once for all heads dC_t = sum_{j <= t} dG_tj
// B_j and dB_t = sum_{i >= t} dG_it^T C_i, plus the heads' state terms (in
// head order); dB, dC in x's type.  The blocks of the extra batch row sum
// dA over (b, chunk) in order.
template <typename T, int NB>
__host__ __device__ constexpr size_t sum_smem() {
  return (size_t)kTile * (kTile + 4) * sizeof(float) +
         (size_t)kTile * row_pad<T>(NB) * sizeof(T);
}

template <typename T, int NB>
__global__ void __launch_bounds__(128, 1)
    ssd_bwd_sum_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                       const float* __restrict__ dG_part,
                       const float* __restrict__ state_part,
                       const float* __restrict__ dA_part,
                       T* __restrict__ dB, T* __restrict__ dC,
                       float* __restrict__ dA, int b, int s, int h, int n,
                       int chunk, int groups) {
  const int nc = s / chunk;
  if ((int)blockIdx.y == b) {
    const int head = blockIdx.x * blockDim.x + threadIdx.x;
    if (head < h) {
      float sum = 0.f;
      for (int k = 0; k < b * nc; ++k) sum += dA_part[(size_t)k * h + head];
      dA[head] = sum;
    }
    return;
  }
  constexpr int LDD = kTile + 4;
  constexpr int LDN = row_pad<T>(NB);
  const int tiles = (chunk + kTile - 1) / kTile;
  const int role = blockIdx.x & 1;  // 0: dC_t, 1: dB_t
  const int c = (blockIdx.x >> 1) / tiles;
  if (c >= nc) return;
  const int tt = (blockIdx.x >> 1) - c * tiles;
  const int row = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = 16 * warp;
  const int pairs = tiles * (tiles + 1) / 2;
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;
  const int r0 = tt * kTile;
  const int rows = min(kTile, chunk - r0);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* gs = reinterpret_cast<float*>(smem_raw);       // kTile x LDD
  T* m_s = reinterpret_cast<T*>(gs + kTile * LDD);      // kTile x LDN
  const float* parts =
      dG_part + ((size_t)row * nc + c) * groups * pairs * (kTile * kTile);

  // the pair's tile summed over the groups, in order
  auto sum_tile = [&](int ti, int tj) {
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += blockDim.x) {
      const int r = idx / kTile;
      const int col = idx - r * kTile;
      const float* p = parts + (size_t)pair_index(ti, tj) * (kTile * kTile) +
                       idx;
      float v = 0.f;
      for (int grp = 0; grp < groups; ++grp)
        v += p[(size_t)grp * pairs * (kTile * kTile)];
      gs[r * LDD + col] = v;
    }
  };
  float acc[NB / 8][4] = {};
  // dC_t = sum_j dG_tj B_j: A(i, j) = the tile's [j][i]
  for (int tj = 0; role == 0 && tj <= tt; ++tj) {
    __syncthreads();
    const int j0 = tj * kTile;
    const T* B0 = Bm + (t0 + j0) * n;
    tc::stage(m_s, LDN, B0, n, min(kTile, chunk - j0), kTile, n, NB,
              tc::aligned16(B0, n) && whole_chunks<T>(n));
    tc::cp_async_commit();
    sum_tile(tt, tj);
    tc::cp_async_wait<0>();
    __syncthreads();
    tc::warp_mma3<NB / 8>(
        acc, kTile, [&](int r, int k) { return gs[k * LDD + wr + r]; },
        [&](int k, int col) { return tc::to_float(m_s[k * LDN + col]); });
  }
  // dB_t = sum_i dG_it^T C_i: A(j, i) = the tile's [j][i]
  for (int ti = tt; role == 1 && ti < tiles; ++ti) {
    __syncthreads();
    const int i0 = ti * kTile;
    const T* C0 = Cm + (t0 + i0) * n;
    tc::stage(m_s, LDN, C0, n, min(kTile, chunk - i0), kTile, n, NB,
              tc::aligned16(C0, n) && whole_chunks<T>(n));
    tc::cp_async_commit();
    sum_tile(ti, tt);
    tc::cp_async_wait<0>();
    __syncthreads();
    tc::warp_mma3<NB / 8>(
        acc, kTile, [&](int r, int k) { return gs[(wr + r) * LDD + k]; },
        [&](int k, int col) { return tc::to_float(m_s[k * LDN + col]); });
  }
  // plus the groups' state terms, in order
  const float* sp = state_part + (role == 0 ? (size_t)b * s * groups * n : 0);
  T* out = role == 0 ? dC : dB;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr + g + 8 * half;
    if (r < rows) {
      const size_t at = t0 + r0 + r;
      const float* sg = sp + at * groups * n;
#pragma unroll
      for (int nt = 0; nt < NB / 8; ++nt)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = 8 * nt + 2 * t + q;
          if (col < n) {
            float v = acc[nt][2 * half + q];
            for (int grp = 0; grp < groups; ++grp) v += sg[grp * n + col];
            out[at * n + col] = from_float<T>(v);
          }
        }
    }
  }
}


// Events that the next calls record on their stream before each launch and
// after the last (repro_*_bwd_mark_launches), for timing each launch on the
// card; none by default.  One setting for the process, read by every call:
// for measurement from one thread only.
cudaEvent_t* g_marks = nullptr;
int g_n_marks = 0;
void mark(int i, cudaStream_t stream) {
  if (i < g_n_marks) cudaEventRecord(g_marks[i], stream);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

__host__ __device__ constexpr int tiles_of(int chunk) {
  return (chunk + kTile - 1) / kTile;
}
__host__ __device__ constexpr int groups_of(int h) {
  return (h + kGroup - 1) / kGroup;
}

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *cum, *G, *S_in, *dy, *grad_final;
  void *dx, *ddt, *dA, *dB, *dC, *dh0;
  void *dS, *inner, *terms, *r_part, *dG_part, *state_part, *dA_part;
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
  const int tiles = tiles_of(a.chunk);
  const int groups = groups_of(a.h);
  cudaError_t err;

  const size_t smem1 = local_smem<T, P>(a.n);
  if ((err = allow_smem(ssd_bwd_local_kernel<T, P>, smem1)) != cudaSuccess)
    return err;
  const int ntn = (a.n + kTile - 1) / kTile;
  mark(0, stream);
  ssd_bwd_local_kernel<T, P><<<dim3(nc * ntn, a.h, a.b), 128, smem1,
                               stream>>>(dy, Cm, cum, dS, a.s, a.h, a.n,
                                         a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(1, stream);

  const int parts = pass_blocks(a.n * P);
  ssd_bwd_pass_kernel<<<dim3(parts, a.h, a.b), kPassThreads, 0, stream>>>(
      cum, static_cast<const float*>(a.S_in),
      static_cast<const float*>(a.grad_final), dS,
      static_cast<float*>(a.dh0), static_cast<float*>(a.inner), a.s, a.h,
      a.n * P, a.chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(2, stream);

  constexpr size_t smem3 = Pairs<T, P, NB>::bytes;
  static_assert(smem3 <= kMaxSmem, "ssd backward (pairs): shared memory");
  if ((err = allow_smem(ssd_bwd_pairs_kernel<T, P, NB>, smem3)) !=
      cudaSuccess)
    return err;
  ssd_bwd_pairs_kernel<T, P, NB><<<dim3(nc * tiles, groups, a.b), 128, smem3,
                                   stream>>>(
      x, dt, Bm, Cm, cum, static_cast<const float*>(a.G),
      static_cast<const float*>(a.S_in), dS, dy, static_cast<T*>(a.dx),
      static_cast<float*>(a.dG_part), static_cast<float*>(a.state_part),
      terms, static_cast<float*>(a.r_part), a.b, a.s, a.h, a.n, a.chunk,
      groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(3, stream);

  const int hb = (a.h + kDtHeads - 1) / kDtHeads;
  const size_t smem4 = dt_smem(a.chunk);
  if ((err = allow_smem(ssd_bwd_dt_kernel, smem4)) != cudaSuccess) return err;
  ssd_bwd_dt_kernel<<<dim3(nc * hb, a.b), kDtThreads, smem4, stream>>>(
      dt, static_cast<const float*>(a.A), cum,
      static_cast<const float*>(a.inner), terms,
      static_cast<const float*>(a.r_part), static_cast<float*>(a.ddt),
      static_cast<float*>(a.dA_part), a.b, a.s, a.h, a.chunk, nc, parts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(4, stream);

  constexpr size_t smem5 = sum_smem<T, NB>();
  static_assert(smem5 <= kMaxSmem, "ssd backward (sums): shared memory");
  if ((err = allow_smem(ssd_bwd_sum_kernel<T, NB>, smem5)) != cudaSuccess)
    return err;
  const int blocks5 = max(2 * nc * tiles, (a.h + 127) / 128);
  ssd_bwd_sum_kernel<T, NB><<<dim3(blocks5, a.b + 1), 128, smem5, stream>>>(
      Bm, Cm, static_cast<const float*>(a.dG_part),
      static_cast<const float*>(a.state_part),
      static_cast<const float*>(a.dA_part), static_cast<T*>(a.dB),
      static_cast<T*>(a.dC), static_cast<float*>(a.dA), a.b, a.s, a.h, a.n,
      a.chunk, groups);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(5, stream);
  return cudaSuccess;
}

// The (head dim p, state width) entries that the port's models and tests
// use, and no others (each costs seconds of nvcc): p 16, 32 and 64 at n <=
// 64; p 64 and 128 at n <= 128.  Null for another: the call then returns
// cudaErrorInvalidValue, and repro_ssd_bwd_built says so beforehand.
using Entry = cudaError_t (*)(const Args&, cudaStream_t);
template <typename T>
Entry entry(int p, int n) {
  if (state_width(n) == 64) {
    switch (p) {
      case 16: return launch<T, 16, 64>;
      case 32: return launch<T, 32, 64>;
      case 64: return launch<T, 64, 64>;
    }
  } else {
    switch (p) {
      case 64: return launch<T, 64, 128>;
      case 128: return launch<T, 128, 128>;
    }
  }
  return nullptr;
}

}  // namespace

// dtype of x, B, C and their grads: 0 = float32, 1 = bfloat16.  cum (b, s,
// h) f64, G (b, s / chunk, chunk, chunk) f32 and S_in (b, s / chunk, h, n,
// p) f32 are the forward's scratch as it left it; dy (b, s, h, p) and
// grad_final (b, h, n, p) f32.  dh0 may be null (no h0).  Scratch that the
// call overwrites before it reads, all f32, each of the size
// repro_ssd_bwd_scratch gives: dS, inner, terms, r_part, dG_part,
// state_part, dA_part.  Launches five kernels on `stream`; returns the
// first launch error.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* cum, const void* G, const void* S_in,
    const void* dy, const void* grad_final, void* dx, void* ddt, void* dA,
    void* dB, void* dC, void* dh0, void* dS, void* inner, void* terms,
    void* r_part, void* dG_part, void* state_part, void* dA_part, int b,
    int s, int h, int p, int n, int chunk, int dtype, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || s < 1 || n < 1 ||
      n > kMaxState || chunk < 1 || chunk > kMaxChunk || s % chunk != 0)
    return cudaErrorInvalidValue;
  const Args a{x,     dt,     A,       Bm,         Cm,      cum,
               G,     S_in,   dy,      grad_final, dx,      ddt,
               dA,    dB,     dC,      dh0,        dS,      inner,
               terms, r_part, dG_part, state_part, dA_part, b,
               s,     h,      n,       chunk};
  const Entry run = dtype == 0   ? entry<float>(p, n)
                    : dtype == 1 ? entry<__nv_bfloat16>(p, n)
                                 : nullptr;
  if (run == nullptr) return cudaErrorInvalidValue;
  return run(a, static_cast<cudaStream_t>(stream));
}

// 1 if the library holds the entry for head dim p and state n (both
// dtypes), else 0.
extern "C" int repro_ssd_bwd_built(int p, int n) {
  return n >= 1 && n <= kMaxState && entry<float>(p, n) != nullptr;
}

// The f32 elements of scratch `which` of a call: 0 dS (b, s / chunk, h, n,
// p), 1 inner (b, s / chunk, h, state-passing blocks), 2 terms (3, b, s,
// h), 3 r_part (b, s, tiles, h), 4 dG_part (b, s / chunk, groups, tile
// pairs, 64, 64), 5 state_part (2, b, s, groups, n), 6 dA_part (b, s / chunk,
// h); -1 for another `which`.
extern "C" long long repro_ssd_bwd_scratch(int which, int b, int s, int h,
                                           int p, int n, int chunk) {
  const long long nc = s / chunk, tiles = tiles_of(chunk);
  const long long bs = (long long)b * s;
  switch (which) {
    case 0: return (long long)b * nc * h * n * p;
    case 1: return (long long)b * nc * h * pass_blocks(n * p);
    case 2: return 3 * bs * h;
    case 3: return bs * tiles * h;
    case 4:
      return (long long)b * nc * groups_of(h) * (tiles * (tiles + 1) / 2) *
             kTile * kTile;
    case 5: return 2 * bs * groups_of(h) * n;
    case 6: return (long long)b * nc * h;
  }
  return -1;
}

// The next calls record events[0 .. n) (cudaEvent_t) on their stream, one
// before each of the five launches and one after the last; n = 0 stops.
extern "C" void repro_ssd_bwd_mark_launches(void* events, int n) {
  g_marks = static_cast<cudaEvent_t*>(events);
  g_n_marks = events == nullptr ? 0 : n;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
