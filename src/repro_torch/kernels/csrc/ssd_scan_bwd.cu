// The Mamba2 SSD chunk scan's backward for Hopper (sm_90a), on TF32 wgmma.
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
// With Z_j = sum_{i>=j} G_ij exp(cum_i - cum_j) dy_i, dx_j = dt_j Z_j + w_j
// dS'^T B_j.  R's row sums and E's column sums come from the same E_ij
// values, so that their rounding cancels in d.cum as their terms do.  The
// state terms of dB and dC sum over the heads and each head's p channels
// together, one product whose K runs over (h, p).  Six launches in order
// on one stream, no atomics, every sum in a fixed order, so the gradients
// are deterministic; every product on TF32
// wgmma in three passes, on the pipeline of ssd_pipe.cuh (a producer
// warpgroup copies raw tiles into each consumer's ring; two consumer
// warpgroups split each B operand into hi and lo planes once, build their
// A operands in registers and take turns at the tensor cores):
//   1. local states, grid (chunk, group of 8 heads, b): L_c = sum_i
//      (exp(cum_i) C_i)^T dy_i (ssd_pipe.cuh's chunk launch: A = exp(cum_i)
//      C_i from registers, B = dy's transposed planes);
//   2. state passing backwards, grid (n p / 1024, h, b): dS' of every
//      chunk from grad_final, over L_c, dh0, and each block's part of
//      <S, dS'> per chunk;
//   3. dx, one block a (column tile j, group of 8 heads, chunk, b), the
//      column tiles that read the same dy tiles side by side; the block
//      copies the G tiles of its pairs once.  Per head: the entering term
//      (A = exp(cum_i) C_i, B = S's transposed planes; dotted with dy_i),
//      Z_j over the row tiles i >= j (A = G^T o exp(cum_i - cum_j) from
//      the held tiles, below the diagonal as w_j u_i with both factors <= 1
//      formed once a head; B = dy_i's transposed planes), exp(cum_Q -
//      cum_j) B_j dS' (B = dS''s transposed planes), then V_j as a dot
//      with x_j, and dx;
//   4. dG, one block a (tile pair, chunk, b), a chunk's pairs side by
//      side, the diagonal pairs first: per head dW = dy_i x_j^T (A = dy_i
//      from the item's raw tile, B = x_j's planes), R's row sums and E's
//      column sums, and dG = sum_h dW o f summed over the heads in
//      registers, each consumer its heads in order, then consumer 0's sum
//      plus consumer 1's;
//   5. dt, one thread a (batch row, chunk, head): d.cum (R's and E's parts
//      summed in tile order), its reverse sum in f64, ddt, and dt . d.a per
//      chunk;
//   6. sums, grid (tile x chunk x {dC, dB}, b + 1): dC_t = sum_j dG_tj B_j
//      + sum_(h, p) exp(cum_ih) dy_i,hp S_h[:, p] (B: B's transposed planes,
//      then each head's S planes), or dB_t = sum_i dG_it^T C_i + sum_(h, p)
//      w_jh x_j,hp dS'_h[:, p]; items alternate between the consumers, whose
//      sums are added in order; the extra row of blocks sums dA over (b,
//      chunk) in order.
//
// The forward's numerics are kept: every decay from a difference <= 0 of
// the f64 cumulative sums (off-diagonal tiles factored as the forward
// does, u_i w_j with both factors <= 1), d.cum's reverse sum in f64.
// Reused from the forward, which the autograd Function keeps: the f64 sums
// `cum`, the scores `G` and the states entering each chunk.
//
// Layouts: x, B, C and their grads in x's type (f32 or bf16), dy (b, s, h,
// p) f32, the rest as the forward's.  All contiguous.
//
// What bounds it: operations (ssd_bwd_bound in chip_smoke.py counts them);
// on the card, the operand splits and builds beside the products (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "ssd_pipe.cuh"

namespace {

using ssd::cdiv;
using ssd::kK;
using ssd::kLdCols;
using ssd::kLdRows;
using ssd::kMaxChunk;
using ssd::kRawBytes;
using ssd::kThreads;
using ssd::kTile;
using ssd::staged_ld;

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

// ------------------------------------------------------------------ 3. dx
// Shared memory: each consumer's planes (P rows), the rings (a stage
// holds a plane source and a raw tile), the G tiles of the column tile's
// pairs (rows of LDG, read as G^T; sized at launch), each consumer's
// cumulative sums, dt and the factors u, the barriers.
template <int P>
struct DxLayout {
  static constexpr uint32_t kPlanes = 2 * P * 128;
  static constexpr uint32_t kSource = 32 * staged_ld<float>(P) * 4;
  static constexpr uint32_t kStage = kSource + kRawBytes;
  static constexpr uint32_t kConsumer = kMaxChunk * 16;
  static constexpr int LDG = kTile + 8;  // a G tile's rows, read as G^T
  static constexpr uint32_t kGTile = kTile * LDG * 4;
  static constexpr uint32_t kFixedMost =
      2 * kPlanes + 4 * kGTile + 2 * kConsumer;
  static constexpr int kStages = ssd::stages_for(kFixedMost, kStage);
  static_assert(kStages > 0, "ssd backward (dx): shared memory");
  static constexpr size_t bytes(int tiles) {
    return ssd::ring_bytes(kFixedMost, kStage, kStages) -
           (4 - tiles) * kGTile;
  }
};

// Blocks are numbered ((row * nc + chunk) * groups + group) * tiles + tj:
// the column tiles that read the same dy tiles run side by side.
// terms: the entering term, E's column sums and V, each (b, s, h).
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const double* __restrict__ cum,
                      const float* __restrict__ G,
                      const float* __restrict__ S_in,
                      const float* __restrict__ dS,
                      const float* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ terms, int b, int s, int h, int n,
                      int chunk) {
  using L = DxLayout<P>;
  const int tiles = cdiv(chunk, kTile);
  const int nc = s / chunk;
  const int groups = cdiv(h, ssd::kHeads);
  const int tj = blockIdx.x % tiles;
  const int r1 = blockIdx.x / tiles;
  const int hd0 = (r1 % groups) * ssd::kHeads;
  const int c = (r1 / groups) % nc;
  const int row = r1 / groups / nc;
  const int heads = min(h, hd0 + ssd::kHeads) - hd0;
  const int j0 = kTile * tj;
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;
  const size_t plane = (size_t)b * s * h;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t smem_base = hop::smem_addr(smem_raw);
  const uint32_t base = (smem_base + 1023) & ~1023u;
  unsigned char* ring_s = smem_raw + (base - smem_base) + 2 * L::kPlanes;
  unsigned char* after_ring = ring_s + 2 * L::kStages * L::kStage;
  float* g_s = reinterpret_cast<float*>(after_ring);
  unsigned char* consumer_s = after_ring + tiles * L::kGTile;
  const ssd::Ring ring{
      ring_s, smem_base + (uint32_t)(consumer_s + 2 * L::kConsumer - smem_raw),
      L::kStage, L::kStages};

  // ---- every thread: G^T's tiles (j, i) for the row tiles i >= j, in A-
  // fragment order (row j, column i)
  const int tid = threadIdx.x & 127;
  // the consumers' first head's sums and dt (two a thread), in flight
  // while the block's tiles load
  const int me = threadIdx.x / 128 - 1;
  double cum_next[2] = {0.0, 0.0};
  float dt_next[2] = {0.f, 0.f};
  auto load_head = [&](int head) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = tid + 128 * q;
      if (head < hd0 + heads && j < chunk) {
        cum_next[q] = cum[(t0 + j) * h + head];
        dt_next[q] = dt[(t0 + j) * h + head];
      }
    }
  };
  if (me >= 0) load_head(hd0 + me);
  // every thread: the G tiles (i, j) for the row tiles i >= j, by cp.async
  {
    ssd::Stager st{(int)threadIdx.x, kThreads};
    const float* G_c = G + ((size_t)row * nc + c) * chunk * chunk;
    for (int tt = 0; tt < tiles - tj; ++tt) {
      const int r0 = kTile * (tj + tt);
      st.tile(g_s + tt * kTile * L::LDG, L::LDG,
              G_c + (size_t)r0 * chunk + j0, chunk, kTile,
              min(kTile, chunk - r0), kTile, min(kTile, chunk - j0));
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
  }
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  // a unit is a head: the entering term's items (32 state rows each), the
  // pairs' items (32 steps i each), dS''s items (32 state rows each)
  const int s_items = cdiv(n, kK);
  const int p_items =
      2 * (tiles - tj) - (kTile * (tiles - 1) + kK < chunk ? 0 : 1);
  const int per = 2 * s_items + p_items;
  const int rows_j = min(kTile, chunk - j0);

  if (threadIdx.x < 128) {
    // ---- producer
    hop::release_registers<ssd::kProducerRegs>();
    ssd::produce(
        ring, heads * per, ssd::Cursor(heads, per),
        [&](const ssd::Cursor& it, unsigned char* stage, ssd::Stager& st) {
          const int head = hd0 + it.unit;
          const size_t state = (((size_t)row * nc + c) * h + head) * n;
          if (it.t < s_items || it.t >= s_items + p_items) {
            const bool entering = it.t < s_items;
            const int n0 = kK * (entering ? it.t : it.t - s_items - p_items);
            st.tile(reinterpret_cast<float*>(stage), staged_ld<float>(P),
                    (entering ? S_in : dS) + (state + n0) * P, P, kK,
                    min(kK, n - n0), P, P);
            st.tile(reinterpret_cast<T*>(stage + L::kSource), staged_ld<T>(kK),
                    (entering ? Cm : Bm) + (t0 + j0) * n + n0, n, kTile,
                    rows_j, kK, min(kK, n - n0));
          } else {
            const int i0 = j0 + kK * (it.t - s_items);
            st.tile(reinterpret_cast<float*>(stage), staged_ld<float>(P),
                    dy + ((t0 + i0) * h + head) * P, (long long)h * P, kK,
                    min(kK, chunk - i0), P, P);
          }
        });
  } else {
    // ---- consumers: heads me, me + 2, ... of the group
    hop::claim_registers<ssd::kConsumerRegs>();
    const int bar = ssd::kConsumerBar + me;
    const ssd::Lane ln(tid);
    unsigned char* mine = consumer_s + me * L::kConsumer;
    double* cum_s = reinterpret_cast<double*>(mine);
    float* dt_s = reinterpret_cast<float*>(cum_s + kMaxChunk);
    float* u_s = dt_s + kMaxChunk;  // exp(cum_i - ref), i past the tile
    const ssd::Planes pl{base + me * L::kPlanes,
                         base + me * L::kPlanes + L::kPlanes / 2};
    // acc: Z_j; side: first the entering term's product, then B_j dS'
    float acc[P / 2], side[P / 2];
    int slot = 0;
    for (int u = me; u < heads; u += 2) {
      const int head = hd0 + u;
      hop::bar_sync(bar, 128);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = tid + 128 * q;
        if (j < chunk) {
          cum_s[j] = cum_next[q];
          dt_s[j] = dt_next[q];
        }
      }
      load_head(head + 2);
      hop::bar_sync(bar, 128);
      // below the diagonal every weight factors against one reference, the
      // tile's last step: exp(cum_i - ref) u_i times w_j = exp(ref -
      // cum_j), both <= 1
      const int past = j0 + kTile;
      if (past < chunk) {
        const double ref = cum_s[past - 1];
        for (int i = past + tid; i < chunk; i += 128)
          u_s[i - past] = expf((float)(cum_s[i] - ref));
        hop::bar_sync(bar, 128);
      }
      // the thread's two A rows j: exp(cum_j), exp(cum_Q - cum_j), w_j
      float dec[2], endw[2], wrow[2];
      {
        const double last = cum_s[chunk - 1];
        const double ref = cum_s[min(chunk, past) - 1];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + ln.a_row(e);
          const bool in = j < chunk;
          dec[e] = in ? expf((float)cum_s[j]) : 0.f;
          endw[e] = in ? expf((float)(last - cum_s[j])) : 0.f;
          wrow[e] = in ? expf((float)(ref - cum_s[j])) : 0.f;
        }
      }
      ssd::zero(side);
      ssd::zero(acc);
      for (int t = 0; t < per; ++t) {
        const int sl = slot++;
        const unsigned char* stage = ring.stage(me, sl);
        const T* raw = reinterpret_cast<const T*>(stage + L::kSource);
        ring.wait_full(me, sl);
        ssd::split_transposed(reinterpret_cast<const float*>(stage),
                              staged_ld<float>(P), P, pl.hi, pl.lo, tid);
        ssd::Frag a;
        if (t < s_items || t >= s_items + p_items) {
          // exp(cum_i) C_i (the entering term's product with S) or exp(cum_Q
          // - cum_j) B_j (with dS'), rows of this tile
          const float* f = t < s_items ? dec : endw;
          ssd::build(a, [&](int kk, int e) {
            return f[e & 1] * tc::to_float(raw[ln.a_row(e) * staged_ld<T>(kK) +
                                               ln.a_col(kk, e)]);
          });
          ring.release(me, sl);
          ssd::planes_ready(bar);
          ssd::issue<P>(side, a, pl.hi, pl.lo);
          if (t == s_items - 1) {
            float part[2] = {0.f, 0.f};
#pragma unroll
            for (int jj = 0; jj < P / 8; ++jj)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int i = j0 + ln.c_row(2 * half);
                if (i < chunk) {
                  const float2 d = ssd::load2(
                      dy + ((t0 + i) * h + head) * P + ln.c_col(jj, 0));
                  part[half] += d.x * side[4 * jj + 2 * half] +
                                d.y * side[4 * jj + 2 * half + 1];
                }
              }
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const float sum = ssd::quad_sum(part[half]);
              const int i = j0 + ln.c_row(2 * half);
              if (ln.q == 0 && i < chunk) terms[(t0 + i) * h + head] = sum;
            }
            ssd::zero(side);
          }
        } else {
          // Z_j += (G^T o exp(cum_i - cum_j))_ji dy_i over 32 steps i
          ring.release(me, sl);
          const int pi = t - s_items;
          const int tt = pi >> 1;
          const int il0 = kK * pi;  // the item's first i, from j0
          // G(i, j), i = j0 + il, at g[(il - 64 tt) * LDG + j - j0]
          const float* g = g_s + (size_t)tt * kTile * L::LDG +
                           (kK * (pi & 1)) * L::LDG;
          if (tt > 0) {
            ssd::build(a, [&](int kk, int e) {
              return g[ln.a_col(kk, e) * L::LDG + ln.a_row(e)] * wrow[e & 1] *
                     u_s[il0 - kTile + ln.a_col(kk, e)];
            });
          } else {
            ssd::build(a, [&](int kk, int e) {
              const int jl = ln.a_row(e);
              const int il = il0 + ln.a_col(kk, e);
              const int i = j0 + il;
              return il >= jl && i < chunk
                         ? g[ln.a_col(kk, e) * L::LDG + jl] *
                               expf((float)(cum_s[i] - cum_s[j0 + jl]))
                         : 0.f;
            });
          }
          ssd::planes_ready(bar);
          ssd::issue<P>(acc, a, pl.hi, pl.lo);
        }
      }
      // V_j = x_j . side_j, dx_j = dt_j (Z_j + side_j)
      float v[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < P / 8; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = j0 + ln.c_row(2 * half);
          if (j < chunk) {
            const size_t at = ((t0 + j) * h + head) * P + ln.c_col(jj, 0);
            const float2 xv = ssd::load2(x + at);
            const float z0 = acc[4 * jj + 2 * half];
            const float z1 = acc[4 * jj + 2 * half + 1];
            const float s0 = side[4 * jj + 2 * half];
            const float s1 = side[4 * jj + 2 * half + 1];
            v[half] += xv.x * s0 + xv.y * s1;
            const float d = dt_s[j];
            ssd::store2(dx + at, make_float2(d * (z0 + s0), d * (z1 + s1)));
          }
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float vs = ssd::quad_sum(v[half]);
        const int j = j0 + ln.c_row(2 * half);
        if (ln.q == 0 && j < chunk) terms[plane + (t0 + j) * h + head] = vs;
      }
    }
  }
}

// ------------------------------------------------------------------ 4. dG
// Shared memory: each consumer's planes (64 rows), the rings (a stage
// holds x_j's 64 x 32 and dy_i's 64 x 32), each consumer's sums of the
// pair's rows and columns, dt and factors, the buffer in which consumer 1
// hands its dG over, the barriers.
struct DgLayout {
  static constexpr uint32_t kPlanes = 2 * kTile * 128;
  static constexpr uint32_t kSource = kTile * staged_ld<float>(kK) * 4;
  static constexpr uint32_t kStage = kSource + kRawBytes;
  static constexpr uint32_t kConsumer = 2 * kTile * 8 + 7 * kTile * 4;
  static constexpr uint32_t kHandOver = kTile * kTile * 4;
  static constexpr int LDG = kTile + 4;  // the pair's G tile, read as dW's
  static constexpr uint32_t kG = kTile * LDG * 4;
  static constexpr uint32_t kFixed =
      2 * kPlanes + 2 * kConsumer + kHandOver + kG;
  static constexpr int kStages = ssd::stages_for(kFixed, kStage);
  static constexpr size_t kBytes = ssd::ring_bytes(kFixed, kStage, kStages);
};

__host__ __device__ constexpr int pair_index(int ti, int tj) {
  return ti * (ti + 1) / 2 + tj;
}

// Blocks are numbered (row * nc + chunk) * pairs + rank: ranks 0 .. tiles
// - 1 the diagonal pairs, then the pairs below it; a chunk's pairs, which
// read the same tiles, run side by side.  dG: (b, nc, pairs, 64, 64)
// f32, the whole tile; r_part: R's row sums over each column tile, (b, s,
// tiles, h).
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_dg_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const double* __restrict__ cum,
                      const float* __restrict__ G,
                      const float* __restrict__ dy, float* __restrict__ dG,
                      float* __restrict__ r_part, float* __restrict__ e_part,
                      int b, int s, int h, int chunk) {
  using L = DgLayout;
  const int tiles = cdiv(chunk, kTile);
  const int nc = s / chunk;
  const int pairs = tiles * (tiles + 1) / 2;
  const int rank = blockIdx.x % pairs;
  const int c = (blockIdx.x / pairs) % nc;
  const int row = blockIdx.x / pairs / nc;
  int ti = rank, tj = rank;
  if (rank >= tiles) {
    const int m = rank - tiles;
    ti = 1;
    while (ti * (ti + 1) / 2 <= m) ++ti;
    tj = m - ti * (ti - 1) / 2;
  }
  const bool diagonal = ti == tj;
  const int i0 = kTile * ti;
  const int j0 = kTile * tj;
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t smem_base = hop::smem_addr(smem_raw);
  const uint32_t base = (smem_base + 1023) & ~1023u;
  unsigned char* ring_s = smem_raw + (base - smem_base) + 2 * L::kPlanes;
  unsigned char* consumer_s = ring_s + 2 * L::kStages * L::kStage;
  float* hand_over = reinterpret_cast<float*>(consumer_s + 2 * L::kConsumer);
  float* g_s = hand_over + kTile * kTile;
  const ssd::Ring ring{
      ring_s,
      smem_base + (uint32_t)(reinterpret_cast<unsigned char*>(g_s) + L::kG -
                             smem_raw),
      L::kStage, L::kStages};
  {  // every thread: the pair's G tile, by cp.async
    ssd::Stager st{(int)threadIdx.x, kThreads};
    st.tile(g_s, L::LDG,
            G + ((size_t)row * nc + c) * chunk * chunk + (size_t)i0 * chunk +
                j0,
            chunk, kTile, min(kTile, chunk - i0), kTile,
            min(kTile, chunk - j0));
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
  }
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  // a unit is a head: its p channels in items of 32
  const int per = cdiv(P, kK);
  const int rows_i = min(kTile, chunk - i0);
  const int rows_j = min(kTile, chunk - j0);

  const int tid = threadIdx.x & 127;
  if (threadIdx.x < 128) {
    // ---- producer: x_j's planes and dy_i's raw tile
    hop::release_registers<ssd::kProducerRegs>();
    ssd::produce(
        ring, h * per, ssd::Cursor(h, per),
        [&](const ssd::Cursor& it, unsigned char* stage, ssd::Stager& st) {
          const int p0 = kK * it.t;
          st.tile(reinterpret_cast<T*>(stage), staged_ld<T>(kK),
                  x + ((t0 + j0) * h + it.unit) * P + p0, (long long)h * P,
                  kTile, rows_j, kK, min(kK, P - p0));
          st.tile(reinterpret_cast<float*>(stage + L::kSource), kLdRows,
                  dy + ((t0 + i0) * h + it.unit) * P + p0, (long long)h * P,
                  kTile, rows_i, kK, min(kK, P - p0));
        });
  } else {
    // ---- consumers: heads me, me + 2, ...
    hop::claim_registers<ssd::kConsumerRegs>();
    const int me = threadIdx.x / 128 - 1;
    const int bar = ssd::kConsumerBar + me;
    const ssd::Lane ln(tid);
    unsigned char* mine = consumer_s + me * L::kConsumer;
    double* cum_i = reinterpret_cast<double*>(mine);
    double* cum_j = cum_i + kTile;
    float* dt_j = reinterpret_cast<float*>(cum_j + kTile);
    float* u_s = dt_j + kTile;
    float* w_s = u_s + kTile;
    float* col_s = w_s + kTile;  // 4 warps x 64 columns of E
    const ssd::Planes pl{base + me * L::kPlanes,
                         base + me * L::kPlanes + L::kPlanes / 2};
    // a head's sums of the pair's rows and columns and dt of its columns,
    // loaded a head ahead
    double cum_next = 0.0;
    float dt_next = 0.f;
    auto load_head = [&](int head) {
      if (head < h) {
        if (tid < kTile) {
          if (tid < rows_i) cum_next = cum[(t0 + i0 + tid) * h + head];
        } else if (tid - kTile < rows_j) {
          cum_next = cum[(t0 + j0 + tid - kTile) * h + head];
          dt_next = dt[(t0 + j0 + tid - kTile) * h + head];
        }
      }
    };
    load_head(me);
    float dg[kTile / 2], dw[kTile / 2];
    ssd::zero(dg);
    int slot = 0;
    for (int head = me; head < h; head += 2) {
      hop::bar_sync(bar, 128);
      if (tid < kTile) {
        cum_i[tid] = tid < rows_i ? cum_next : 0.0;
      } else {
        const int r = tid - kTile;
        cum_j[r] = r < rows_j ? cum_next : 0.0;
        dt_j[r] = r < rows_j ? dt_next : 0.f;
      }
      load_head(head + 2);
      hop::bar_sync(bar, 128);
      if (!diagonal) {
        // below the diagonal exp(cum_i - cum_j) = u_i w_j, both <= 1
        const double ref = cum_j[kTile - 1];
        if (tid < kTile)
          u_s[tid] = tid < rows_i ? expf((float)(cum_i[tid] - ref)) : 0.f;
        else
          w_s[tid - kTile] = expf((float)(ref - cum_j[tid - kTile]));
        hop::bar_sync(bar, 128);
      }
      ssd::zero(dw);
      for (int t = 0; t < per; ++t) {
        const int sl = slot++;
        const unsigned char* stage = ring.stage(me, sl);
        const float* raw = reinterpret_cast<const float*>(stage + L::kSource);
        ring.wait_full(me, sl);
        ssd::split_natural(reinterpret_cast<const T*>(stage), staged_ld<T>(kK),
                           kTile, pl.hi, pl.lo, tid);
        ssd::Frag a;
        ssd::build(a, [&](int kk, int e) {
          return raw[ln.a_row(e) * kLdRows + ln.a_col(kk, e)];
        });
        ring.release(me, sl);
        ssd::planes_ready(bar);
        ssd::issue<kTile>(dw, a, pl.hi, pl.lo);
      }
      // E_ij = dW_ij G_ij exp(cum_i - cum_j): R's row sums (E dt_j) and
      // E's column sums over this tile pair from the same values; dG +=
      // dW o f, f_ij = exp(cum_i - cum_j) dt_j
      float rsum[2] = {0.f, 0.f};
      float csum[kTile / 8][2];
#pragma unroll
      for (int jj = 0; jj < kTile / 8; ++jj) {
        csum[jj][0] = csum[jj][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = ln.c_row(e);
          const int jl = ln.c_col(jj, e);
          float fe;
          if (diagonal)
            fe = jl <= il && il < rows_i
                     ? expf((float)(cum_i[il] - cum_j[jl]))
                     : 0.f;
          else
            fe = u_s[il] * w_s[jl];
          const float wf = dw[4 * jj + e] * fe;
          const float ev = wf * g_s[il * L::LDG + jl];
          rsum[e >> 1] += ev * dt_j[jl];
          csum[jj][e & 1] += ev;
          dg[4 * jj + e] += wf * dt_j[jl];
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float sum = ssd::quad_sum(rsum[half]);
        const int il = ln.c_row(2 * half);
        if (ln.q == 0 && il < rows_i)
          r_part[((t0 + i0 + il) * tiles + tj) * h + head] = sum;
      }
      // E's column sums: the warp's rows (lanes of one q), then the four
      // warps in order
#pragma unroll
      for (int jj = 0; jj < kTile / 8; ++jj)
#pragma unroll
        for (int q2 = 0; q2 < 2; ++q2) {
          float v = csum[jj][q2];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (ln.g == 0) col_s[ln.w * kTile + ln.c_col(jj, q2)] = v;
        }
      hop::bar_sync(bar, 128);
      if (tid < rows_j)
        e_part[((t0 + j0 + tid) * tiles + ti) * h + head] =
            ((col_s[tid] + col_s[kTile + tid]) + col_s[2 * kTile + tid]) +
            col_s[3 * kTile + tid];
    }
    // consumer 0's heads' sum plus consumer 1's, then out
    if (me == 1) {
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) hand_over[i * 128 + tid] = dg[i];
    }
    hop::bar_sync(ssd::kBothBar, 256);
    if (me == 0) {
      float* out = dG + (((size_t)row * nc + c) * pairs +
                         pair_index(ti, tj)) *
                            (kTile * kTile);
#pragma unroll
      for (int jj = 0; jj < kTile / 8; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 2 * half;
          ssd::store2(
              out + ln.c_row(e) * kTile + ln.c_col(jj, 0),
              make_float2(dg[4 * jj + e] + hand_over[(4 * jj + e) * 128 + tid],
                          dg[4 * jj + e + 1] +
                              hand_over[(4 * jj + e + 1) * 128 + tid]));
        }
    }
  }
}

// ---------------------------------------------------------------- 5. dt
// A block a (chunk, 8 heads, batch row): first, all threads, each step's
// part of d.cum (R's row sum from the dG kernel's per-tile parts, in
// order, E's column sum, the entering state's term, V) into shared memory;
// then one thread a head: d.cum's reverse sum in f64 within the chunk, ddt,
// and dt . d.a for dA.  terms: entering, V, each (b, s, h); r_part and
// e_part: R's row sums and E's column sums a tile pair, (b, s, tiles, h).
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
                      const float* __restrict__ e_part,
                      float* __restrict__ ddt, float* __restrict__ dA_part,
                      int b, int s, int h, int chunk, int nc, int parts) {
  const int hb = (h + kDtHeads - 1) / kDtHeads;
  const int c = blockIdx.x / hb;
  const int h0 = (blockIdx.x - c * hb) * kDtHeads;
  const int row = blockIdx.y;
  const int tiles = (chunk + kTile - 1) / kTile;
  const size_t plane = (size_t)b * s * h;
  const float* entering = terms;
  const float* vv = terms + plane;
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
    float col_sum = 0.f;  // sum_i' E_i'i, tile by tile
    for (int it = i / kTile; it < tiles; ++it)
      col_sum += e_part[((t0 + i) * tiles + it) * h + head];
    const double d = dt[at];
    part_s[idx] =
        (double)row_sum - d * col_sum + entering[at] - d * vv[at];
    tv_s[idx] = d * vv[at];
    cv_s[idx] = (double)col_sum + vv[at];
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

// ---------------------------------------------------------------- 6. sums
// Shared memory: each consumer's planes (NB rows), the rings (a stage holds
// a plane source, a raw tile, and a state item's f64 sums and dt of its 64
// rows), the buffer in which consumer 1 hands its sum over, the barriers.
template <int NB>
struct SumLayout {
  static constexpr uint32_t kPlanes = 2 * NB * 128;
  static constexpr uint32_t kSource =
      (uint32_t)ssd::max_of(32 * staged_ld<float>(NB),
                            NB * staged_ld<float>(kK)) * 4;
  static constexpr uint32_t kFactors = kTile * 8 + 8 + kTile * 4 + 120;
  static constexpr uint32_t kStage = kSource + kRawBytes + kFactors;
  static constexpr uint32_t kHandOver = kTile * NB * 4;
  static constexpr uint32_t kFixed = 2 * kPlanes + kHandOver;
  static constexpr int kStages = ssd::stages_for(kFixed, kStage);
  static_assert(kStages > 0, "ssd backward (sums): shared memory");
  static constexpr size_t kBytes = ssd::ring_bytes(kFixed, kStage, kStages);
};

// A block a (tile t of 64 steps, chunk, {dC, dB}, batch row): dC_t = sum_j
// dG_tj B_j + sum_(h, p) exp(cum_ih) dy_i,hp S_h[:, p], or dB_t = sum_i
// dG_it^T C_i + sum_(h, p) w_jh x_j,hp dS'_h[:, p], w_jh = exp(cum_Qh -
// cum_jh) dt_jh; dB, dC in x's type.  The blocks of the extra batch row
// sum dA over (b, chunk) in order.
template <typename T, int P, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_sum_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const T* __restrict__ Bm, const T* __restrict__ Cm,
                       const double* __restrict__ cum,
                       const float* __restrict__ S_in,
                       const float* __restrict__ dS,
                       const float* __restrict__ dy,
                       const float* __restrict__ dG,
                       const float* __restrict__ dA_part,
                       T* __restrict__ dB, T* __restrict__ dC,
                       float* __restrict__ dA, int b, int s, int h, int n,
                       int chunk) {
  using L = SumLayout<NB>;
  const int nc = s / chunk;
  if ((int)blockIdx.y == b) {
    const int head = blockIdx.x * kThreads + threadIdx.x;
    if (head < h) {
      float sum = 0.f;
      for (int k = 0; k < b * nc; ++k) sum += dA_part[(size_t)k * h + head];
      dA[head] = sum;
    }
    return;
  }
  const int tiles = cdiv(chunk, kTile);
  const int role = blockIdx.x & 1;  // 0: dC_t, 1: dB_t
  const int c = (blockIdx.x >> 1) / tiles;
  if (c >= nc) return;
  const int tt = (blockIdx.x >> 1) - c * tiles;
  const int row = blockIdx.y;
  const int r0 = kTile * tt;
  const int rows = min(kTile, chunk - r0);
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;
  const int pairs = tiles * (tiles + 1) / 2;
  const float* dG_c = dG + ((size_t)row * nc + c) * pairs * (kTile * kTile);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t smem_base = hop::smem_addr(smem_raw);
  const uint32_t base = (smem_base + 1023) & ~1023u;
  unsigned char* ring_s = smem_raw + (base - smem_base) + 2 * L::kPlanes;
  float* hand_over =
      reinterpret_cast<float*>(ring_s + 2 * L::kStages * L::kStage);
  const ssd::Ring ring{
      ring_s,
      smem_base + (uint32_t)(reinterpret_cast<unsigned char*>(hand_over) +
                             L::kHandOver - smem_raw),
      L::kStage, L::kStages};
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  // items: the tile pairs' (32 steps each: dC over j <= t, dB over i >= t),
  // then each head's p channels in 32s; item k to consumer k & 1
  const int last_half = kTile * (tiles - 1) + kK < chunk ? 0 : 1;
  const int g_items =
      role == 0 ? 2 * (tt + 1) - (tt == tiles - 1 ? last_half : 0)
                : 2 * (tiles - tt) - last_half;
  const int per_head = cdiv(P, kK);
  const int total = g_items + h * per_head;

  const int tid = threadIdx.x & 127;
  if (threadIdx.x < 128) {
    // ---- producer
    hop::release_registers<ssd::kProducerRegs>();
    ssd::produce(
        ring, total, ssd::Cursor(total, 1),
        [&](const ssd::Cursor& it, unsigned char* sb, ssd::Stager& st) {
          const int k = it.unit;
          float* raw_buf = reinterpret_cast<float*>(sb + L::kSource);
          if (k < g_items) {
            // role 0: B's 32 rows j and dG_t,j; role 1: C's rows i, dG_i,t
            const int u = role == 0 ? k : 2 * tt + k;
            const int k0 = kK * u;
            const int other = k0 / kTile;
            const int half = (k0 / kK) & 1;
            st.tile(reinterpret_cast<T*>(sb), staged_ld<T>(NB),
                    (role == 0 ? Bm : Cm) + (t0 + k0) * n, n, kK,
                    min(kK, chunk - k0), NB, n);
            if (role == 0)
              st.tile(raw_buf, kLdRows,
                      dG_c + (size_t)pair_index(tt, other) * (kTile * kTile) +
                          kK * half,
                      kTile, kTile, kTile, kK, kK);
            else
              st.tile(raw_buf, kLdCols,
                      dG_c + (size_t)pair_index(other, tt) * (kTile * kTile) +
                          kK * half * kTile,
                      kTile, kK, kK, kTile, kTile);
          } else {
            const int si = k - g_items;
            const int head = si / per_head;
            const int p0 = kK * (si - head * per_head);
            const size_t state = (((size_t)row * nc + c) * h + head) * n;
            st.tile(reinterpret_cast<float*>(sb), staged_ld<float>(kK),
                    (role == 0 ? S_in : dS) + state * P + p0, P, NB, n, kK,
                    min(kK, P - p0));
            if (role == 0)
              st.tile(raw_buf, kLdRows, dy + ((t0 + r0) * h + head) * P + p0,
                      (long long)h * P, kTile, rows, kK, min(kK, P - p0));
            else
              st.tile(reinterpret_cast<T*>(raw_buf), staged_ld<T>(kK),
                      x + ((t0 + r0) * h + head) * P + p0, (long long)h * P,
                      kTile, rows, kK, min(kK, P - p0));
            // the rows' f64 sums and dt, and the chunk's last sum
            double* cum_f =
                reinterpret_cast<double*>(sb + L::kSource + kRawBytes);
            float* dt_f = reinterpret_cast<float*>(cum_f + kTile + 1);
            if (st.tid < rows) {
              ssd::cp_async8(cum_f + st.tid,
                             cum + (t0 + r0 + st.tid) * h + head);
              tc::cp_async4(dt_f + st.tid, dt + (t0 + r0 + st.tid) * h + head,
                            4);
            } else if (st.tid == kTile) {
              ssd::cp_async8(cum_f + kTile, cum + (t0 + chunk - 1) * h + head);
            }
          }
        });
  } else {
    // ---- consumers
    hop::claim_registers<ssd::kConsumerRegs>();
    const int me = threadIdx.x / 128 - 1;
    const ssd::Lane ln(tid);
    const int bar = ssd::kConsumerBar + me;
    const ssd::Planes pl{base + me * L::kPlanes,
                         base + me * L::kPlanes + L::kPlanes / 2};
    float acc[NB / 2];
    ssd::zero(acc);
    for (int k = me; k < total; k += 2) {
      const int sl = k >> 1;
      const unsigned char* sb = ring.stage(me, sl);
      const float* raw = reinterpret_cast<const float*>(sb + L::kSource);
      ring.wait_full(me, sl);
      ssd::Frag a;
      if (k < g_items) {
        ssd::split_transposed(reinterpret_cast<const T*>(sb), staged_ld<T>(NB),
                              NB, pl.hi, pl.lo, tid);
        if (role == 1)
          ssd::build(a, [&](int kk, int e) {
            return raw[ln.a_col(kk, e) * kLdCols + ln.a_row(e)];
          });
        else
          ssd::build(a, [&](int kk, int e) {
            return raw[ln.a_row(e) * kLdRows + ln.a_col(kk, e)];
          });
      } else {
        ssd::split_natural(reinterpret_cast<const float*>(sb),
                           staged_ld<float>(kK), NB, pl.hi, pl.lo, tid);
        // each row's factor: exp(cum_i) for dC, w_j for dB
        const double* cum_f =
            reinterpret_cast<const double*>(sb + L::kSource + kRawBytes);
        const float* dt_f = reinterpret_cast<const float*>(cum_f + kTile + 1);
        float f[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = ln.a_row(e);
          f[e] = r >= rows ? 0.f
                 : role == 0
                     ? expf((float)cum_f[r])
                     : expf((float)(cum_f[kTile] - cum_f[r])) * dt_f[r];
        }
        const T* raw_t = reinterpret_cast<const T*>(raw);
        if (role == 0)
          ssd::build(a, [&](int kk, int e) {
            return f[e & 1] * raw[ln.a_row(e) * kLdRows + ln.a_col(kk, e)];
          });
        else
          ssd::build(a, [&](int kk, int e) {
            return f[e & 1] * tc::to_float(raw_t[ln.a_row(e) * staged_ld<T>(kK) +
                                                 ln.a_col(kk, e)]);
          });
      }
      ring.release(me, sl);
      ssd::planes_ready(bar);
      ssd::issue<NB>(acc, a, pl.hi, pl.lo);
    }
    // consumer 0's items' sum plus consumer 1's, then out
    if (me == 1) {
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) hand_over[i * 128 + tid] = acc[i];
    }
    hop::bar_sync(ssd::kBothBar, 256);
    if (me == 0) {
      T* out = role == 0 ? dC : dB;
#pragma unroll
      for (int jj = 0; jj < NB / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = ln.c_row(e);
          const int col = ln.c_col(jj, e);
          if (r < rows && col < n)
            out[(t0 + r0 + r) * n + col] = ssd::from_float<T>(
                acc[4 * jj + e] + hand_over[(4 * jj + e) * 128 + tid]);
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

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *cum, *G, *S_in, *dy, *grad_final;
  void *dx, *ddt, *dA, *dB, *dC, *dh0;
  void *dS, *inner, *terms, *r_part, *e_part, *dG, *dA_part;
  int b, s, h, n, chunk;
};

template <typename T, int P, int NB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int nc = a.s / a.chunk;
  const int tiles = cdiv(a.chunk, kTile);
  const int groups = cdiv(a.h, ssd::kHeads);
  const T* x = static_cast<const T*>(a.x);
  const T* Bm = static_cast<const T*>(a.Bm);
  const T* Cm = static_cast<const T*>(a.Cm);
  const float* dt = static_cast<const float*>(a.dt);
  const double* cum = static_cast<const double*>(a.cum);
  const float* G = static_cast<const float*>(a.G);
  const float* S_in = static_cast<const float*>(a.S_in);
  const float* dy = static_cast<const float*>(a.dy);
  float* dS = static_cast<float*>(a.dS);
  float* terms = static_cast<float*>(a.terms);
  float* r_part = static_cast<float*>(a.r_part);
  float* e_part = static_cast<float*>(a.e_part);
  float* dG = static_cast<float*>(a.dG);
  cudaError_t err;

  constexpr size_t smem1 = ssd::ChunkLayout<P>::kBytes;
  auto local_kernel = ssd::ssd_chunk_kernel<T, float, P, true>;
  if ((err = ssd::allow_smem(local_kernel, smem1)) != cudaSuccess) return err;
  mark(0, stream);
  local_kernel<<<dim3(nc, groups, a.b), kThreads, smem1, stream>>>(
      dy, Cm, Cm, nullptr, nullptr, const_cast<double*>(cum), nullptr, dS,
      a.s, a.h, a.n, a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(1, stream);

  const int parts = pass_blocks(a.n * P);
  ssd_bwd_pass_kernel<<<dim3(parts, a.h, a.b), kPassThreads, 0, stream>>>(
      cum, S_in, static_cast<const float*>(a.grad_final), dS,
      static_cast<float*>(a.dh0), static_cast<float*>(a.inner), a.s, a.h,
      a.n * P, a.chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(2, stream);

  auto dx_kernel = ssd_bwd_dx_kernel<T, P>;
  if ((err = ssd::allow_smem(dx_kernel, DxLayout<P>::bytes(4))) !=
      cudaSuccess)
    return err;
  dx_kernel<<<(unsigned)(nc * tiles * groups * a.b), kThreads,
              DxLayout<P>::bytes(tiles), stream>>>(
      x, dt, Bm, Cm, cum, G, S_in, dS, dy, static_cast<T*>(a.dx), terms, a.b,
      a.s, a.h, a.n, a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(3, stream);

  auto dg_kernel = ssd_bwd_dg_kernel<T, P>;
  if ((err = ssd::allow_smem(dg_kernel, DgLayout::kBytes)) != cudaSuccess)
    return err;
  dg_kernel<<<(unsigned)(nc * (tiles * (tiles + 1) / 2) * a.b), kThreads,
              DgLayout::kBytes, stream>>>(x, dt, cum, G, dy, dG, r_part,
                                          e_part, a.b, a.s, a.h, a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(4, stream);

  const int hb = (a.h + kDtHeads - 1) / kDtHeads;
  const size_t smem5 = dt_smem(a.chunk);
  if ((err = ssd::allow_smem(ssd_bwd_dt_kernel, smem5)) != cudaSuccess)
    return err;
  ssd_bwd_dt_kernel<<<dim3(nc * hb, a.b), kDtThreads, smem5, stream>>>(
      dt, static_cast<const float*>(a.A), cum,
      static_cast<const float*>(a.inner), terms, r_part, e_part,
      static_cast<float*>(a.ddt), static_cast<float*>(a.dA_part), a.b, a.s,
      a.h, a.chunk, nc, parts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(5, stream);

  constexpr size_t smem6 = SumLayout<NB>::kBytes;
  auto sum_kernel = ssd_bwd_sum_kernel<T, P, NB>;
  if ((err = ssd::allow_smem(sum_kernel, smem6)) != cudaSuccess) return err;
  const int blocks6 = max(2 * nc * tiles, cdiv(a.h, kThreads));
  sum_kernel<<<dim3(blocks6, a.b + 1), kThreads, smem6, stream>>>(
      x, dt, Bm, Cm, cum, S_in, dS, dy, dG,
      static_cast<const float*>(a.dA_part), static_cast<T*>(a.dB),
      static_cast<T*>(a.dC), static_cast<float*>(a.dA), a.b, a.s, a.h, a.n,
      a.chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(6, stream);
  return cudaSuccess;
}

// The (head dim p, state width) entries that the port's models and tests
// use, and no others (each costs seconds of nvcc): p 16, 32 and 64 at n <=
// 64; p 64 and 128 at n <= 128.  Null for another: the call then returns
// cudaErrorInvalidValue, and repro_ssd_bwd_built says so beforehand.
using Entry = cudaError_t (*)(const Args&, cudaStream_t);
template <typename T>
Entry entry(int p, int n) {
  if (n <= 64) {
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
// repro_ssd_bwd_scratch gives: dS, inner, terms, r_part, e_part, dG,
// dA_part.  Launches six kernels on `stream`; returns the first launch
// error.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* cum, const void* G, const void* S_in,
    const void* dy, const void* grad_final, void* dx, void* ddt, void* dA,
    void* dB, void* dC, void* dh0, void* dS, void* inner, void* terms,
    void* r_part, void* e_part, void* dG, void* dA_part, int b, int s, int h,
    int p, int n, int chunk, int dtype, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || s < 1 || n < 1 ||
      n > ssd::kMaxState || chunk < 1 || chunk > kMaxChunk ||
      s % chunk != 0 ||
      (long long)(s / chunk) * cdiv(chunk, kTile) * cdiv(h, ssd::kHeads) *
              b > 2147483647LL)
    return cudaErrorInvalidValue;
  const Args a{x,     dt,     A,      Bm,     Cm,   cum,     G,  S_in,
               dy,    grad_final, dx, ddt,    dA,   dB,      dC, dh0,
               dS,    inner,  terms,  r_part, e_part, dG,    dA_part,
               b,     s,      h,      n,      chunk};
  const Entry run = dtype == 0   ? entry<float>(p, n)
                    : dtype == 1 ? entry<__nv_bfloat16>(p, n)
                                 : nullptr;
  if (run == nullptr) return cudaErrorInvalidValue;
  return run(a, static_cast<cudaStream_t>(stream));
}

// 1 if the library holds the entry for head dim p and state n (both
// dtypes), else 0.
extern "C" int repro_ssd_bwd_built(int p, int n) {
  return n >= 1 && n <= ssd::kMaxState && entry<float>(p, n) != nullptr;
}

// The f32 elements of scratch `which` of a call: 0 dS (b, s / chunk, h, n,
// p), 1 inner (b, s / chunk, h, state-passing blocks), 2 terms (2, b, s,
// h), 3 r_part and 4 e_part (b, s, tiles, h), 5 dG (b, s / chunk, tile
// pairs, 64, 64), 6 dA_part (b, s / chunk, h); -1 for another `which`.
extern "C" long long repro_ssd_bwd_scratch(int which, int b, int s, int h,
                                           int p, int n, int chunk) {
  const long long nc = s / chunk, tiles = cdiv(chunk, kTile);
  const long long bs = (long long)b * s;
  switch (which) {
    case 0: return (long long)b * nc * h * n * p;
    case 1: return (long long)b * nc * h * pass_blocks(n * p);
    case 2: return 2 * bs * h;
    case 3: return bs * tiles * h;
    case 4: return bs * tiles * h;
    case 5: return (long long)b * nc * (tiles * (tiles + 1) / 2) * kTile * kTile;
    case 6: return (long long)b * nc * h;
  }
  return -1;
}

// The next calls record events[0 .. n) (cudaEvent_t) on their stream, one
// before each of the six launches and one after the last; n = 0 stops.
extern "C" void repro_ssd_bwd_mark_launches(void* events, int n) {
  g_marks = static_cast<cudaEvent_t*>(events);
  g_n_marks = events == nullptr ? 0 : n;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
