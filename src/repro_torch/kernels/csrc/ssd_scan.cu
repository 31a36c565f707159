// Mamba2 SSD chunk scan for Hopper (sm_90a), on TF32 wgmma.
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
// Scratch, from the caller, which the backward reads: cum (b, s, h) f64,
// G = C.B^T (b, nc, Q, Q) f32 and the states entering each chunk (b, nc, h,
// n, p) f32, nc = s / Q.
//
// What bounds it: operations.  Per chunk, C.B^T over the Q (Q + 1) / 2
// pairs once for all heads (they share B and C), then per head the
// decay-weighted scores times x, C times the entering state and the chunk
// state, Q n p multiply-adds each: far above the ~20 operations per byte
// the card needs before compute is the limit.  Every product runs on
// TF32 wgmma in three passes (f32-accurate), on the pipeline of
// ssd_pipe.cuh: a producer warpgroup copies raw tiles into each consumer's
// ring; two consumer warpgroups split each B operand into TF32 hi and lo
// planes once (transposing x and the states as they split them), build
// their A operands in registers and take turns at the tensor cores.  The
// design is the chunked SSD of Mamba2 (arXiv:2405.21060 section 7): the
// TPU grid walks the chunks in order and carries the state in VMEM; here
// only the short state recurrence is serial, in three kernels launched in
// order on one stream:
//   1. chunk, grid (chunk, group of 8 heads, b): the group's f64
//      cumulative sums (one warp a head, a scan over the lanes), the
//      tile pairs of G = C.B^T that fall to the group (A: C from
//      registers; B: B's planes), and each head's chunk state S_c =
//      (w B)^T x, w_j = dt_j exp(cum_last - cum_j) (A: w_j B_j from
//      registers; B: x's transposed planes);
//   2. state passing, grid (n p / 256, h, b): S_in(c + 1) = exp(cum_last)
//      S_in(c) + S_c from h0 or zero, written over S_c, and the final
//      state: the one serial pass, short and memory-bound;
//   3. output, one block a (row tile, group of 8 heads, chunk, b), the row
//      tiles that read the same x tiles side by side and the heaviest
//      first: the block copies the row tile's G tiles once, for all its
//      heads, and C's rows; per head, y = (exp(cum_i) C_i) . S_in (B:
//      S_in's transposed planes) plus the decay-weighted G tile . x over
//      the tiles at or below the diagonal (B: x's transposed planes).
//      Below the diagonal every weight factors as G_ij u_i w_j against one
//      reference, the step before the row tile: u_i = exp(cum_i - ref), w_j
//      = exp(ref - cum_j) dt_j, both <= 1, formed once a head; on the
//      diagonal each weight comes from its own f64 difference.  A consumer
//      builds the next item under the current item's products.
// G goes through device memory once and is read once a block, not once a
// head; x is read by launches 1 and 3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "ssd_pipe.cuh"

namespace {

using ssd::cdiv;
using ssd::kK;
using ssd::kMaxChunk;
using ssd::kThreads;
using ssd::kTile;
using ssd::staged_ld;

// ------------------------------------------------------- 2. state passing
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


// ------------------------------------------------------------- 3. output
// Shared memory: each consumer's planes (P rows; two pairs where they
// fit), the rings (a stage holds one x or state tile), the row tile's G
// tiles (rows of LDG; sized at launch), C's 64 rows, each consumer's
// cumulative sums, dt and a head's factors u and w, the barriers.
template <int P>
struct OutLayout {
  // two plane pairs a consumer (the next item's split under the current
  // item's products) where they fit, one at P 128
  static constexpr int kPairs = P <= 64 ? 2 : 1;
  static constexpr uint32_t kPlanes = kPairs * 2 * P * 128;
  static constexpr uint32_t kStage = 32 * staged_ld<float>(P) * 4;
  static constexpr uint32_t kC = kTile * (ssd::kMaxState + 4) * 4;
  static constexpr uint32_t kConsumer = kMaxChunk * 16 + kTile * 4;
  static constexpr int LDG = kTile + 4;  // a G tile's rows, read as A(i, j)
  static constexpr uint32_t kGTile = kTile * LDG * 4;
  static constexpr uint32_t kFixedMost =
      2 * kPlanes + 4 * kGTile + kC + 2 * kConsumer;
  static constexpr int kStages = ssd::stages_for(kFixedMost, kStage);
  static_assert(kStages > 0, "ssd output: shared memory");
  static constexpr size_t bytes(int tiles) {
    return ssd::ring_bytes(kFixedMost, kStage, kStages) -
           (4 - tiles) * kGTile;
  }
};

// One block: row tile ti of a chunk for a group of kHeads heads.  Blocks
// are numbered ((row * nc + chunk) * groups + group) * tiles + rank, ti =
// tiles - 1 - rank: the row tiles that read the same x tiles run side by
// side (x comes from L2 after the first), the heaviest first.
template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const T* __restrict__ Cm,
                      const double* __restrict__ cum,
                      const float* __restrict__ G,
                      const float* __restrict__ S, float* __restrict__ y,
                      int b, int s, int h, int n, int chunk) {
  using L = OutLayout<P>;
  const int tiles = cdiv(chunk, kTile);
  const int nc = s / chunk;
  const int groups = cdiv(h, ssd::kHeads);
  const int ti = tiles - 1 - blockIdx.x % tiles;
  const int r1 = blockIdx.x / tiles;
  const int hd0 = (r1 % groups) * ssd::kHeads;
  const int c = (r1 / groups) % nc;
  const int row = r1 / groups / nc;
  const int heads = min(h, hd0 + ssd::kHeads) - hd0;
  const int i0 = kTile * ti;
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t smem_base = hop::smem_addr(smem_raw);
  const uint32_t base = (smem_base + 1023) & ~1023u;
  unsigned char* ring_s = smem_raw + (base - smem_base) + 2 * L::kPlanes;
  unsigned char* after_ring = ring_s + 2 * L::kStages * L::kStage;
  float* g_s = reinterpret_cast<float*>(after_ring);
  T* c_s = reinterpret_cast<T*>(after_ring + tiles * L::kGTile);
  unsigned char* consumer_s = reinterpret_cast<unsigned char*>(c_s) + L::kC;
  // C's rows: n rounded to 32 and 16 bytes of pad
  const int ldc = ssd::round_up(n, kK) + 16 / (int)sizeof(T);
  const ssd::Ring ring{
      ring_s, smem_base + (uint32_t)(consumer_s + 2 * L::kConsumer - smem_raw),
      L::kStage, L::kStages};

  const int tid = threadIdx.x & 127;
  const int need = min(chunk, i0 + kTile);
  // the consumers' first head's sums and dt (two a thread), in flight
  // while the block's tiles load
  const int me = threadIdx.x / 128 - 1;
  double cum_next[2] = {0.0, 0.0};
  float dt_next[2] = {0.f, 0.f};
  auto load_head = [&](int head) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = tid + 128 * q;
      if (head < hd0 + heads && j < need) {
        cum_next[q] = cum[(t0 + j) * h + head];
        dt_next[q] = dt[(t0 + j) * h + head];
      }
    }
  };
  if (me >= 0) load_head(hd0 + me);
  // every thread: the G tiles of row tile ti and C's rows, by cp.async
  {
    ssd::Stager st{(int)threadIdx.x, kThreads};
    const float* G_c = G + ((size_t)row * nc + c) * chunk * chunk;
    for (int tj = 0; tj <= ti; ++tj)
      st.tile(g_s + tj * kTile * L::LDG, L::LDG,
              G_c + (size_t)i0 * chunk + kTile * tj, chunk, kTile,
              min(kTile, chunk - i0), kTile, min(kTile, chunk - kTile * tj));
    st.tile(c_s, ldc, Cm + (t0 + i0) * n, n, kTile, min(kTile, chunk - i0),
            ssd::round_up(n, kK), n);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
  }
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  // a unit is a head: its entering-state items (32 state rows each), then
  // x's items (32 steps each) at or below the diagonal
  const int s_items = cdiv(n, kK);
  const int x_items = 2 * ti + (i0 + kK < chunk ? 2 : 1);
  const int per = s_items + x_items;

  if (threadIdx.x < 128) {
    // ---- producer
    hop::release_registers<ssd::kProducerRegs>();
    ssd::produce(
        ring, heads * per, ssd::Cursor(heads, per),
        [&](const ssd::Cursor& it, unsigned char* stage, ssd::Stager& st) {
          const int head = hd0 + it.unit;
          if (it.t < s_items) {
            const int n0 = kK * it.t;
            st.tile(reinterpret_cast<float*>(stage), staged_ld<float>(P),
                    S + ((((size_t)row * nc + c) * h + head) * n + n0) * P, P,
                    kK, min(kK, n - n0), P, P);
          } else {
            const int j0 = kK * (it.t - s_items);
            st.tile(reinterpret_cast<T*>(stage), staged_ld<T>(P),
                    x + ((t0 + j0) * h + head) * P, (long long)h * P, kK,
                    min(kK, chunk - j0), P, P);
          }
        });
  } else {
    // ---- consumers: heads me, me + 2, ... of the group
    hop::claim_registers<ssd::kConsumerRegs>();
    const int bar = ssd::kConsumerBar + me;
    const ssd::Lane ln(tid);
    const uint32_t my_planes = base + me * L::kPlanes;
    const ssd::Planes pb[2] = {
        {my_planes, my_planes + P * 128},
        {my_planes + (L::kPairs - 1) * 2 * P * 128,
         my_planes + (L::kPairs - 1) * 2 * P * 128 + P * 128}};
    unsigned char* mine = consumer_s + me * L::kConsumer;
    double* cum_s = reinterpret_cast<double*>(mine);
    float* dt_s = reinterpret_cast<float*>(cum_s + kMaxChunk);
    float* u_s = dt_s + kMaxChunk;
    float* w_s = u_s + kTile;
    float acc[P / 2];
    int slot = 0;
    for (int u = me; u < heads; u += 2) {
      const int head = hd0 + u;
      // the head's sums and dt; the next head's loads go out
      hop::bar_sync(bar, 128);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = tid + 128 * q;
        if (j < need) {
          cum_s[j] = cum_next[q];
          dt_s[j] = dt_next[q];
        }
      }
      load_head(head + 2);
      hop::bar_sync(bar, 128);
      // below the diagonal every weight factors as u_i w_j against one
      // reference, the step before the row tile: u_i = exp(cum_i - ref),
      // w_j = exp(ref - cum_j) dt_j, both <= 1 (each from an f64
      // difference; 0 past the chunk)
      if (ti > 0) {
        const double ref = cum_s[i0 - 1];
        if (tid < kTile)
          u_s[tid] = i0 + tid < chunk ? expf((float)(cum_s[i0 + tid] - ref))
                                      : 0.f;
        for (int j = tid; j < i0; j += 128)
          w_s[j] = expf((float)(ref - cum_s[j])) * dt_s[j];
        hop::bar_sync(bar, 128);
      }
      float dec[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = i0 + ln.a_row(e);
        dec[e] = i < chunk ? expf((float)cum_s[i]) : 0.f;
      }
      const float u_row[2] = {ti > 0 ? u_s[ln.a_row(0)] : 0.f,
                              ti > 0 ? u_s[ln.a_row(1)] : 0.f};
      ssd::zero(acc);
      // item t: its planes split into pb[t & 1], its A operand built, while
      // item t - 1's products run
      auto prep = [&](int t, const ssd::Planes& pl, ssd::Frag& a) {
        const int sl = slot++;
        ring.wait_full(me, sl);
        if (t < s_items)
          ssd::split_transposed(
              reinterpret_cast<const float*>(ring.stage(me, sl)),
              staged_ld<float>(P), P, pl.hi, pl.lo, tid);
        else
          ssd::split_transposed(reinterpret_cast<const T*>(ring.stage(me, sl)),
                                staged_ld<T>(P), P, pl.hi, pl.lo, tid);
        ring.release(me, sl);
        if (t < s_items) {
          const int n0 = kK * t;
          ssd::build(a, [&](int kk, int e) {
            return dec[e & 1] *
                   tc::to_float(c_s[ln.a_row(e) * ldc + n0 + ln.a_col(kk, e)]);
          });
        } else {
          const int xi = t - s_items;
          const int tj = xi >> 1;
          const int j0 = kK * xi;
          // G(i, j) of tile tj, row i0 + r, at g[r * LDG + j - j0 + ...]
          const float* g = g_s + tj * kTile * L::LDG + kK * (xi & 1);
          if (tj < ti) {
            ssd::build(a, [&](int kk, int e) {
              return g[ln.a_row(e) * L::LDG + ln.a_col(kk, e)] * u_row[e & 1] *
                     w_s[j0 + ln.a_col(kk, e)];
            });
          } else {
            ssd::build(a, [&](int kk, int e) {
              const int r = ln.a_row(e);
              const int j = j0 + ln.a_col(kk, e);
              const int i = i0 + r;
              return j <= i && i < chunk
                         ? g[r * L::LDG + ln.a_col(kk, e)] *
                               expf((float)(cum_s[i] - cum_s[j])) * dt_s[j]
                         : 0.f;
            });
          }
        }
        hop::fence_proxy_async();
      };
      auto go = [&](const ssd::Planes& pl, const ssd::Frag& a) {
        ssd::wait_mma<P>(acc);
        hop::bar_sync(bar, 128);
        ssd::issue_async<P>(acc, a, pl.hi, pl.lo);
      };
      ssd::Frag a0, a1;
      prep(0, pb[0], a0);
      go(pb[0], a0);
      for (int t = 1; t < per; t += 2) {
        if (L::kPairs == 1) ssd::wait_mma<P>(acc);
        prep(t, pb[1], a1);
        go(pb[1], a1);
        if (t + 1 < per) {
          if (L::kPairs == 1) ssd::wait_mma<P>(acc);
          prep(t + 1, pb[0], a0);
          go(pb[0], a0);
        }
      }
      ssd::wait_mma<P>(acc);
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + ln.c_row(2 * half);
          if (i < chunk)
            *reinterpret_cast<float2*>(y + ((t0 + i) * h + head) * P +
                                       ln.c_col(j, 0)) =
                make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
    }
  }
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* h0, void* y,
                   void* final_state, void* cum, void* G, void* S, int b,
                   int s, int h, int n, int chunk, cudaStream_t stream) {
  const int nc = s / chunk;
  const int tiles = cdiv(chunk, kTile);
  const int groups = cdiv(h, ssd::kHeads);
  const T* xt = static_cast<const T*>(x);
  const T* Ct = static_cast<const T*>(Cm);
  const float* dtf = static_cast<const float*>(dt);
  double* cumd = static_cast<double*>(cum);
  float* Gf = static_cast<float*>(G);
  float* Sf = static_cast<float*>(S);
  cudaError_t err;

  constexpr size_t smem1 = ssd::ChunkLayout<P>::kBytes;
  auto chunk_kernel = ssd::ssd_chunk_kernel<T, T, P, false>;
  if ((err = ssd::allow_smem(chunk_kernel, smem1)) != cudaSuccess) return err;
  chunk_kernel<<<dim3(nc, groups, b), kThreads, smem1, stream>>>(
      xt, static_cast<const T*>(Bm), Ct, dtf, static_cast<const float*>(A),
      cumd, Gf, Sf, s, h, n, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ssd_pass_kernel<<<dim3((n * P + 255) / 256, h, b), 256, 0, stream>>>(
      cumd, static_cast<const float*>(h0), Sf,
      static_cast<float*>(final_state), s, h, n * P, chunk, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  auto out_kernel = ssd_output_kernel<T, P>;
  if ((err = ssd::allow_smem(out_kernel, OutLayout<P>::bytes(4))) !=
      cudaSuccess)
    return err;
  out_kernel<<<(unsigned)(nc * tiles * groups * b), kThreads,
               OutLayout<P>::bytes(tiles), stream>>>(
      xt, dtf, Ct, cumd, Gf, Sf, static_cast<float*>(y), b, s, h, n, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_dim(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* h0,
                        void* y, void* final_state, void* cum, void* G,
                        void* S, int b, int s, int h, int p, int n, int chunk,
                        cudaStream_t stream) {
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
// before it reads.  Launches three kernels on `stream`; returns the first
// launch error.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* h0,
                              void* y, void* final_state, void* cum, void* G,
                              void* S, int b, int s, int h, int p, int n,
                              int chunk, int dtype, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || s < 1 || n < 1 ||
      n > ssd::kMaxState || chunk < 1 || chunk > kMaxChunk ||
      s % chunk != 0 ||
      (long long)(s / chunk) * cdiv(chunk, kTile) * cdiv(h, ssd::kHeads) *
              b > 2147483647LL)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_head_dim<float>(x, dt, A, Bm, Cm, h0, y, final_state, cum, G,
                              S, b, s, h, p, n, chunk, st);
  if (dtype == 1)
    return by_head_dim<__nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, final_state,
                                      cum, G, S, b, s, h, p, n, chunk, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
