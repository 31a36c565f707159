// V-trace targets and policy-gradient advantages for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_vtrace_kernel` / `vtrace` in
// src/repro/kernels/vtrace_kernel.py.  For (T, B) float32 inputs values V,
// next_values V', rewards r, discounts g and importance ratios rho, and the
// clips rho_bar and c_bar:
//
//     rho_c_t = min(rho_t, rho_bar),  c_t = min(rho_t, c_bar)
//     acc_t   = rho_c_t ((r_t + g_t V'_t) - V_t) + (g_t c_t) acc_{t+1},
//               acc_T = 0
//     vs_t    = V_t + acc_t
//     adv_t   = rho_c_t ((r_t + g_t vs_{t+1}) - V_t),  vs_T = V'_{T-1}
//
// exactly the plain version `vtrace_ref` in ../ref.py, in its order of
// operations and with each one rounded as it rounds it (no contraction to
// FMAs), so the kernel's outputs are the plain version's.
//
// Layouts: the five inputs and two outputs share one layout, either
// time-major (element (t, b) at t * B + b) or batch-major (at b * T + t:
// the (T, B) transpose of a contiguous (B, T) tensor, as the learner holds
// its sequences).
//
// What bounds it: bytes.  Each element is read once from five inputs and
// written once to two outputs (28 bytes) for about ten flops, far below the
// ~20 f32 operations per byte the card needs before compute is the limit.
// The recurrence runs backwards along T and is independent across B.  The
// design: one block of four warps per tile of 32 columns.  All threads
// stage the five inputs of a chunk of 32 rows into shared memory with
// `cp.async`, every copy in flight at once (16 bytes a copy where rows or
// columns are whole 16-byte chunks, else 4), walking the chunks from the
// last down, the next chunk double-buffered while this one is computed.
// Within a chunk the work that does not depend on the recurrence (the
// deltas and the discounted traces first, the advantages last) is spread
// over the whole block, and one warp (lane = column) runs only the serial
// chain, acc and vs_{t+1} carried in registers across chunks: at the
// learner's small shapes the time is latency, and a single warp issues one
// dependent instruction every few cycles.  The outputs are stored from
// shared memory, coalesced.  In either layout a 16-byte copy covers four
// consecutive addresses: along b (time-major) or along t (batch-major); the
// batch-major tile keeps each column's rows together and XOR-swizzles its
// 16-byte chunks, so the warp reads four rows of its 32 columns without
// bank conflicts.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kCols = 32;            // columns per block: one warp's lanes
constexpr int kRows = 32;            // rows per chunk
constexpr int kThreads = 128;
constexpr int kInputs = 5;           // V, V', r, g, rho
constexpr int kTile = kRows * kCols;
constexpr int kStages = 2;

// Offset of element (row tl, column c) in a staged tile.
template <bool kBatchMajor>
__device__ __forceinline__ int at(int tl, int c) {
  if (kBatchMajor)
    return c * kRows + ((((tl >> 2) ^ (c & 7)) << 2) | (tl & 3));
  return tl * kCols + c;
}

// Rows 4 q .. 4 q + 3 of column c: one 16-byte read (batch-major) or
// four (time-major).
template <bool kBatchMajor>
__device__ __forceinline__ void get4(const float* tile, int q, int c,
                                     float (&x)[4]) {
  if (kBatchMajor) {
    const float4 f =
        *reinterpret_cast<const float4*>(tile + at<true>(4 * q, c));
    x[0] = f.x;
    x[1] = f.y;
    x[2] = f.z;
    x[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = tile[at<false>(4 * q + i, c)];
  }
}

template <bool kBatchMajor>
__device__ __forceinline__ void put4(float* tile, int q, int c,
                                     const float (&x)[4]) {
  if (kBatchMajor) {
    *reinterpret_cast<float4*>(tile + at<true>(4 * q, c)) =
        make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) tile[at<false>(4 * q + i, c)] = x[i];
  }
}

struct Inputs {
  const float* p[kInputs];
};

// The kernel's phases for one chunk, after its copy is in:
//   A (all threads, elementwise): gc = g min(rho, c_bar) and
//     delta = rho_c ((r + g V') - V), into the two output tiles;
//   B (one warp, lane = column): acc = delta + gc acc and vs = V + acc,
//     row by row from the chunk's last; vs replaces delta;
//   C (all threads, elementwise): adv = rho_c ((r + g vs_{t+1}) - V),
//     replacing gc (vs_{t+1} of the chunk's last row is the first row of
//     the chunk above, or V'_{T-1}: warp 0 leaves it in the V' tile);
//   D (all threads): both outputs stored.
// The serial chain is only B's multiply and add a row; everything else is
// spread over the block.  Every copy slot (a 16- or 4-byte piece of the
// tile) has its offsets worked out once, as they repeat chunk to chunk.
template <bool kBatchMajor, bool kVec>
__global__ void __launch_bounds__(kThreads)
    vtrace_kernel(Inputs in, float* __restrict__ vs,
                  float* __restrict__ pg_adv, int T, int B, float clip_rho,
                  float clip_c) {
  // 40 KB of staged inputs and 8 KB of outputs: the 48 KB a block gets
  // without asking.
  __shared__ __align__(16) float tiles[kStages][kInputs][kTile];
  __shared__ __align__(16) float outs[2][kTile];
  constexpr int kWidth = kVec ? 4 : 1;               // floats a copy
  constexpr int kSlots = kTile / kWidth / kThreads;  // copies a thread
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kCols;
  const int nc = min(kCols, B - b0);
  // element (t, b) of every array is at t * st + b * sb
  const long long st = kBatchMajor ? 1 : B;
  const long long sb = kBatchMajor ? T : 1;
  const int n_chunks = (T + kRows - 1) / kRows;

  // this thread's copy slots: 16-byte pieces run 8 to a row (time-major)
  // or column (batch-major), 4-byte ones 32, so a warp's copies are
  // neighbours in device memory
  int slot_s[kSlots], slot_t[kSlots];
  long long slot_g[kSlots];
  bool slot_in[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int idx = tid + j * kThreads;
    constexpr int kPer = kRows / kWidth;
    const int major = idx / kPer;
    const int minor = (idx % kPer) * kWidth;
    const int tl = kBatchMajor ? minor : major;
    const int cl = kBatchMajor ? major : minor;
    slot_s[j] = at<kBatchMajor>(tl, cl);
    slot_t[j] = tl;
    slot_g[j] = tl * st + cl * sb;
    slot_in[j] = cl < nc;
  }

  // Stage chunk `c` (rows 32 c .. 32 c + 31) into buffer `buf`.  Rows past
  // T and columns past B are not copied: the recurrence skips those rows,
  // and those columns' results are never stored.
  auto issue = [&](int c, int buf) {
    const int nr = min(kRows, T - c * kRows);
    const long long base = (long long)c * kRows * st + b0 * sb;
#pragma unroll
    for (int i = 0; i < kInputs; ++i) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (slot_in[j] && slot_t[j] < nr) {
          float* dst = tiles[buf][i] + slot_s[j];
          const float* src = in.p[i] + base + slot_g[j];
          if (kVec)
            tc::cp_async16(dst, src, 16);
          else
            tc::cp_async4(dst, src, 4);
        }
      }
    }
    tc::cp_async_commit();
  };

  issue(n_chunks - 1, 0);
  float acc = 0.f;
  float vs_next = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const int c = n_chunks - 1 - k;
    const int buf = k % kStages;
    const int nr = min(kRows, T - c * kRows);
    const float* v_s = tiles[buf][0];
    float* nv_s = tiles[buf][1];
    const float* r_s = tiles[buf][2];
    const float* g_s = tiles[buf][3];
    const float* rho_s = tiles[buf][4];
    tc::cp_async_wait<0>();
    // chunk c is in; every thread is done storing the outputs of chunk
    // c + 1, and reading the buffer that chunk c - 1 fills
    __syncthreads();
    if (c > 0) issue(c - 1, (k + 1) % kStages);

    // A: every element of the tile alike (the layouts agree), 4 a step
#pragma unroll
    for (int j = 0; j < kTile / 4 / kThreads; ++j) {
      const int e = 4 * (tid + j * kThreads);
      const float4 v = *reinterpret_cast<const float4*>(v_s + e);
      const float4 nv = *reinterpret_cast<const float4*>(nv_s + e);
      const float4 r = *reinterpret_cast<const float4*>(r_s + e);
      const float4 g = *reinterpret_cast<const float4*>(g_s + e);
      const float4 rho = *reinterpret_cast<const float4*>(rho_s + e);
      auto delta = [&](float v, float nv, float r, float g, float rho) {
        return __fmul_rn(fminf(rho, clip_rho),
                         __fsub_rn(__fadd_rn(r, __fmul_rn(g, nv)), v));
      };
      *reinterpret_cast<float4*>(outs[0] + e) = make_float4(
          delta(v.x, nv.x, r.x, g.x, rho.x), delta(v.y, nv.y, r.y, g.y, rho.y),
          delta(v.z, nv.z, r.z, g.z, rho.z), delta(v.w, nv.w, r.w, g.w, rho.w));
      *reinterpret_cast<float4*>(outs[1] + e) = make_float4(
          __fmul_rn(g.x, fminf(rho.x, clip_c)),
          __fmul_rn(g.y, fminf(rho.y, clip_c)),
          __fmul_rn(g.z, fminf(rho.z, clip_c)),
          __fmul_rn(g.w, fminf(rho.w, clip_c)));
    }
    __syncthreads();

    // B: the serial chain, one warp
    if (tid < 32) {
      const int lane = tid;
      float* edge = nv_s + at<kBatchMajor>(nr - 1, lane);
      if (k == 0)
        vs_next = *edge;  // V'_{T-1}
      else
        *edge = vs_next;  // vs of the chunk above's first row
      // each group of four rows is read one group ahead of its use, so
      // the reads wait behind the chain and not in it
      float d[4], gc[4], v[4];
      get4<kBatchMajor>(outs[0], kRows / 4 - 1, lane, d);
      get4<kBatchMajor>(outs[1], kRows / 4 - 1, lane, gc);
      get4<kBatchMajor>(v_s, kRows / 4 - 1, lane, v);
#pragma unroll
      for (int q = kRows / 4 - 1; q >= 0; --q) {
        float d_next[4], gc_next[4], v_next[4];
        if (q > 0) {
          get4<kBatchMajor>(outs[0], q - 1, lane, d_next);
          get4<kBatchMajor>(outs[1], q - 1, lane, gc_next);
          get4<kBatchMajor>(v_s, q - 1, lane, v_next);
        }
        if (4 * q < nr) {
          float out[4];
#pragma unroll
          for (int i = 3; i >= 0; --i) {
            out[i] = 0.f;
            if (4 * q + i < nr) {
              acc = __fadd_rn(d[i], __fmul_rn(gc[i], acc));
              out[i] = __fadd_rn(v[i], acc);
            }
          }
          put4<kBatchMajor>(outs[0], q, lane, out);
        }
        if (q > 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d[i] = d_next[i];
            gc[i] = gc_next[i];
            v[i] = v_next[i];
          }
        }
      }
      vs_next = outs[0][at<kBatchMajor>(0, lane)];
    }
    __syncthreads();

    // C: four elements a step, as in A; each one's vs_{t+1} is the next
    // row's vs, or for the chunk's last row the edge value in the V' tile
#pragma unroll
    for (int j = 0; j < kTile / 4 / kThreads; ++j) {
      const int e = 4 * (tid + j * kThreads);
      float up[4];
      int rows[4];
      const float4 cur = *reinterpret_cast<const float4*>(outs[0] + e);
      if (kBatchMajor) {  // four rows of one column
        const int c = e >> 5;
        const int q = ((e & 31) >> 2) ^ (c & 7);
        const float edge = nv_s[at<true>(nr - 1, c)];
        const float below =
            4 * q + 4 < nr ? outs[0][at<true>(4 * q + 4, c)] : edge;
        const float vs5[5] = {cur.x, cur.y, cur.z, cur.w, below};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rows[i] = 4 * q + i;
          up[i] = rows[i] + 1 < nr ? vs5[i + 1] : edge;
        }
      } else {  // one row of four columns
        const int tl = e >> 5;
        const float4 nxt = *reinterpret_cast<const float4*>(
            tl + 1 < nr ? outs[0] + e + kCols
                        : nv_s + at<false>(nr - 1, e & 31));
        const float nxt4[4] = {nxt.x, nxt.y, nxt.z, nxt.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rows[i] = tl;
          up[i] = nxt4[i];
        }
      }
      const float4 v = *reinterpret_cast<const float4*>(v_s + e);
      const float4 r = *reinterpret_cast<const float4*>(r_s + e);
      const float4 g = *reinterpret_cast<const float4*>(g_s + e);
      const float4 rho = *reinterpret_cast<const float4*>(rho_s + e);
      const float v4[4] = {v.x, v.y, v.z, v.w};
      const float r4[4] = {r.x, r.y, r.z, r.w};
      const float g4[4] = {g.x, g.y, g.z, g.w};
      const float rho4[4] = {rho.x, rho.y, rho.z, rho.w};
      float adv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        adv[i] = rows[i] < nr
                     ? __fmul_rn(fminf(rho4[i], clip_rho),
                                 __fsub_rn(__fadd_rn(r4[i],
                                                     __fmul_rn(g4[i], up[i])),
                                           v4[i]))
                     : 0.f;
      *reinterpret_cast<float4*>(outs[1] + e) =
          make_float4(adv[0], adv[1], adv[2], adv[3]);
    }
    __syncthreads();

    // D: store vs and adv, coalesced
    const long long base = (long long)c * kRows * st + b0 * sb;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      float* dst = (o == 0 ? vs : pg_adv) + base;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (slot_in[j] && slot_t[j] < nr) {
          if (kVec)
            *reinterpret_cast<float4*>(dst + slot_g[j]) =
                *reinterpret_cast<const float4*>(outs[o] + slot_s[j]);
          else
            dst[slot_g[j]] = outs[o][slot_s[j]];
        }
      }
    }
  }
}

template <bool kBatchMajor, bool kVec>
cudaError_t launch(const Inputs& in, float* vs, float* pg_adv, int T, int B,
                   float clip_rho, float clip_c, cudaStream_t stream) {
  const dim3 grid((B + kCols - 1) / kCols);
  vtrace_kernel<kBatchMajor, kVec><<<grid, kThreads, 0, stream>>>(
      in, vs, pg_adv, T, B, clip_rho, clip_c);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  All
// seven arrays are (T, B) float32 on the current device in one layout:
// time-major (batch_major = 0) or batch-major (batch_major = 1).
extern "C" int repro_vtrace(const void* values, const void* next_values,
                            const void* rewards, const void* discounts,
                            const void* rhos, void* vs, void* pg_adv, int T,
                            int B, int batch_major, float clip_rho,
                            float clip_c, void* stream) {
  if (T < 1 || B < 1) return cudaErrorInvalidValue;
  const Inputs in = {{static_cast<const float*>(values),
                      static_cast<const float*>(next_values),
                      static_cast<const float*>(rewards),
                      static_cast<const float*>(discounts),
                      static_cast<const float*>(rhos)}};
  uintptr_t bases = reinterpret_cast<uintptr_t>(vs) |
                    reinterpret_cast<uintptr_t>(pg_adv);
  for (const float* p : in.p) bases |= reinterpret_cast<uintptr_t>(p);
  // 16-byte copies need every base aligned and the contiguous extent (B
  // time-major, T batch-major) a whole number of 4-element chunks
  const bool vec = (bases & 15) == 0 && (batch_major ? T : B) % 4 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out_vs = static_cast<float*>(vs);
  float* out_adv = static_cast<float*>(pg_adv);
  cudaError_t err;
  if (batch_major)
    err = vec ? launch<true, true>(in, out_vs, out_adv, T, B, clip_rho,
                                   clip_c, st)
              : launch<true, false>(in, out_vs, out_adv, T, B, clip_rho,
                                    clip_c, st);
  else
    err = vec ? launch<false, true>(in, out_vs, out_adv, T, B, clip_rho,
                                    clip_c, st)
              : launch<false, false>(in, out_vs, out_adv, T, B, clip_rho,
                                     clip_c, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
