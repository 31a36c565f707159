// The pipeline that every tensor-core launch of the SSD scan runs on
// (ssd_scan.cu, ssd_scan_bwd.cu): one producer warpgroup and two consumer
// warpgroups a block, every product on TF32 `wgmma` in three passes (lo.hi
// + hi.lo + hi.hi, f32 accumulators).
//
// Every product is cut into items of K = 32.  The producer only loads: it
// copies each item's raw tiles by 16-byte cp.async straight into a stage of
// the ring of the consumer that takes the item, and the stage's full
// mbarrier completes when the copies land (cp.async.mbarrier.arrive), so
// the producer never waits for memory.  Each consumer has a ring of its own
// (its stages pass between the producer and it alone, so no wait can run a
// phase ahead) and its own hi and lo planes: it splits the item's B
// operand (N rows x 32 K) from the stage into them once, K-major with the
// 128-byte swizzle as wgmma reads TF32 and transposed where the source runs
// along N (x, dy and the states are p-contiguous), builds the A operand in
// registers (decay-weighted scores, weighted rows of B, C, x or dy), splits
// it there once, and issues the item's 12 wgmmas.  The two consumers take
// different units of work (heads, or items in turn) whose items alternate
// in the producer's order, so one splits and builds while the other's
// products run; where the planes fit twice, a consumer also builds item t
// + 1 under its own item t's products.
//
// What bounds these launches on the card: the operand splits and builds
// (integer and FP32 instructions a value, on the CUDA cores), about as
// long as the three TF32 passes themselves; see PERF.md.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"
#include "cp_async.cuh"

namespace ssd {

constexpr int kTile = 64;       // rows of an output tile (wgmma's M)
constexpr int kK = 32;          // the K extent of one item
constexpr int kMaxChunk = 256;
constexpr int kMaxState = 128;  // n
constexpr int kThreads = 384;   // producer, consumer 0, consumer 1
// setmaxnreg: the block holds 384 x 168 registers from launch; the
// producer's 128 threads give theirs down to 80, and the consumers' 256 take
// 208, within that total (a claim beyond it would wait forever).
constexpr int kProducerRegs = 80;
constexpr int kConsumerRegs = 208;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= kThreads * 168,
              "ssd: registers handed over beyond the block's");
// The chunk launch splits them 96 / 200: at 80 its producer spilled 24 B
// in the backward's P 16 entry, and its consumers need no more than 200.
constexpr int kChunkProducerRegs = 96;
constexpr int kChunkConsumerRegs = 200;
static_assert(128 * kChunkProducerRegs + 256 * kChunkConsumerRegs <=
                  kThreads * 168,
              "ssd chunk: registers handed over beyond the block's");
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kLdRows = 36;     // raw tile of 64 rows x 32
constexpr int kLdCols = 72;     // raw tile of 32 rows x 64
constexpr uint32_t kRawBytes = 64 * kLdRows * 4;
static_assert(32 * kLdCols * 4 == kRawBytes, "raw tiles of one size");

// Named barriers (0 is __syncthreads()'s): the producer warpgroup, each
// consumer, both consumers.
constexpr int kProducerBar = 1;
constexpr int kConsumerBar = 2;  // + consumer
constexpr int kBothBar = 4;

__host__ __device__ constexpr int cdiv(int x, int m) { return (x + m - 1) / m; }
__host__ __device__ constexpr int round_up(int x, int m) {
  return cdiv(x, m) * m;
}
__host__ __device__ constexpr size_t max_of(size_t a, size_t b) {
  return a > b ? a : b;
}

// Staging row length in elements: `cols` and 16 bytes of pad.
template <typename T>
__host__ __device__ constexpr int staged_ld(int cols) {
  return cols + 16 / (int)sizeof(T);
}

// How deep a kernel's pipeline is: the ring stages each consumer has, the
// most (at most 6) that fit in shared memory beside `fixed` bytes.
__host__ __device__ constexpr size_t ring_bytes(size_t fixed, size_t stage,
                                                int stages) {
  return fixed + 2 * stages * stage + 4 * stages * 8 + 1024;
}
__host__ __device__ constexpr int stages_for(size_t fixed, size_t stage) {
  int best = 0;
  for (int s = 1; s <= 6; ++s)
    if (ring_bytes(fixed, stage, s) <= kMaxSmem) best = s;
  return best;
}

// ------------------------------------------------------------- the ring
// Waits until phase `parity` of mbarrier `bar` has completed.  A wait that
// lasts ten seconds (a fault in an item sequence, never a slow card) stops
// the kernel with a trap, which the next synchronisation reports, instead
// of hanging the card.
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spins & 1023) == 1023) {
      const uint64_t t = now_ns();
      if (start == 0)
        start = t;
      else if (t - start > 10000000000ull)
        __trap();
    }
  }
}

// Each consumer has a ring of its own (`stages` stages of raw tiles, full
// and empty barriers): a stage only ever passes between the producer and
// one consumer, so no wait can run a phase ahead of its stage.  Slot n of
// consumer c is the n-th item that consumer takes.  The producer's 128
// threads arrive on a full barrier twice: once when their cp.async copies
// into the stage have landed, once (with release semantics) after their
// plain stores.
struct Ring {
  unsigned char* smem;  // stage 0 of consumer 0 (16-byte aligned)
  uint32_t bars;        // full[2 x stages], then empty[2 x stages]
  uint32_t stage_bytes;
  int stages;
  __device__ __forceinline__ unsigned char* stage(int c, int n) const {
    return smem + (size_t)(c * stages + n % stages) * stage_bytes;
  }
  __device__ __forceinline__ uint32_t full(int c, int n) const {
    return bars + 8 * (c * stages + n % stages);
  }
  __device__ __forceinline__ uint32_t empty(int c, int n) const {
    return bars + 8 * (2 * stages + c * stages + n % stages);
  }
  // The producer: waits until slot n's stage is free.
  __device__ __forceinline__ void acquire(int c, int n) const {
    if (n >= stages) wait(empty(c, n), ((n / stages) - 1) & 1);
  }
  // The producer, after it has issued slot n's copies and stores.
  __device__ __forceinline__ void publish(int c, int n) const {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     full(c, n))
                 : "memory");
    hop::mbar_arrive(full(c, n));
  }
  __device__ __forceinline__ void wait_full(int c, int n) const {
    wait(full(c, n), (n / stages) & 1);
  }
  __device__ __forceinline__ void release(int c, int n) const {
    hop::mbar_arrive(empty(c, n));
  }
  // Thread 0.
  __device__ __forceinline__ void init() const {
    for (int i = 0; i < 2 * stages; ++i) hop::mbar_init(bars + 8 * i, 256);
    for (int i = 2 * stages; i < 4 * stages; ++i)
      hop::mbar_init(bars + 8 * i, 128);
    hop::mbar_init_fence();
  }
};

// The items of a pass over `units` units of `per` items each, in the
// order the producer hands them out: unit u goes to consumer u & 1, and
// the items of units 2m and 2m + 1 alternate, so that both consumers have
// work at once; an odd last unit's items follow alone.  A consumer takes
// its own units in order, u = c, c + 2, ..., which is the same order.
struct Cursor {
  int units, per;
  int unit = 0, t = 0;
  __device__ __forceinline__ Cursor(int units_, int per_)
      : units(units_), per(per_) {}
  __device__ __forceinline__ void next() {
    if (unit < (units & ~1)) {
      if ((unit & 1) == 0) {
        ++unit;
      } else if (++t < per) {
        --unit;
      } else {
        t = 0;
        ++unit;
      }
    } else {
      ++t;
    }
  }
};

// Two passes in a row: the first's items, then the second's.
struct Cursor2 {
  Cursor a, b;
  int left;  // the first pass's items still to come
  bool first;
  int unit, t;
  __device__ __forceinline__ Cursor2(Cursor a_, Cursor b_)
      : a(a_), b(b_), left(a_.units * a_.per) {
    sync();
  }
  __device__ __forceinline__ void sync() {
    first = left > 0;
    unit = first ? a.unit : b.unit;
    t = first ? a.t : b.t;
  }
  __device__ __forceinline__ void next() {
    if (left > 0) {
      a.next();
      --left;
    } else {
      b.next();
    }
    sync();
  }
};

// --------------------------------------------------------------- staging
// Copies tiles into shared memory, by `threads` threads: by 16-byte
// cp.async where the rows allow it, else by plain loads.
struct Stager {
  int tid;
  int threads = 128;
  // dst[r * ldd + c] = src[r * lds + c] for r < rows_valid, c <
  // cols_valid, and zero elsewhere in rows x cols.
  template <typename T>
  __device__ __forceinline__ void tile(T* dst, int ldd, const T* src,
                                       long long lds, int rows,
                                       int rows_valid, int cols,
                                       int cols_valid) {
    constexpr int E = 16 / (int)sizeof(T);
    if (cols_valid % E == 0 && tc::aligned16(src, lds)) {
      const int chunks = cols / E;
      for (int idx = tid; idx < rows * chunks; idx += threads) {
        const int r = idx / chunks;
        const int c = (idx - r * chunks) * E;
        const bool in = r < rows_valid && c < cols_valid;
        tc::cp_async16(dst + r * ldd + c, in ? src + r * lds + c : src,
                       in ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < rows * cols; idx += threads) {
        const int r = idx / cols;
        const int c = idx - r * cols;
        dst[r * ldd + c] = r < rows_valid && c < cols_valid
                               ? src[r * lds + c]
                               : static_cast<T>(0.f);
      }
    }
  }
};

// The producer's loop over the `total` items that a cursor of type C
// walks: fetch(item, stage, stager) copies an item's raw tiles into the
// stage of consumer item.unit & 1, as soon as that stage is free.  The
// producer never waits for its copies.
template <typename C, typename Fetch>
__device__ __forceinline__ void produce(const Ring& ring, int total, C it,
                                        Fetch fetch) {
  Stager st{(int)(threadIdx.x & 127)};
  int n0 = 0, n1 = 0;
  for (int k = 0; k < total; ++k) {
    const int c = it.unit & 1;
    const int n = c ? n1++ : n0++;
    ring.acquire(c, n);
    fetch(it, ring.stage(c, n), st);
    ring.publish(c, n);
    it.next();
  }
}

// A consumer's hi and lo planes (N rows x 32 K each), which it splits each
// item's B operand into and its products read; the split's stores are
// fenced for the async proxy and the consumer's 128 threads meet before a
// product.
struct Planes {
  uint32_t hi, lo;
};
__device__ __forceinline__ void planes_ready(int bar) {
  hop::fence_proxy_async();
  hop::bar_sync(bar, 128);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// x = hi + lo to ~2^-22 relative, each a TF32 value rounded to nearest
// with ties away from zero: the bits cvt.rna.tf32 gives, by two integer
// operations (half a TF32 unit added to the magnitude, the 13 low bits
// cleared) instead of a conversion, whose pipe is the narrower one.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(float4 x, uint4& hi, uint4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint4 x) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}

// Byte offset of element (row r, column k < 32) in a plane.
__device__ __forceinline__ uint32_t swz(int r, int k) {
  return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t x,
                                          uint32_t y) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(x),
               "r"(y)
               : "memory");
}

// Planes of nr rows from a staged tile of 32 rows (K) x nr columns (N):
// element (k, r) goes to plane row r, column k.  A thread takes rows 2 kp
// and 2 kp + 1 of four columns and stores each column's pair at once.
template <typename T>
__device__ __forceinline__ void split_transposed(const T* src, int ld, int nr,
                                                 uint32_t hi, uint32_t lo,
                                                 int tid) {
  for (int idx = tid; idx < 4 * nr; idx += 128) {
    const int k = 2 * (idx & 15);
    const int r = (idx >> 4) * 4;
    uint4 h0, l0, h1, l1;
    split4(load4(src + k * ld + r), h0, l0);
    split4(load4(src + (k + 1) * ld + r), h1, l1);
    st_shared(hi + swz(r, k), h0.x, h1.x);
    st_shared(hi + swz(r + 1, k), h0.y, h1.y);
    st_shared(hi + swz(r + 2, k), h0.z, h1.z);
    st_shared(hi + swz(r + 3, k), h0.w, h1.w);
    st_shared(lo + swz(r, k), l0.x, l1.x);
    st_shared(lo + swz(r + 1, k), l0.y, l1.y);
    st_shared(lo + swz(r + 2, k), l0.z, l1.z);
    st_shared(lo + swz(r + 3, k), l0.w, l1.w);
  }
}

// Planes of nr rows from a staged tile of nr rows (N) x 32 columns (K).
template <typename T>
__device__ __forceinline__ void split_natural(const T* src, int ld, int nr,
                                              uint32_t hi, uint32_t lo,
                                              int tid) {
  for (int idx = tid; idx < 8 * nr; idx += 128) {
    const int r = idx >> 3;
    const int c = (idx & 7) * 4;
    uint4 h, l;
    split4(load4(src + r * ld + c), h, l);
    st_shared(hi + swz(r, c), h);
    st_shared(lo + swz(r, c), l);
  }
}

// ------------------------------------------------------------- products
// A consumer thread's place in its warpgroup: warp w, lane 4 g + q.  Its
// A fragment of a k-step holds (row, column) (16 w + g + 8 (e & 1), q + 4
// (e >> 1)) as element e; its accumulator element 4 j + e is (16 w + g + 8
// (e >> 1), 8 j + 2 q + (e & 1)).
struct Lane {
  int w, g, q;
  __device__ __forceinline__ explicit Lane(int tid)
      : w(tid >> 5), g((tid & 31) >> 2), q(tid & 3) {}
  __device__ __forceinline__ int a_row(int e) const {
    return 16 * w + g + 8 * (e & 1);
  }
  __device__ __forceinline__ int a_col(int kk, int e) const {
    return 8 * kk + q + 4 * (e >> 1);
  }
  __device__ __forceinline__ int c_row(int e) const {
    return 16 * w + g + 8 * (e >> 1);
  }
  __device__ __forceinline__ int c_col(int j, int e) const {
    return 8 * j + 2 * q + (e & 1);
  }
};

// An item's A operand, split once: element e of k-step kk is f(kk, e).
struct Frag {
  uint32_t hi[4][4], lo[4][4];
};
template <typename F>
__device__ __forceinline__ void build(Frag& a, F f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) split(f(kk, e), a.hi[kk][e], a.lo[kk][e]);
}

// acc (64 x N) += A . the item's planes, lo.hi + hi.lo + hi.hi a k-step,
// issued as one group; wait_mma waits for it.  A's registers and the
// planes must stay as they are until then.
template <int N>
__device__ __forceinline__ void issue_async(float (&acc)[N / 2],
                                            const Frag& a, uint32_t hi,
                                            uint32_t lo) {
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bh = hop::descriptor(hi + 32 * kk, 16, 1024, 1);
    const uint64_t bl = hop::descriptor(lo + 32 * kk, 16, 1024, 1);
    hop::wgmma_rs_tf32<N>(acc, a.lo[kk], bh, 1);
    hop::wgmma_rs_tf32<N>(acc, a.hi[kk], bl, 1);
    hop::wgmma_rs_tf32<N>(acc, a.hi[kk], bh, 1);
  }
  hop::wgmma_commit();
}
template <int N>
__device__ __forceinline__ void wait_mma(float (&acc)[N / 2]) {
  hop::wgmma_wait<0>();
  hop::fence_registers(acc);
}
template <int N>
__device__ __forceinline__ void issue(float (&acc)[N / 2], const Frag& a,
                                      uint32_t hi, uint32_t lo) {
  issue_async<N>(acc, a, hi, lo);
  wait_mma<N>(acc);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// 8 bytes from global to shared memory (an f64 of a strided column).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   hop::smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

// The lower-triangle tile pair `pair` of a chunk: (ti, tj), tj <= ti.
__device__ __forceinline__ void tile_pair(int pair, int& ti, int& tj) {
  ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= pair) ++ti;
  tj = pair - ti * (ti + 1) / 2;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ====================================================== the chunk launch
constexpr int kHeads = 8;  // heads a block of the chunk, output and dx launches

// ----------------------------------------------------------- 1. chunk
// Shared memory: each consumer's planes (max(64, P) rows), the rings (a
// stage holds a plane source and a raw tile), the group's weights (kHeads x
// kMaxChunk f32), the barriers.
template <int P>
struct ChunkLayout {
  static constexpr int NR = P > kTile ? P : kTile;
  static constexpr uint32_t kPlanes = 2 * NR * 128;
  static constexpr uint32_t kSource = round_up(
      (int)max_of(32 * staged_ld<float>(P), kTile * kLdRows) * 4, 128);
  static constexpr uint32_t kStage = kSource + kRawBytes;
  static constexpr uint32_t kWeights = kHeads * kMaxChunk * 4;
  static constexpr uint32_t kFixed = 2 * kPlanes + kWeights;
  static constexpr int kStages = stages_for(kFixed, kStage);
  static_assert(kStages > 0, "ssd chunk: shared memory");
  static constexpr size_t kBytes = ring_bytes(kFixed, kStage, kStages);
};

// Forward (kBwd false): planes from x, raw rows from B, weights w_j =
// dt_j exp(cum_last - cum_j) from the cumulative sums it computes and
// writes, and the group's tile pairs of G; out = the chunk states.
// Backward (kBwd true, from ssd_scan_bwd.cu): planes from dy, raw rows
// from C, weights exp(cum_i) from the forward's sums; out = each chunk's
// local state gradient sum_i exp(cum_i) C_i dy_i^T.  out: (b, nc, h, n, P).
template <typename T, typename TP, int P, bool kBwd>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_kernel(const TP* __restrict__ planes_src,
                     const T* __restrict__ rows_src,
                     const T* __restrict__ Cm, const float* __restrict__ dt,
                     const float* __restrict__ A, double* __restrict__ cum,
                     float* __restrict__ G, float* __restrict__ out, int s,
                     int h, int n, int chunk) {
  using L = ChunkLayout<P>;
  const int c = blockIdx.x;
  const int grp = blockIdx.y;
  const int groups = gridDim.y;
  const int row = blockIdx.z;
  const int nc = gridDim.x;
  const int hd0 = grp * kHeads;
  const int heads = min(h, hd0 + kHeads) - hd0;
  const size_t t0 = (size_t)row * s + (size_t)c * chunk;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t smem_base = hop::smem_addr(smem_raw);
  const uint32_t base = (smem_base + 1023) & ~1023u;
  unsigned char* ring_s = smem_raw + (base - smem_base) + 2 * L::kPlanes;
  float* wgt_s =
      reinterpret_cast<float*>(ring_s + 2 * L::kStages * L::kStage);
  const Ring ring{ring_s,
                  smem_base + (uint32_t)(reinterpret_cast<unsigned char*>(
                                             wgt_s) + L::kWeights - smem_raw),
                  L::kStage, L::kStages};

  // ---- the weights of the group's heads, one warp a head
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < heads) {
    const int head = hd0 + warp;
    float* wgt = wgt_s + warp * kMaxChunk;
    const int per = cdiv(chunk, 32);
    const int j0 = min(chunk, lane * per);
    const int j1 = min(chunk, j0 + per);
    if constexpr (kBwd) {
      for (int j = lane; j < kMaxChunk; j += 32)
        wgt[j] = j < chunk ? expf((float)cum[(t0 + j) * h + head]) : 0.f;
    } else {
      // the chunk's inclusive sums of dt * A in f64: each lane its steps,
      // then a scan over the lanes
      const float a = A[head];
      double own = 0.0;
      for (int j = j0; j < j1; ++j)
        own += (double)(dt[(t0 + j) * h + head] * a);
      double incl = own;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      double run = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) run = 0.0;
      const double last = __shfl_sync(0xffffffffu, incl, 31);
      for (int j = j0; j < j1; ++j) {
        const float d = dt[(t0 + j) * h + head];
        run += (double)(d * a);
        cum[(t0 + j) * h + head] = run;
        wgt[j] = expf((float)(last - run)) * d;
      }
      for (int j = chunk + lane; j < kMaxChunk; j += 32) wgt[j] = 0.f;
    }
  }
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  // units: the group's tile pairs of G (forward), then (head, 64 state
  // rows) pairs
  const int tiles = cdiv(chunk, kTile);
  const int pairs = tiles * (tiles + 1) / 2;
  const int g_units = kBwd || pairs <= grp ? 0 : cdiv(pairs - grp, groups);
  const int g_per = cdiv(n, kK);
  const int halves = cdiv(n, kTile);
  const int s_units = heads * halves;
  const int s_per = cdiv(chunk, kK);
  const int total = g_units * g_per + s_units * s_per;

  const int tid = threadIdx.x & 127;
  if (threadIdx.x < 128) {
    // ---- producer
    hop::release_registers<kChunkProducerRegs>();
    produce(ring, total,
            Cursor2(Cursor(g_units, g_per), Cursor(s_units, s_per)),
            [&](const Cursor2& it, unsigned char* stage, Stager& st) {
              T* raw = reinterpret_cast<T*>(stage + L::kSource);
              if (it.first) {
                int ti, tj;
                tile_pair(grp + groups * it.unit, ti, tj);
                const int k0 = kK * it.t;
                st.tile(reinterpret_cast<T*>(stage), staged_ld<T>(kK),
                        rows_src + (t0 + kTile * tj) * n + k0, n, kTile,
                        min(kTile, chunk - kTile * tj), kK, min(kK, n - k0));
                st.tile(raw, staged_ld<T>(kK), Cm + (t0 + kTile * ti) * n + k0,
                        n, kTile, min(kTile, chunk - kTile * ti), kK,
                        min(kK, n - k0));
              } else {
                const int head = hd0 + it.unit / halves;
                const int n0 = kTile * (it.unit % halves);
                const int j0 = kK * it.t;
                const int rows = min(kK, chunk - j0);
                st.tile(reinterpret_cast<TP*>(stage), staged_ld<TP>(P),
                        planes_src + ((t0 + j0) * h + head) * P,
                        (long long)h * P, kK, rows, P, P);
                st.tile(raw, kLdCols, rows_src + (t0 + j0) * n + n0, n, kK,
                        rows, kTile, min(kTile, n - n0));
              }
            });
  } else {
    // ---- consumers: units me, me + 2, ... of each pass
    hop::claim_registers<kChunkConsumerRegs>();
    const int me = threadIdx.x / 128 - 1;
    const int bar = kConsumerBar + me;
    const Lane ln(tid);
    const Planes pl{base + me * L::kPlanes, base + me * L::kPlanes + L::kPlanes / 2};
    int slot = 0;
    for (int u = me; u < g_units; u += 2) {
      float acc_g[kTile / 2];
      zero(acc_g);
      for (int t = 0; t < g_per; ++t) {
        const int sl = slot++;
        const unsigned char* stage = ring.stage(me, sl);
        const T* raw = reinterpret_cast<const T*>(stage + L::kSource);
        ring.wait_full(me, sl);
        split_natural(reinterpret_cast<const T*>(stage), staged_ld<T>(kK),
                      kTile, pl.hi, pl.lo, tid);
        Frag a;
        build(a, [&](int kk, int e) {
          return tc::to_float(
              raw[ln.a_row(e) * staged_ld<T>(kK) + ln.a_col(kk, e)]);
        });
        ring.release(me, sl);
        planes_ready(bar);
        issue<kTile>(acc_g, a, pl.hi, pl.lo);
      }
      int ti, tj;
      tile_pair(grp + groups * u, ti, tj);
      float* G_c = G + ((size_t)row * nc + c) * chunk * chunk;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = kTile * ti + ln.c_row(e);
          const int jj = kTile * tj + ln.c_col(j, e);
          if (i < chunk && jj < chunk)
            G_c[(size_t)i * chunk + jj] = acc_g[4 * j + e];
        }
    }
    for (int u = me; u < s_units; u += 2) {
      const int hl = u / halves;
      const int n0 = kTile * (u % halves);
      float acc[P / 2];
      zero(acc);
      for (int t = 0; t < s_per; ++t) {
        const int sl = slot++;
        const unsigned char* stage = ring.stage(me, sl);
        const T* raw = reinterpret_cast<const T*>(stage + L::kSource);
        const float* wgt = wgt_s + hl * kMaxChunk + kK * t;
        ring.wait_full(me, sl);
        split_transposed(reinterpret_cast<const TP*>(stage), staged_ld<TP>(P),
                         P, pl.hi, pl.lo, tid);
        Frag a;
        build(a, [&](int kk, int e) {
          const int k_ = ln.a_col(kk, e);
          return wgt[k_] * tc::to_float(raw[k_ * kLdCols + ln.a_row(e)]);
        });
        ring.release(me, sl);
        planes_ready(bar);
        issue<P>(acc, a, pl.hi, pl.lo);
      }
      float* out_c = out + (((size_t)row * nc + c) * h + hd0 + hl) * n * P;
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = n0 + ln.c_row(2 * half);
          if (r < n)
            *reinterpret_cast<float2*>(out_c + (size_t)r * P +
                                       ln.c_col(j, 0)) =
                make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
    }
  }
}

}  // namespace ssd
