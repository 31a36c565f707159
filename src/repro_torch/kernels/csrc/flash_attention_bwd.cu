// Flash attention's backward for Hopper (sm_90a), on `wgmma`.
//
// The backward of the forward kernel in flash_attention.cu, which replaces
// the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py; the JAX package differentiates the
// plain attention (`kernels/ref.py::flash_attention_ref`), whose gradients
// these are.  FlashAttention-2's form (Dao 2023, Algorithm 2): with the
// scale c = d^-1/2, the masked scores S = c q.k^T, the rows' log-sum-exp
// `lse` that the forward wrote, and dO the output's gradient,
//
//   P = exp(S - lse),  D = rowsum(dO o O),
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = c dS K,  dK = c dS^T Q,
//
// under the forward's masks by index: with `causal`, key j is seen when
// i >= j and, with a window w > 0, i - j < w; without `causal` every key.
// A row whose band holds no key (i - (sk - 1) >= w) weighs every key 1/sk
// in the forward (its masked scores are a finite -1e30), so it adds dO/sk
// to every dV row and nothing to dQ or dK; those rows are found by index,
// since in f32 -1e30 + log(sk) rounds back to -1e30 and exp(S - lse)
// would give 1.
//
// Layouts as the forward's: q, dq, out, dO (b, h, sq, d); k, v, dk, dv
// (b, kv, sk, d), kv dividing h; each given by its (b, head, position)
// strides with d contiguous.  lse (b, h, sq) f32, contiguous.  f32 or
// bf16, d in {16, 32, 64, 128}, any sq, sk >= 1.
//
// Five products a kept (query, key) pair, each formed once: S and dP, then
// dV, dK and dQ's part.  Three launches in order on one stream:
//   1. rows, one warp a query row: D = rowsum(dO o O) and lse in log2
//      units (+inf for a row that sees no key, so its P is 0), as scratch;
//      it also zeroes the ticket and the dQ counters of launch 2.
//   2. main: a block owns BK keys of one KV head (BK = 64 at d 64 and in
//      bf16; 32 for f32 at d 128, for shared memory, and at d <= 32, for
//      registers) and walks every query head of its group and every query
//      tile of 64 rows that sees its keys (then the tiles of rows that see
//      none, for dV alone).  A loader warpgroup loads each tile's Q and dO
//      rows into registers while the consumer works on the last tile, and
//      stores them into a ring (mbarriers; 2 stages, 1 for f32 at d >= 64;
//      16-byte chunks swizzled by row).  The consumer warpgroup, per tile:
//        S = Q K^T and dP = dO V^T         (M = 64 queries, N = BK keys)
//        P, dS in registers; P^T and dS^T into shared memory
//        dV^T += dO^T P,  dK^T += Q^T dS    (M = d, N = BK; M padded to 64)
//        dQ's part = dS K                   (M = 64 queries, N = d)
//      and hands dQ's part to the loader through a shared buffer; the
//      loader adds it to an f32 sum (b, h, sq, d) in device memory, in the
//      order of the key tiles (below), while the consumer runs the next
//      tile's products.  bf16 at d 128 keeps dV^T's accumulator in shared
//      memory between tiles (128 registers of dK^T and dV^T would leave
//      too few for S and dP).
//   3. dQ: scale the accumulator, convert to the input type (zeros where
//      no key tile added).
//
// On the tensor cores: every product is a `wgmma` with A from registers
// and B from shared memory, K-major, 128-byte swizzle (hopper.cuh).  K, V
// and K^T are written into their B planes once a block; P^T and dS^T
// every tile.  A comes from the staged Q and dO rows (read along or
// across rows: ldmatrix / ldmatrix.trans in bf16), or straight from the
// accumulators of S and dP (P and dS never leave registers for dQ's
// part).  f32 runs three TF32 passes (lo.hi + hi.lo + hi.hi, tf32_mma.cuh),
// each shared-memory operand split once into hi and lo planes as it is
// written, each register operand as it is loaded; dV and dK take each
// tile's product summed apart and added in f32 (tensor cores truncate
// their sums).  bf16 runs one pass, P and dS rounded to bf16 before their
// products, dV and dK accumulated in the wgmma.  TF32 B operands must be
// K-major, so the products that reduce over queries read P^T and dS^T as
// B with dO^T and Q^T as the register A operand, and dQ's part reads K^T
// (keys permuted within each group of 8 to match S's accumulator columns).
//
// Determinism, with no float atomics: each block sums dK and dV in a fixed
// order; dQ's parts of one (query tile, head) are added in the order of
// the key tiles.  A counter per (batch row, head, query tile) holds j + 1
// once key tile j has added; a block with key tile j waits until it reads
// j (the tile before it that sees these queries: the key tiles that see a
// query tile are contiguous), adds, and stores j + 1.  The first key tile
// writes instead of adding.  Why this cannot deadlock: a block takes its
// work by an atomic integer ticket, key tile outermost, so tickets go out
// in the order of the key tiles, and only to blocks that are running.
// Every wait is on a smaller ticket; the smallest unfinished ticket waits
// on none, so it finishes, and so on.  Every block walks its query tiles
// in one order, from the last with `causal` and from the first without, so
// the block of key tile j reaches a tile one step after key tile j - 1's
// block did, and waits at most for that step: the key tiles of a (batch
// row, KV head) run side by side, each one step behind the one before.
// Extra traffic beside the bound: each kept (query tile, key tile, head)
// reads and writes 64 d f32 of the accumulator (in L2 for the most part),
// and launch 3 reads it once.
//
// What bounds it: operations (five products of 2 d multiply-adds a kept
// pair, three TF32 passes in f32).  In bf16 the f32 sum's traffic
// through L2 (64 KB a tile step of 64 x 64 at d 128) outweighs the
// products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kBQ = 64;        // query rows a tile: the consumer's M
constexpr int kThreads = 256;  // loader warpgroup, then the consumer

struct Strides {
  long long b, h, s;
};

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}
// Keys a block: 64 where the registers and shared memory allow it.
template <typename T, int D>
__host__ __device__ constexpr int block_keys() {
  return D == 64 || !is_f32<T>() ? 64 : 32;
}
// Elements in one 128-byte swizzle atom's row.
template <typename T>
__host__ __device__ constexpr int atom_cols() {
  return 128 / (int)sizeof(T);
}
// d as the K extent of a plane: at least one atom (zeros past d).
template <typename T, int D>
__host__ __device__ constexpr int dpad() {
  return D < atom_cols<T>() ? atom_cols<T>() : D;
}
// The keys as the K extent of K^T's plane: at least one atom.
template <typename T, int D>
__host__ __device__ constexpr int kpad() {
  return block_keys<T, D>() < atom_cols<T>() ? atom_cols<T>()
                                             : block_keys<T, D>();
}
// Whether dV^T's accumulator waits in shared memory between the tiles'
// products (bf16 at d 128: 64 keys of dK^T and dV^T, 128 registers, leave
// too few for S and dP).
template <typename T, int D>
__host__ __device__ constexpr bool stash_dv() {
  return !is_f32<T>() && D == 128;
}
// Planes per operand: TF32 hi and lo for f32, one for bf16.
template <typename T>
__host__ __device__ constexpr int halves() {
  return is_f32<T>() ? 2 : 1;
}
// The wgmma k-step: 8 TF32 or 16 bf16 elements.
template <typename T>
__host__ __device__ constexpr int kstep() {
  return is_f32<T>() ? 8 : 16;
}
// Element (r, c) of a staged Q or dO tile (rows of d, no padding): its
// 16-byte chunks swizzled by the row, so that the fragment loads along and
// across rows are (nearly) free of bank conflicts.
template <typename T, int D>
__device__ __forceinline__ int at(int r, int c) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int chunks = D / E;
  constexpr int mask = (chunks < 8 ? chunks : 8) - 1;
  return r * D + (((c / E) ^ (r & mask)) * E) + c % E;
}
template <typename T, int D>
__host__ __device__ constexpr int stages() {
  return is_f32<T>() && D >= 64 ? 1 : 2;
}

// Shared memory of launch 2, in bytes from a 1024-aligned base: the B
// planes K [key][d], V [key][d], K^T [d][key], P^T and dS^T [key][q] (hi,
// then lo, for f32), the ring of staged Q and dO tiles, the buffer that
// hands dQ's part (64 rows of d + 4 f32) to the loader, dV^T's stash
// (stash_dv), the barriers
// full[S], empty[S], dq_full and dq_empty, and the block's ticket.
template <typename T, int D>
struct Layout {
  static constexpr int BK = block_keys<T, D>();
  static constexpr int S = stages<T, D>();
  static constexpr uint32_t k_plane = BK * dpad<T, D>() * sizeof(T);
  static constexpr uint32_t kt_plane = D * kpad<T, D>() * sizeof(T);
  static constexpr uint32_t p_plane = BK * kBQ * sizeof(T);
  static constexpr uint32_t tile = kBQ * D * sizeof(T);
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + halves<T>() * k_plane;
  static constexpr uint32_t kt = v + halves<T>() * k_plane;
  static constexpr uint32_t pt = kt + halves<T>() * kt_plane;
  static constexpr uint32_t dst = pt + halves<T>() * p_plane;
  static constexpr uint32_t ring = dst + halves<T>() * p_plane;
  static constexpr uint32_t dq = ring + S * 2 * tile;
  static constexpr int dq_ld = D + 4;
  static constexpr uint32_t stash = dq + kBQ * dq_ld * 4;
  static constexpr uint32_t bars =
      stash + (stash_dv<T, D>() ? D * BK * 4 : 0);
  static constexpr uint32_t ticket = bars + 16 * S + 16;
  static constexpr size_t bytes = ticket + 16 + 1024;
};

__device__ __forceinline__ bool kept(int i, int j, int sk, int causal,
                                     int window) {
  return j < sk && (!causal || (j <= i && (window <= 0 || i - j < window)));
}

// Whether query row i sees no key at all.
__device__ __forceinline__ bool no_key(int i, int sk, int causal,
                                       int window) {
  return causal && window > 0 && i - (sk - 1) >= window;
}

// Whether no (query, key) pair of rows [r, r + rows) and keys
// [kt, kt + keys) is masked.
__device__ __forceinline__ bool unmasked(int r, int rows, int kt, int keys,
                                         int sk, int causal, int window) {
  return kt + keys <= sk &&
         (!causal || (kt + keys - 1 <= r &&
                      (window <= 0 || r + rows - 1 - kt < window)));
}

// The query tiles [start, start + n) that see some key of key tile j.
struct Range {
  int start, n;
  __device__ bool holds(int i) const { return i >= start && i < start + n; }
};
__device__ __forceinline__ Range seen_by(int j, int bk, int sq, int sk,
                                         int causal, int window) {
  const int nqt = (sq + kBQ - 1) / kBQ;
  if (!causal) return {0, nqt};
  const int k0 = j * bk;
  const int k1 = min(k0 + bk, sk);
  const long long reach = (long long)k1 - 1 + window;
  const int hi = window > 0 ? (int)min((long long)sq, reach) : sq;
  const int start = k0 / kBQ;
  return {start, k0 < hi ? (hi + kBQ - 1) / kBQ - start : 0};
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
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

// ------------------------------------------------------ shared-memory B
// Byte offset of element (r, c) of a K-major plane of `rows` rows (c along
// K), stored as column blocks of one 128-byte atom, swizzled as TMA's
// 128-byte mode and the descriptors name it.
template <typename T>
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  constexpr int AC = atom_cols<T>();
  constexpr int E = 16 / (int)sizeof(T);  // elements in a 16-byte chunk
  return (c / AC) * rows * 128 + r * 128 +
         ((((c % AC) / E) ^ (r & 7)) << 4) + (c % E) * (int)sizeof(T);
}

// A plane's descriptor, made opaque to the compiler: taken once a tile,
// so that the k-steps' descriptors below (this one plus an immediate) are
// formed where they are used, not hoisted out of the tile loop into
// registers.
__device__ __forceinline__ uint64_t plane_desc(uint32_t plane) {
  uint64_t d = hop::descriptor(plane, 16, 1024, 1);
  asm volatile("" : "+l"(d));
  return d;
}

// Descriptor of the k-step from column `col`, rows from `row0` (a multiple
// of 8), of the plane whose descriptor is d0.
template <typename T>
__device__ __forceinline__ uint64_t kdesc(uint64_t d0, int rows, int row0,
                                          int col) {
  constexpr int AC = atom_cols<T>();
  return d0 + (uint64_t)(((col / AC) * rows * 128 + row0 * 128 +
                          (col % AC) * (int)sizeof(T)) >> 4);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint16_t x) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(addr), "h"(x) : "memory");
}

// x into a plane at byte `off`: its TF32 halves into the hi and lo planes
// (f32), or rounded to bf16.
template <typename T>
__device__ __forceinline__ void put(uint32_t plane, uint32_t plane_bytes,
                                    uint32_t off, float x) {
  if constexpr (is_f32<T>()) {
    uint32_t hi, lo;
    tc::split(x, hi, lo);
    st_shared(plane + off, hi);
    st_shared(plane + plane_bytes + off, lo);
  } else {
    const __nv_bfloat16 y = __float2bfloat16_rn(x);
    st_shared(plane + off, *reinterpret_cast<const uint16_t*>(&y));
  }
}

// The column of K^T's plane that holds key r of the block.  f32: S's
// accumulator holds keys 2t and 2t + 1 of each group of 8, taken as the
// A fragment's columns t and t + 4, so K^T keeps key j at column (j odd:
// 4 + j / 2; j even: j / 2) of its group.  bf16 fragments take the keys in
// order.
template <typename T>
__device__ __forceinline__ int key_col(int r) {
  if constexpr (is_f32<T>())
    return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
  else
    return r;
}

// ------------------------------------------------- register A fragments
// One k-step's A fragment of this warp's 16 rows: TF32 hi and lo (f32), or
// bf16 pairs in hi.
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void zero(Frag& f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f.hi[i] = f.lo[i] = 0u;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ float lds(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

// A shared-memory address made opaque to the compiler, once a tile: what
// is computed from it stays inside the tile loop instead of being hoisted
// out of it into registers.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// A(m, k) = X[m0 + m][k0 + k] of a staged tile at shared address X;
// columns past d are 0.
template <typename T, int D>
__device__ __forceinline__ void row_frag(Frag& f, uint32_t X, int m0,
                                         int k0) {
  constexpr int es = sizeof(T);
  const int lane = threadIdx.x & 31;
  if (k0 >= D) {
    zero(f);
    return;
  }
  if constexpr (is_f32<T>()) {
    const int r = m0 + (lane >> 2);
    const int c = k0 + (lane & 3);
    tc::split(lds(X + es * at<T, D>(r, c)), f.hi[0], f.lo[0]);
    tc::split(lds(X + es * at<T, D>(r + 8, c)), f.hi[1], f.lo[1]);
    tc::split(lds(X + es * at<T, D>(r, c + 4)), f.hi[2], f.lo[2]);
    tc::split(lds(X + es * at<T, D>(r + 8, c + 4)), f.hi[3], f.lo[3]);
  } else {
    ldsm_x4(f.hi,
            X + es * at<T, D>(m0 + (lane & 15), k0 + ((lane >> 4) << 3)));
  }
}

// A(m, k) = X[k0 + k][m0 + m] of a staged tile X; rows m0 + m >= d are 0
// (d is a multiple of 16, so a warp's 16 rows are all in or all out).
template <typename T, int D>
__device__ __forceinline__ void col_frag(Frag& f, uint32_t X, int m0,
                                         int k0) {
  constexpr int es = sizeof(T);
  const int lane = threadIdx.x & 31;
  if (m0 >= D) {
    zero(f);
    return;
  }
  if constexpr (is_f32<T>()) {
    const int r = k0 + (lane & 3);
    const int c = m0 + (lane >> 2);
    tc::split(lds(X + es * at<T, D>(r, c)), f.hi[0], f.lo[0]);
    tc::split(lds(X + es * at<T, D>(r, c + 8)), f.hi[1], f.lo[1]);
    tc::split(lds(X + es * at<T, D>(r + 4, c)), f.hi[2], f.lo[2]);
    tc::split(lds(X + es * at<T, D>(r + 4, c + 8)), f.hi[3], f.lo[3]);
  } else {
    ldsm_x4_trans(f.hi,
                  X + es * at<T, D>(k0 + (lane & 7) + ((lane >> 4) << 3),
                                    m0 + (((lane >> 3) & 1) << 3)));
  }
}

// The A fragment of k-step kk from an accumulator whose columns are keys
// (S orientation): f32 takes key group kk, columns t and t + 4 standing
// for keys 2t and 2t + 1 (key_col); bf16 takes groups 2kk and 2kk + 1.
template <typename T, int NA>
__device__ __forceinline__ void acc_frag(Frag& f, const float (&acc)[NA],
                                         int kk) {
  if constexpr (is_f32<T>()) {
    tc::split(acc[4 * kk], f.hi[0], f.lo[0]);      // (g, key 2t)
    tc::split(acc[4 * kk + 2], f.hi[1], f.lo[1]);  // (g + 8, key 2t)
    tc::split(acc[4 * kk + 1], f.hi[2], f.lo[2]);  // (g, key 2t + 1)
    tc::split(acc[4 * kk + 3], f.hi[3], f.lo[3]);  // (g + 8, key 2t + 1)
  } else {
    f.hi[0] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
    f.hi[1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    f.hi[2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    f.hi[3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// acc (64 x N) += a . b for one k-step: three TF32 passes (f32, small
// terms first) or one bf16 pass; scale_d 0 overwrites acc.
template <typename T, int N>
__device__ __forceinline__ void mma(float (&acc)[N / 2], const Frag& a,
                                    uint64_t b_hi, uint64_t b_lo,
                                    int scale_d) {
  if constexpr (is_f32<T>()) {
    hop::wgmma_rs_tf32<N>(acc, a.lo, b_hi, scale_d);
    hop::wgmma_rs_tf32<N>(acc, a.hi, b_lo, 1);
    hop::wgmma_rs_tf32<N>(acc, a.hi, b_hi, 1);
  } else {
    hop::wgmma_rs_kmajor<N>(acc, a.hi, b_hi, scale_d);
  }
}

// Wgmma groups a product keeps in flight.
constexpr int kDepth = 2;

// NK k-steps of a product, each one wgmma group: the A fragments of step
// kk + 1 are loaded while up to kDepth groups run (kDepth sets of
// registers).  load(f, kk) fills NOP fragments; issue(f, kk) issues the
// step's wgmmas.  Returns with every group complete.
template <int NK, int NOP, typename Load, typename Issue>
__device__ __forceinline__ void pipeline(Load load, Issue issue) {
  constexpr int NB = kDepth < NK ? kDepth : NK;
  Frag f[NB][NOP];
  load(f[0], 0);
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    hop::wgmma_fence();
    issue(f[kk % NB], kk);
    hop::wgmma_commit();
    if (kk + 1 < NK) {
      // step kk + 1 - NB is done with the registers step kk + 1 fills
      hop::wgmma_wait<NB - 1>();
      load(f[(kk + 1) % NB], kk + 1);
    }
  }
  hop::wgmma_wait<0>();
}

// ------------------------------------------------------- dQ's ordering
// Spins until *p == value.  A wait longer than 10 s means a broken
// ordering: it traps (a launch error) rather than hang the card.
__device__ __forceinline__ void wait_for(const int* p, int value) {
  unsigned long long t0, now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  int x;
  do {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                 : "=r"(x)
                 : "l"(p)
                 : "memory");
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (now - t0 > 10000000000ull) __trap();
  } while (x != value);
}
__device__ __forceinline__ void publish(int* p, int value) {
  asm volatile(
      "fence.acq_rel.gpu;\n"
      "st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p),
      "r"(value)
      : "memory");
}

// ------------------------------------------------------------ 1. rows
// One warp a query row: D = rowsum(dO o O) in f32, and lse in log2 units
// (+inf for a row that sees no key, whose P the kernels take as 0).  rows
// holds the lse plane, then the D plane, each (b, h, sq).  The first
// n_sync threads zero launch 2's ticket and counters.
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_rows_kernel(const T* __restrict__ out,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ rows, int* __restrict__ sync,
                          long long n_sync, Strides os, Strides dos, int h,
                          int sq, int sk, int d, int causal, int window,
                          long long total) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < n_sync) sync[gid] = 0;
  const long long r = gid >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= total) return;
  const int i = (int)(r % sq);
  const long long bh = r / sq;
  const int head = (int)(bh % h);
  const int row = (int)(bh / h);
  const T* o = out + row * os.b + head * os.h + i * os.s;
  const T* g = dout + row * dos.b + head * dos.h + i * dos.s;
  float acc = 0.f;
  for (int e = lane; e < d; e += 32)
    acc += tc::to_float(o[e]) * tc::to_float(g[e]);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    rows[r] = no_key(i, sk, causal, window) ? INFINITY : lse[r] * kLog2e;
    rows[total + r] = acc;
  }
}

// 16 bytes from p: one vector load, or element by element where the rows
// are not 16-byte aligned.
__device__ __forceinline__ uint4 chunk(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                    __float_as_uint(p[2]), __float_as_uint(p[3]));
}
__device__ __forceinline__ uint4 chunk(const __nv_bfloat16* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(p[2 * i]) |
           ((uint32_t)__bfloat16_as_ushort(p[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The loader's share of a tile's rows [0, 64) (row stride `ld` elements):
// 16-byte chunks in registers, rows past n zeros; then into a staged tile.
// The loads of the next tile are in flight while the consumer works on the
// last one.
template <typename T, int D>
struct Rows {
  static constexpr int E = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int chunks = D / E;            // chunks a row
  static constexpr int U = kBQ * chunks / 128;    // chunks a thread
  uint4 x[U];

  __device__ __forceinline__ void load(const T* src, long long ld, int n,
                                       int tid) {
    const bool vec = tc::aligned16(src, ld);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = tid + 128 * u;
      const int r = idx / chunks;
      const int c = (idx - r * chunks) * E;
      x[u] = r < n ? chunk(src + r * ld + c, vec) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(T* dst, int tid) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = tid + 128 * u;
      const int r = idx / chunks;
      const int c = (idx - r * chunks) * E;
      *reinterpret_cast<uint4*>(dst + at<T, D>(r, c)) = x[u];
    }
  }
};

// ---------------------------------------------- 2. dK, dV and dQ's parts
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ rows,
                          T* __restrict__ dk, T* __restrict__ dv,
                          float* __restrict__ dq_acc, int* __restrict__ sync,
                          Strides qs, Strides ks, Strides vs, Strides dos,
                          Strides dks, Strides dvs, int b, int h, int kv,
                          int sq, int sk, int causal, int window,
                          float scale_log2, float scale) {
  using L = Layout<T, D>;
  constexpr int BK = L::BK;
  constexpr int S = L::S;
  constexpr int DP = dpad<T, D>();
  constexpr int KS = kstep<T>();
  constexpr int MT = (D + 63) / 64;   // 64-row tiles of d (dK^T, dV^T)
  constexpr int NC = D < 64 ? D : 64;  // dQ's columns a pass

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_addr = hop::smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw_addr);
  auto full = [&](int st) { return base + L::bars + 8 * st; };
  auto empty = [&](int st) { return base + L::bars + 8 * (S + st); };
  const uint32_t dq_full = base + L::bars + 16 * S;
  const uint32_t dq_empty = dq_full + 8;
  auto ring = [&](int st) {
    return reinterpret_cast<T*>(gbase + L::ring + st * 2 * L::tile);
  };
  float* dq_buf = reinterpret_cast<float*>(gbase + L::dq);
  int* ticket = reinterpret_cast<int*>(gbase + L::ticket);

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      hop::mbar_init(full(i), 128);
      hop::mbar_init(empty(i), 128);
    }
    hop::mbar_init(dq_full, 128);
    hop::mbar_init(dq_empty, 128);
    hop::mbar_init_fence();
    *ticket = atomicAdd(sync, 1);
  }
  __syncthreads();

  // the work, key tile outermost: (key tile j, KV head, batch row)
  const int item = *ticket;
  const int j = item / (kv * b);
  const int rest = item - j * (kv * b);
  const int kv_head = rest % kv;
  const int row = rest / kv;
  const int k0 = j * BK;
  const int keys = min(BK, sk - k0);
  const int group = h / kv;
  const int nqt = (sq + kBQ - 1) / kBQ;
  int* counters = sync + 1;

  // K, V and K^T into their B planes, once
  {
    const T* k_bh = k + row * ks.b + kv_head * ks.h + (long long)k0 * ks.s;
    const T* v_bh = v + row * vs.b + kv_head * vs.h + (long long)k0 * vs.s;
    constexpr int KP = kpad<T, D>();
    for (int idx = threadIdx.x; idx < KP * DP; idx += kThreads) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      const bool in = r < keys && c < D;
      const float kx = in ? tc::to_float(k_bh[r * ks.s + c]) : 0.f;
      if (r < BK) {
        const float vx = in ? tc::to_float(v_bh[r * vs.s + c]) : 0.f;
        put<T>(base + L::k, L::k_plane, swz<T>(BK, r, c), kx);
        put<T>(base + L::v, L::k_plane, swz<T>(BK, r, c), vx);
      }
      if (c < D)
        put<T>(base + L::kt, L::kt_plane, swz<T>(D, c, key_col<T>(r)), kx);
    }
    hop::fence_proxy_async();
  }
  __syncthreads();

  // The query tiles that see these keys, each with every head of the group
  // (tile-major), then the tiles of rows that see no key.
  const Range seen = seen_by(j, BK, sq, sk, causal, window);
  int start2 = 0, n2 = 0;
  if (causal && window > 0 && (long long)sk - 1 + window < sq) {
    start2 = max((sk - 1 + window) / kBQ, seen.start + seen.n);
    n2 = max(nqt - start2, 0);
  }
  const int steps = (seen.n + n2) * group;
  auto step_of = [&](int it, int& head, int& qt) {
    const int u = it / group;
    head = kv_head * group + (it - u * group);
    if (u >= seen.n)
      qt = start2 + u - seen.n;
    else if (causal)
      qt = seen.start + seen.n - 1 - u;
    else
      qt = u;
    return u < seen.n;  // a part of dQ to add
  };

  if (threadIdx.x < 128) {
    // ---- loader: each tile's Q and dO rows into the ring; then the last
    // tile's part of dQ from the buffer into the f32 sum, after key tile
    // j - 1's, while the consumer runs the next tile's products
    const int tid = threadIdx.x;
    int n_dq = 0;
    auto add_dq = [&](int it) {
      int head, qt;
      step_of(it, head, qt);
      hop::mbar_wait(dq_full, n_dq & 1);
      const bool first =
          j == 0 || !seen_by(j - 1, BK, sq, sk, causal, window).holds(qt);
      int* counter = counters + ((long long)row * h + head) * nqt + qt;
      if (!first && tid == 0) wait_for(counter, j);
      hop::bar_sync(2, 128);
      const int q0 = qt * kBQ;
      const int n = min(kBQ, sq - q0);
      float* acc_q = dq_acc + (((long long)row * h + head) * sq + q0) * D;
      // D / 8 float4 a thread: every load issued before the first add
      constexpr int U = D / 8;
      float4 y[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = tid + 128 * u;
        const int r = idx / (D / 4);
        const int c = (idx - r * (D / 4)) * 4;
        y[u] = !first && r < n
                   ? __ldcg(reinterpret_cast<const float4*>(acc_q + r * D + c))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = tid + 128 * u;
        const int r = idx / (D / 4);
        const int c = (idx - r * (D / 4)) * 4;
        if (r < n) {
          float4 x =
              *reinterpret_cast<const float4*>(dq_buf + r * L::dq_ld + c);
          if (!first) {
            x.x += y[u].x;
            x.y += y[u].y;
            x.z += y[u].z;
            x.w += y[u].w;
          }
          __stcg(reinterpret_cast<float4*>(acc_q + r * D + c), x);
        }
      }
      hop::mbar_arrive(dq_empty);
      hop::bar_sync(2, 128);
      if (tid == 0) publish(counter, j + 1);
      ++n_dq;
    };
    Rows<T, D> q_rows, d_rows;
    auto fetch = [&](int it) {
      int head, qt;
      step_of(it, head, qt);
      const int q0 = qt * kBQ;
      const int n = min(kBQ, sq - q0);
      q_rows.load(q + row * qs.b + head * qs.h + (long long)q0 * qs.s, qs.s,
                  n, tid);
      d_rows.load(dout + row * dos.b + head * dos.h + (long long)q0 * dos.s,
                  dos.s, n, tid);
    };
    if (steps > 0) fetch(0);
    for (int it = 0; it < steps; ++it) {
      const int st = it % S;
      if (it >= S) hop::mbar_wait(empty(st), ((it / S) - 1) & 1);
      T* q_s = ring(st);
      q_rows.store(q_s, tid);
      d_rows.store(q_s + kBQ * D, tid);
      hop::mbar_arrive(full(st));
      if (it + 1 < steps) fetch(it + 1);
      int head, qt;
      if (it > 0 && step_of(it - 1, head, qt)) add_dq(it - 1);
    }
    int head, qt;
    if (steps > 0 && step_of(steps - 1, head, qt)) add_dq(steps - 1);
    return;
  }

  // ---- consumer: the five products of every tile
  const int tid = threadIdx.x - 128;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long plane = (long long)b * h * sq;
  const float uniform = 1.f / sk;
  const uint32_t k_hi = base + L::k, k_lo = k_hi + L::k_plane;
  const uint32_t v_hi = base + L::v, v_lo = v_hi + L::k_plane;
  const uint32_t kt_hi = base + L::kt, kt_lo = kt_hi + L::kt_plane;
  const uint32_t pt_hi = base + L::pt, pt_lo = pt_hi + L::p_plane;
  const uint32_t ds_hi = base + L::dst, ds_lo = ds_hi + L::p_plane;

  int n_dq = 0;  // tiles whose dQ part went to the loader
  float dv_acc[MT][BK / 2], dk_acc[MT][BK / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) dv_acc[mt][i] = dk_acc[mt][i] = 0.f;
  // dV^T's stash: element i of row tile mt at [(mt * BK / 2 + i) * 128 + tid]
  float* stash = reinterpret_cast<float*>(gbase + L::stash) + tid;
  if constexpr (stash_dv<T, D>())
    for (int i = 0; i < MT * BK / 2; ++i) stash[i * 128] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int st = it % S;
    int head, qt;
    const bool chain = step_of(it, head, qt);
    const int q0 = qt * kBQ;
    const int r0 = q0 + 16 * warp + g;
    const int r1 = r0 + 8;
    // the batch row made opaque once a tile (as the ring's address below):
    // the f32 d-64 entry then fits its 255 registers with no spill
    const long long off =
        ((long long)(int)opaque((uint32_t)row) * h + head) * sq;
    const float lse0 = r0 < sq ? rows[off + r0] : INFINITY;
    const float lse1 = r1 < sq ? rows[off + r1] : INFINITY;
    const float dsum0 = r0 < sq ? rows[plane + off + r0] : 0.f;
    const float dsum1 = r1 < sq ? rows[plane + off + r1] : 0.f;
    const float unif0 = r0 < sq && no_key(r0, sk, causal, window) ? uniform : 0.f;
    const float unif1 = r1 < sq && no_key(r1, sk, causal, window) ? uniform : 0.f;
    hop::mbar_wait(full(st), (it / S) & 1);
    const uint32_t q_s = opaque(base + L::ring + st * 2 * L::tile);
    const uint32_t d_s = q_s + L::tile;
    const uint64_t dk_hi = plane_desc(k_hi), dk_lo = plane_desc(k_lo);
    const uint64_t dv_hi = plane_desc(v_hi), dv_lo = plane_desc(v_lo);

    // 1, 2: S = Q K^T and dP = dO V^T (64 queries x BK keys)
    float s[BK / 2], dp[BK / 2];
    pipeline<DP / KS, 2>(
        [&](Frag(&f)[2], int kk) {
          row_frag<T, D>(f[0], q_s, 16 * warp, kk * KS);
          row_frag<T, D>(f[1], d_s, 16 * warp, kk * KS);
        },
        [&](const Frag(&f)[2], int kk) {
          mma<T, BK>(s, f[0], kdesc<T>(dk_hi, BK, 0, kk * KS),
                     kdesc<T>(dk_lo, BK, 0, kk * KS), kk > 0);
          mma<T, BK>(dp, f[1], kdesc<T>(dv_hi, BK, 0, kk * KS),
                     kdesc<T>(dv_lo, BK, 0, kk * KS), kk > 0);
        });
    hop::fence_registers(s);
    hop::fence_registers(dp);

    // P into s (plus 1/sk for dV in rows that see no key), dS into dp;
    // masks only on tiles that need them
    const bool whole = unmasked(q0, kBQ, k0, BK, sk, causal, window);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const bool lo_row = (i & 2) == 0;
      const int jj = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      float p = exp2f(s[i] * scale_log2 - (lo_row ? lse0 : lse1));
      if (!whole && !kept(lo_row ? r0 : r1, jj, sk, causal, window)) p = 0.f;
      dp[i] = p * (dp[i] - (lo_row ? dsum0 : dsum1));
      s[i] = whole ? p : p + (jj < sk ? (lo_row ? unif0 : unif1) : 0.f);
    }

    // P^T and dS^T into their planes (the last tile's products read them:
    // every warp has waited on those)
    hop::bar_sync(1, 128);
    {
      // element i is (key 8 (i >> 2) + 2t + (i & 1), query row 16 warp +
      // g + 8 ((i >> 1) & 1)): four offsets, then 1024 bytes a key group
      uint32_t offs[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        offs[e] = opaque(pt_hi) - pt_hi +
                  swz<T>(BK, 2 * t + (e & 1), 16 * warp + g + ((e & 2) << 2));
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const uint32_t off = offs[i & 3] + 1024 * (i >> 2);
        put<T>(pt_hi, L::p_plane, off, s[i]);
        put<T>(ds_hi, L::p_plane, off, dp[i]);
      }
    }
    hop::fence_proxy_async();
    hop::bar_sync(1, 128);

    // 3, 4: dV^T += dO^T P and dK^T += Q^T dS (d x BK), 64 rows of d a pass
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m0 = 64 * mt + 16 * warp;
      // dO^T with P^T into dV^T, then Q^T with dS^T into dK^T
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const uint32_t X = which ? q_s : d_s;
        const uint64_t b_hi = plane_desc(which ? ds_hi : pt_hi);
        const uint64_t b_lo = plane_desc(which ? ds_lo : pt_lo);
        float(&acc)[BK / 2] = which ? dk_acc[mt] : dv_acc[mt];
        auto load = [&](Frag(&f)[1], int kk) {
          col_frag<T, D>(f[0], X, m0, kk * KS);
        };
        if constexpr (stash_dv<T, D>()) {
          if (which == 0) {
            float* slot = stash + mt * (BK / 2) * 128;
            float dv_t[BK / 2];
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) dv_t[i] = slot[i * 128];
            hop::fence_registers(dv_t);
            pipeline<kBQ / KS, 1>(load, [&](const Frag(&f)[1], int kk) {
              mma<T, BK>(dv_t, f[0], kdesc<T>(b_hi, BK, 0, kk * KS), 0, 1);
            });
            hop::fence_registers(dv_t);
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) slot[i * 128] = dv_t[i];
            continue;
          }
        }
        if constexpr (is_f32<T>()) {
          float part[BK / 2];
          pipeline<kBQ / KS, 1>(load, [&](const Frag(&f)[1], int kk) {
            mma<T, BK>(part, f[0], kdesc<T>(b_hi, BK, 0, kk * KS),
                       kdesc<T>(b_lo, BK, 0, kk * KS), kk > 0);
          });
          hop::fence_registers(part);
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) acc[i] += part[i];
        } else {
          hop::fence_registers(acc);
          pipeline<kBQ / KS, 1>(load, [&](const Frag(&f)[1], int kk) {
            mma<T, BK>(acc, f[0], kdesc<T>(b_hi, BK, 0, kk * KS), 0, 1);
          });
          hop::fence_registers(acc);
        }
      }
    }
    hop::mbar_arrive(empty(st));  // the staged rows are read

    // 5: dQ's part = dS K (64 queries x d), handed to the loader
    if (!chain) continue;
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += NC) {
      const uint64_t b_hi = plane_desc(kt_hi), b_lo = plane_desc(kt_lo);
      float dq[NC / 2];
      pipeline<BK / KS, 1>(
          [&](Frag(&f)[1], int kk) { acc_frag<T>(f[0], dp, kk); },
          [&](const Frag(&f)[1], int kk) {
            mma<T, NC>(dq, f[0], kdesc<T>(b_hi, D, c0, kk * KS),
                       kdesc<T>(b_lo, D, c0, kk * KS), kk > 0);
          });
      hop::fence_registers(dq);
      if (c0 == 0 && n_dq > 0) hop::mbar_wait(dq_empty, (n_dq - 1) & 1);
#pragma unroll
      for (int jn = 0; jn < NC / 8; ++jn)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rl = 16 * warp + g + 8 * half;
          *reinterpret_cast<float2*>(dq_buf + rl * L::dq_ld + c0 + 8 * jn +
                                     2 * t) =
              make_float2(dq[4 * jn + 2 * half], dq[4 * jn + 2 * half + 1]);
        }
    }
    hop::mbar_arrive(dq_full);
    ++n_dq;
  }

  // dK^T, dV^T (rows of d, columns of keys) into dk, dv
  T* dk_bh = dk + row * dks.b + kv_head * dks.h + (long long)k0 * dks.s;
  T* dv_bh = dv + row * dvs.b + kv_head * dvs.h + (long long)k0 * dvs.s;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int m = 64 * mt + 16 * warp + g + ((i & 2) << 2);
      const int key = 8 * (i >> 2) + 2 * t + (i & 1);
      if (m < D && key < keys) {
        dk_bh[key * dks.s + m] = from_float<T>(dk_acc[mt][i] * scale);
        dv_bh[key * dvs.s + m] = from_float<T>(
            stash_dv<T, D>() ? stash[(mt * (BK / 2) + i) * 128] : dv_acc[mt][i]);
      }
    }
}

// ------------------------------------------------------------------ 3. dQ
// One block a (query tile, head, batch row): dq = scale * the accumulator,
// in dq's type; zeros where no key tile added (its counter is 0).
template <typename T, int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dq_kernel(const float* __restrict__ dq_acc,
                        const int* __restrict__ sync, T* __restrict__ dq,
                        Strides dqs, int h, int sq, float scale) {
  const int qt = blockIdx.x;
  const int head = blockIdx.y;
  const int row = blockIdx.z;
  const int nqt = gridDim.x;
  const long long bh = (long long)row * h + head;
  const bool added = sync[1 + bh * nqt + qt] != 0;
  const int q0 = qt * kBQ;
  const int n = min(kBQ, sq - q0);
  const float* src = dq_acc + (bh * sq + q0) * D;
  T* dst = dq + row * dqs.b + head * dqs.h + (long long)q0 * dqs.s;
  for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x) {
    const int r = idx / D;
    const int c = idx - r * D;
    dst[r * dqs.s + c] = from_float<T>(added ? src[idx] * scale : 0.f);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const void* lse,
                   void* dq, void* dk, void* dv, void* rows, void* dq_acc,
                   void* sync, const Strides* st, int b, int h, int kv,
                   int sq, int sk, int causal, int window, float scale,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  float* rf = static_cast<float*>(rows);
  float* acc = static_cast<float*>(dq_acc);
  int* sy = static_cast<int*>(sync);
  const float scale_log2 = scale * kLog2e;
  const int nqt = (sq + kBQ - 1) / kBQ;
  cudaError_t err;

  const long long total = (long long)b * h * sq;
  const long long n_sync = 1 + (long long)b * h * nqt;
  const long long blocks = (total + 7) / 8;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  mark(0, stream);
  flash_bwd_rows_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const T*>(out), dot, static_cast<const float*>(lse), rf, sy,
      n_sync, st[3], st[4], h, sq, sk, D, causal, window, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(1, stream);

  using L = Layout<T, D>;
  static_assert(L::bytes <= kMaxSmem, "flash backward (main): shared memory");
  auto kernel = flash_bwd_dkdv_kernel<T, D>;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)L::bytes)) != cudaSuccess)
    return err;
  const long long items =
      (long long)((sk + L::BK - 1) / L::BK) * kv * b;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)items, kThreads, L::bytes, stream>>>(
      qt, kt, vt, dot, rf, static_cast<T*>(dk), static_cast<T*>(dv), acc, sy,
      st[0], st[1], st[2], st[4], st[6], st[7], b, h, kv, sq, sk, causal,
      window, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(2, stream);

  flash_bwd_dq_kernel<T, D><<<dim3(nqt, h, b), 256, 0, stream>>>(
      acc, sy, static_cast<T*>(dq), st[5], h, sq, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mark(3, stream);
  return cudaSuccess;
}

template <typename T>
cudaError_t dispatch_head_dim(int d, const void* q, const void* k,
                              const void* v, const void* out,
                              const void* dout, const void* lse, void* dq,
                              void* dk, void* dv, void* rows, void* dq_acc,
                              void* sync, const Strides* st, int b, int h,
                              int kv, int sq, int sk, int causal, int window,
                              float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, out, dout, lse, dq, dk, dv, rows, dq_acc,
                           sync, st, b, h, kv, sq, sk, causal, window, scale,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, out, dout, lse, dq, dk, dv, rows, dq_acc,
                           sync, st, b, h, kv, sq, sk, causal, window, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, lse, dq, dk, dv, rows, dq_acc,
                           sync, st, b, h, kv, sq, sk, causal, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, lse, dq, dk, dv, rows,
                            dq_acc, sync, st, b, h, kv, sq, sk, causal,
                            window, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: 24 element strides, (batch, head, position) for q, k, v, out,
// dout, dq, dk and dv in turn; the last dimension of each is contiguous.
// lse (b, h, sq) f32 from the forward.  Scratch that the call overwrites
// before it reads: rows (2, b, h, sq) f32, dq_acc (b, h, sq, d) f32 and
// sync, repro_flash_bwd_sync_ints(b, h, sq) ints.  dtype: 0 = float32, 1 =
// bfloat16; window <= 0 means none.  Launches three kernels on `stream`;
// returns the first launch error.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* rows, void* dq_acc, void* sync, const long long* strides, int b,
    int h, int kv, int sq, int sk, int d, int causal, int window, int dtype,
    float scale, void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || kv < 1 || h % kv != 0 ||
      sq < 1 || sk < 1)
    return cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(d, q, k, v, out, dout, lse, dq, dk, dv,
                                    rows, dq_acc, sync, st, b, h, kv, sq, sk,
                                    causal, window, scale, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(d, q, k, v, out, dout, lse, dq,
                                            dk, dv, rows, dq_acc, sync, st, b,
                                            h, kv, sq, sk, causal, window,
                                            scale, s);
  return cudaErrorInvalidValue;
}

// The next calls record events[0 .. n) (cudaEvent_t) on their stream, one
// before each of the three launches and one after the last; n = 0 stops.
extern "C" void repro_flash_bwd_mark_launches(void* events, int n) {
  g_marks = static_cast<cudaEvent_t*>(events);
  g_n_marks = events == nullptr ? 0 : n;
}

// The ints of the `sync` scratch: the ticket, then one counter a (batch
// row, head, query tile of 64).
extern "C" long long repro_flash_bwd_sync_ints(int b, int h, int sq) {
  return 1 + (long long)b * h * ((sq + kBQ - 1) / kBQ);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
