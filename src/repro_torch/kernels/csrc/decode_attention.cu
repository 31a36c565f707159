// Single-token decode attention for Hopper (sm_90a): every key range of a
// (row, KV head) in one launch, merged inside a thread-block cluster.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `decode_attention` in
// src/repro/kernels/decode_attention.py.  Computes, for every batch row and
// query head,
//
//     out = softmax(q . k^T * d^-1/2, keys at or past lengths[row] masked) . v
//
// with f32 accumulators, the finite mask value -1e30 and the denominator
// floored at 1e-30, output in q's dtype.  A row with no valid key weighs
// all s keys equally (the mean of V), as the reference does.
//
// Layouts: q (b, h, d); k, v (b, s, kv, d) with kv dividing h (GQA: query
// head i reads KV head i / (h / kv), so K/V are never repeated in memory);
// lengths (b,) int32; out (b, h, d).  All contiguous.
//
// Dtypes (q, K/V): (f32, f32), (bf16, bf16), and (f32, bf16), a bf16
// decode cache under f32 params.  K/V are read and staged in their own
// dtype, never copied; `out` takes q's dtype.
//
// What bounds it: bytes.  Each K/V element feeds at most h/kv (here <= 8 a
// block) multiply-adds, so the least time is the K and V rows each row
// attends to, read once, over the memory rate.  At the serving shapes that
// read is a few MB, a few microseconds: the design keeps the whole read in
// flight at once, in one launch, and spends as few instructions a key as it
// can.
//
// 1. A split plan (`plan_splits` in ../decode_attention.py, from the shapes
//    alone, never from `lengths`, so the serving path gains no sync) cuts
//    the cache axis into `splits` ranges of whole key tiles, so that
//    splits x kv x b blocks fill the card several times over.  One block
//    per (split, KV head, group of up to 8 query heads, row).
// 2. The splits of a (row, KV head, head group) are one thread-block
//    cluster (grid x = splits <= kClusterMax = 8, the portable cluster
//    size).  Each rank owns a slice of the group's outputs.  Once every
//    rank has read its tiles (a cluster barrier whose arrive comes right
//    after the last tile and whose wait comes just before the first push),
//    each rank pushes its partial (m, l per head, in log2 units, to every
//    rank; the unnormalised accumulator of each output, to its owner) into
//    the ranks' shared memory by distributed-shared-memory stores, which do
//    not wait; after a second cluster barrier each owner merges its slice
//    from its own shared memory, the ranks in rank order:
//        m* = max m_r,  out = sum_r 2^(m_r - m*) acc_r / max(sum_r 2^(m_r -
//        m*) l_r, 1e-30)
//    (an empty range has m = -1e30, l = 0, acc = 0 and weighs exactly 0).
//    No partial goes through device memory, and a call is one launch.  The
//    merge is spread over the ranks rather than left to rank 0, and no
//    rank reads another's shared memory, so none waits on a remote read;
//    the order of the sums is fixed, so a repeat call is bit-equal.  A plan
//    of more splits than a cluster holds (only a small batch's long cache;
//    routing by shape alone, `plan_splits`) writes the partials to device
//    memory instead, and `decode_combine_kernel`, a second launch, merges
//    them by the same formula.  With one split the block writes `out`
//    itself.
// 3. Inside a block, two designs, by dtype:
//    - bf16 q and cache, `decode_mma_kernel`: tensor cores.  S^T = K . q^T
//      by bf16 `mma.sync.m16n8k16`: A is 16 keys x 16 channels of the
//      staged K tile (`ldmatrix`), B is q^T, held in registers from the
//      start, so N = 8 holds the group's up to 8 query heads.  The scale
//      d^-1/2 log2(e) is applied to S in f32.  Each warp owns 16 keys of a
//      64-key tile and its own online softmax; a head's max over the keys
//      is three xor shuffles.  P (f32) is rounded to bf16 and turned into
//      the B operand of O^T = V^T . P^T by `movmatrix.trans` (the score
//      fragment's keys are rows; B wants them as columns); V^T is A,
//      read by `ldmatrix.trans` from V as staged (keys x d).  O^T stays in
//      the mma's f32 accumulators, rescaled per head by each chunk's
//      alpha; the sum l is taken over the unrounded P.  This is the bf16
//      flash route's rounding (bf16 operands, f32 sums, P in bf16), held to
//      2e-2.  The four warps merge through shared memory.
//    - f32 q (f32 or bf16 cache), `decode_split_kernel`: CUDA cores, f32
//      products, f32-accurate (1e-4).  Each warp takes a quarter of a tile
//      of kTileElems / d keys; a lane computes whole dot products for its
//      (head, key) pairs against q in shared memory, a head's keys sit in
//      an aligned group of lanes whose maximum and sum take a few xor
//      shuffles; lanes hold the accumulators as float4 slots of (head,
//      channel).  A range no longer than one warp's share of a tile goes
//      to warp 0 alone.  (A bf16 cache under f32 q would need q split into
//      bf16 hi and lo halves and P into two passes to keep 1e-4 on tensor
//      cores; at these bytes a key the CUDA-core products are not what
//      bounds it, so that route keeps them.)
//    Both stage K and V tiles in their own dtype by 16-byte `cp.async`,
//    double-buffered, one barrier a tile; the next tile's copy overlaps
//    this tile's work, and the first tile's copy the read of `lengths`.
//    Only the valid prefix of a row is read; a range that starts past it
//    leaves an empty partial.
//
// The partials of the combine route, (splits, b, h) x {m, l} and
// (splits, b, h, d), come from `torch.empty` in the wrapper, so a CUDA
// graph captures a call whole.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cp_async.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupMax = 8;  // query heads per block
// Elements of one K (and one V) tile: kTileElems / D keys per tile.
constexpr int kTileElems = 4096;
constexpr int kStages = 2;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kClusterMax = 8;  // splits a cluster holds (portable size)

// Where a block's result goes: `out` (one split), device-memory partials
// for the combine launch, or its shared memory for the cluster's merge.
enum Emit { kOut = 0, kPart = 1, kCluster = 2 };

// A block's inbox for the cluster's merge: (m, l) of every rank and head,
// then every rank's accumulators of the block's slice of the group's
// outputs (at most kGroupMax x D / ranks each, rounded up).
constexpr int kInboxAcc = 2 * kClusterMax * kGroupMax;
template <int D>
__host__ __device__ constexpr size_t inbox_bytes() {
  return sizeof(float) * (kInboxAcc + kGroupMax * D + kClusterMax);
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

// Four consecutive elements from shared memory, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// q (f32, shared memory) . k (a staged row, in its own dtype), D terms:
// eight 16-byte reads of each in flight before their products, and four
// sums, so the reads and the adds do not wait on each other in turn.
template <int D, typename T>
__device__ __forceinline__ float dot_row(const float* q, const T* k) {
  constexpr int kBatch = D / 4 < 8 ? D / 4 : 8;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e0 = 0; e0 < D; e0 += 4 * kBatch) {
    float4 kk[kBatch], qq[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) kk[i] = load4(k + e0 + 4 * i);
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      qq[i] = *reinterpret_cast<const float4*>(q + e0 + 4 * i);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      s[0] = fmaf(qq[i].x, kk[i].x, s[0]);
      s[1] = fmaf(qq[i].y, kk[i].y, s[1]);
      s[2] = fmaf(qq[i].z, kk[i].z, s[2]);
      s[3] = fmaf(qq[i].w, kk[i].w, s[3]);
    }
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// The cluster's merge.  The ranks' key ranges are one (row, KV head, head
// group); rank r owns the group's outputs [r E / C, (r + 1) E / C) of E =
// gb x D.  Barrier A: a block arrives once it reads its tiles no more and
// waits before its first push, so a push never lands on tiles in use (the
// inbox may lie over them).  Then every rank pushes its accumulator of each
// output to the output's owner and its (m, l) of each head to every rank,
// by stores to distributed shared memory, which do not wait; barrier B
// makes them visible; each owner merges its slice from its own inbox, the
// ranks in rank order.  No block reads another's shared memory, so none
// has to wait for the others before it leaves.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Built by every block; reads the cluster's shape only when it pushes or
// merges, so the one-split path pays nothing for it.
struct ClusterPush {
  float* inbox;
  int total;

  __device__ int rank() const { return (int)cg::this_cluster().block_rank(); }
  __device__ int ranks() const {
    return (int)cg::this_cluster().num_blocks();
  }
  __device__ int slice() const { return (total + ranks() - 1) / ranks(); }
  // this rank's accumulator of output i, to its owner
  __device__ void acc(int i, float x) const {
    const int owner = ((i + 1) * ranks() - 1) / total;
    float* dst = cg::this_cluster().map_shared_rank(inbox, owner);
    dst[kInboxAcc + rank() * slice() + i - owner * total / ranks()] = x;
  }
  // this rank's (m, l) of head g, to every rank
  __device__ void ml(int g, float m, float l) const {
    for (int owner = 0; owner < ranks(); ++owner) {
      float* dst = cg::this_cluster().map_shared_rank(inbox, owner);
      dst[2 * (rank() * kGroupMax + g)] = m;
      dst[2 * (rank() * kGroupMax + g) + 1] = l;
    }
  }
  // barrier B, then this rank's slice of the outputs
  template <typename T, int D>
  __device__ void merge(T* out_row) const {
    cluster_arrive();
    cluster_wait();
    const int rank = this->rank(), ranks = this->ranks();
    const int slice = (total + ranks - 1) / ranks;
    const int lo = rank * total / ranks;
    const int hi = (rank + 1) * total / ranks;
    for (int i = lo + (int)threadIdx.x; i < hi; i += blockDim.x) {
      const int g = i / D;
      float mx = kNegInf;
      for (int r = 0; r < ranks; ++r)
        mx = fmaxf(mx, inbox[2 * (r * kGroupMax + g)]);
      float den = 0.f, num = 0.f;
      for (int r = 0; r < ranks; ++r) {
        const float wt = exp2f(inbox[2 * (r * kGroupMax + g)] - mx);
        den = fmaf(wt, inbox[2 * (r * kGroupMax + g) + 1], den);
        num = fmaf(wt, inbox[kInboxAcc + r * slice + i - lo], num);
      }
      out_row[i] = from_float<T>(num / fmaxf(den, 1e-30f));
    }
  }
};

// Where a block's partial goes for the combine launch: (m, l) of head g,
// and the accumulators.
__device__ __forceinline__ void put_part_ml(float* part_ml, size_t part_row,
                                            int g, float m, float l) {
  part_ml[2 * (part_row + g)] = m;
  part_ml[2 * (part_row + g) + 1] = l;
}

template <typename T, int D>
struct Plan {
  static constexpr int kTileKeys = kTileElems / D;
  static constexpr int kWarpKeys = kTileKeys / kWarps;  // keys a warp takes
  // A staged row: D elements and one 16-byte chunk of padding, so that
  // lanes reading eight consecutive rows by 16 bytes hit distinct banks.
  static constexpr int kLds = D + 16 / sizeof(T);
  static constexpr int kSlots = kGroupMax * D / 4 / 32;  // float4s a lane
  static constexpr size_t kTileBytes =
      (size_t)kStages * 2 * kTileKeys * kLds * sizeof(T);
  // the warps' merge reuses the tiles: each warp's accumulators
  static constexpr size_t kMergeBytes =
      sizeof(float) * kWarps * kGroupMax * D;
  static constexpr size_t kFront =
      kTileBytes > kMergeBytes ? kTileBytes : kMergeBytes;
  // then q (f32), each warp's scores/weights, and each warp's m, l and
  // rescale factors
  static constexpr size_t kTail =
      kFront + sizeof(float) * (kGroupMax * D +
                                kWarps * kGroupMax * kWarpKeys +
                                kWarps * 3 * kGroupMax);
  // the cluster's inbox: over the tiles, past the warps' accumulators,
  // where it fits; else after the rest
  static constexpr bool kInboxInTiles =
      kMergeBytes + inbox_bytes<D>() <= kTileBytes;
  static constexpr size_t kInbox = kInboxInTiles ? kMergeBytes : kTail;
  static constexpr size_t kSmem =
      kInboxInTiles ? kTail : kTail + inbox_bytes<D>();
  static_assert(kWarpKeys >= 1, "a tile must give every warp a key");
  static_assert(kSlots >= 1, "a lane must hold at least one slot");
  static_assert(kFront % 16 == 0, "q must stay 16-byte aligned");
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                        const KV* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ part, int b,
                        int h, int s, int kv, int head_blocks, int splits,
                        int keys_per_split, float scale, bool vec, int emit) {
  using P = Plan<KV, D>;
  constexpr int TK = P::kTileKeys;
  constexpr int KW = P::kWarpKeys;
  constexpr int LDS = P::kLds;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int split = blockIdx.x;
  const int hb = head_blocks == 1 ? 0 : blockIdx.y % head_blocks;
  const int kvh = head_blocks == 1 ? blockIdx.y : blockIdx.y / head_blocks;
  const int row = blockIdx.z;
  const int group = h / kv;
  const int g_first = hb * kGroupMax;
  const int gb = min(kGroupMax, group - g_first);  // heads of this block
  const int head0 = kvh * group + g_first;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* tiles = reinterpret_cast<KV*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(smem_raw + P::kFront);
  float* sc = q_s + kGroupMax * D + warp * kGroupMax * KW;
  float* ml = q_s + kGroupMax * D + kWarps * kGroupMax * KW;
  float* inbox = reinterpret_cast<float*>(smem_raw + P::kInbox);

  const size_t key_stride = (size_t)kv * D;
  const KV* k_row = k + ((size_t)row * s * kv + kvh) * D;
  const KV* v_row = v + ((size_t)row * s * kv + kvh) * D;
  const int begin = split * keys_per_split;
  // Stage tile t of the keys [begin, stop).
  auto issue = [&](int t, int stop) {
    const int key0 = begin + t * TK;
    const int rows = min(TK, stop - key0);
    KV* k_s = tiles + (size_t)(t % kStages) * 2 * TK * LDS;
    tc::stage(k_s, LDS, k_row + key0 * key_stride, (long long)key_stride,
              rows, rows, D, D, vec);
    tc::stage(k_s + TK * LDS, LDS, v_row + key0 * key_stride,
              (long long)key_stride, rows, rows, D, D, vec);
    tc::cp_async_commit();
  };
  // Tile 0 and q go in flight before lengths[row] arrives, so the two
  // loads overlap: tile 0 is read whatever the row's length (at most one
  // tile past its valid prefix).
  issue(0, min(begin + keys_per_split, s));
  const T* q_row = q + ((size_t)row * h + head0) * D;
  for (int i = tid; i < gb * D; i += kThreads) q_s[i] = tc::to_float(q_row[i]);

  const int length = lengths[row];
  // A key at or past `length` scores -1e30.  When at least one key is
  // valid, such a key's weight exp(-1e30 - m) is exactly 0 in f32, so only
  // the valid prefix is read; a row with no valid key scores every key
  // -1e30 and gets the mean of V.
  const bool masked = length < 1;
  const int n_keys = masked ? s : min(length, s);
  const int end = min(begin + keys_per_split, n_keys);

  const size_t bh = (size_t)b * h;
  float* part_ml = part;
  float* part_acc = part + 2 * (size_t)splits * bh;
  const size_t part_row = ((size_t)split * b + row) * h + head0;
  const ClusterPush push{inbox, gb * D};
  // this block's partial, to the cluster's merge or the combine launch
  auto put = [&](int i, float x) {
    if (emit == kCluster)
      push.acc(i, x);
    else
      part_acc[part_row * D + i] = x;
  };
  auto put_ml = [&](int g, float m, float l) {
    if (emit == kCluster)
      push.ml(g, m, l);
    else
      put_part_ml(part_ml, part_row, g, m, l);
  };

  if (begin >= end) {  // only with splits > 1: an empty partial
    tc::cp_async_wait<0>();
    if (emit == kCluster) {
      cluster_arrive();  // barrier A: this block's tiles are free
      cluster_wait();
    }
    for (int i = tid; i < gb * D; i += kThreads) {
      put(i, 0.f);
      if (i % D == 0) put_ml(i / D, kNegInf, 0.f);
    }
    if (emit == kCluster)
      push.merge<T, D>(out + ((size_t)row * h + head0) * D);
    return;
  }
  const int n_tiles = (end - begin + TK - 1) / TK;
  // scores in log2 units, so that each weight is one exp2f
  const float scale_log2 = scale * 1.44269504088896341f;

  // Each warp's online-softmax state, the same in all its lanes: m and l
  // of each head, and the last tile's rescale factor.
  float* m_w = ml + warp * 3 * kGroupMax;
  float* l_w = m_w + kGroupMax;
  float* alpha = l_w + kGroupMax;
  if (lane < kGroupMax) {
    m_w[lane] = kNegInf;
    l_w[lane] = 0.f;
  }
  float4 acc[P::kSlots];
#pragma unroll
  for (int i = 0; i < P::kSlots; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // A range of at most one warp's share of a tile (the serving shapes) goes
  // to warp 0 alone, which then writes the result itself: no merge.
  const bool one_warp = end - begin <= KW;

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<0>();
    // tile t is in (and q, on the first pass); every warp is done with
    // the buffer that tile t + 1 fills
    __syncthreads();
    if (t + 1 < n_tiles) issue(t + 1, end);

    const KV* k_s = tiles + (size_t)(t % kStages) * 2 * TK * LDS;
    const KV* v_s = k_s + TK * LDS;
    const int tile_len = min(TK, end - (begin + t * TK));
    // this warp's keys: a quarter of the tile, spread evenly when it is
    // short
    const int per_warp =
        one_warp ? tile_len : (tile_len + kWarps - 1) / kWarps;
    const int j0 = warp * per_warp;
    const int nw = max(0, min(per_warp, tile_len - j0));
    if (nw == 0) continue;  // warp-uniform; no barrier below

    // scores and online softmax, one lane a (head, key) pair: `span`
    // lanes a head (nw rounded up to a power of two, at most 32), so each
    // head's keys sit in an aligned group of lanes whose maximum and sum
    // take a few xor shuffles, the heads of a pass at once.  A lane
    // computes whole dot products (no shuffle per pair) and reads back
    // only its own scores.
    int log_span = 0;
    while ((1 << log_span) < nw && log_span < 5) ++log_span;
    const int span = 1 << log_span;
    for (int g0 = 0; g0 < gb; g0 += 32 >> log_span) {
      const int g = g0 + (lane >> log_span);
      const int first = lane & (span - 1);
      const bool live = g < gb;
      float* row_sc = sc + (live ? g : 0) * KW;
      float x = kNegInf;
      for (int jj = first; live && jj < nw; jj += span) {
        const float score =
            masked ? kNegInf
                   : dot_row<D>(q_s + g * D, k_s + (j0 + jj) * LDS) *
                         scale_log2;
        row_sc[jj] = score;
        x = fmaxf(x, score);
      }
      for (int off = span / 2; off > 0; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      const float m_old = live ? m_w[g] : kNegInf;
      const float m_new = fmaxf(m_old, x);
      float sum = 0.f;
      for (int jj = first; live && jj < nw; jj += span) {
        const float w = exp2f(row_sc[jj] - m_new);
        row_sc[jj] = w;
        sum += w;
      }
      for (int off = span / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (live && first == 0) {
        const float a = exp2f(m_old - m_new);
        l_w[g] = l_w[g] * a + sum;
        m_w[g] = m_new;
        alpha[g] = a;
      }
    }
    __syncwarp();

    // acc = acc * alpha + p . V over the warp's keys, float4 slots of
    // (head, channel)
#pragma unroll
    for (int i = 0; i < P::kSlots; ++i) {
      const int slot = lane + 32 * i;
      if (slot < gb * (D / 4)) {
        const int g = slot / (D / 4);
        const int e = (slot - g * (D / 4)) * 4;
        const float a = alpha[g];
        float4 o = acc[i];
        o.x *= a;
        o.y *= a;
        o.z *= a;
        o.w *= a;
        const float* w = sc + g * KW;
        const KV* vp = v_s + j0 * LDS + e;
#pragma unroll 4
        for (int jj = 0; jj < nw; ++jj) {
          const float pw = w[jj];
          const float4 vv = load4(vp + jj * LDS);
          o.x = fmaf(pw, vv.x, o.x);
          o.y = fmaf(pw, vv.y, o.y);
          o.z = fmaf(pw, vv.z, o.z);
          o.w = fmaf(pw, vv.w, o.w);
        }
        acc[i] = o;
      }
    }
  }

  T* out_row = out + ((size_t)row * h + head0) * D;
  if (emit == kCluster) cluster_arrive();  // barrier A: tiles read
  if (one_warp) {  // warp 0 holds the whole range
    if (emit == kCluster) cluster_wait();
    if (warp == 0) {
      __syncwarp();
#pragma unroll
      for (int i = 0; i < P::kSlots; ++i) {
        const int slot = lane + 32 * i;
        if (slot < gb * (D / 4)) {
          const int g = slot / (D / 4);
          const int e = (slot - g * (D / 4)) * 4;
          const float o[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
          const float inv = 1.f / fmaxf(l_w[g], 1e-30f);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (emit == kOut)
              out_row[g * D + e + c] = from_float<T>(o[c] * inv);
            else
              put(g * D + e + c, o[c]);
          }
          if (emit != kOut && e == 0) put_ml(g, m_w[g], l_w[g]);
        }
      }
    }
    if (emit == kCluster) push.merge<T, D>(out_row);
    return;
  }

  // merge the four warps: each writes its accumulators over the tiles,
  // which every warp is done with
  __syncthreads();
  float* aa = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < P::kSlots; ++i) {
    const int slot = lane + 32 * i;
    if (slot < gb * (D / 4))
      *reinterpret_cast<float4*>(aa + warp * kGroupMax * D + slot * 4) =
          acc[i];
  }
  __syncthreads();
  if (emit == kCluster) cluster_wait();  // every rank's tiles are free

  for (int i = tid; i < gb * D; i += kThreads) {
    const int g = i / D;
    float mx = ml[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      mx = fmaxf(mx, ml[w * 3 * kGroupMax + g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* mw = ml + w * 3 * kGroupMax;
      const float wt = exp2f(mw[g] - mx);
      den = fmaf(wt, mw[kGroupMax + g], den);
      num = fmaf(wt, aa[w * kGroupMax * D + i], num);
    }
    if (emit == kOut) {
      out_row[i] = from_float<T>(num / fmaxf(den, 1e-30f));
    } else {
      put(i, num);
      if (i - g * D == 0) put_ml(g, mx, den);
    }
  }
  if (emit == kCluster) push.merge<T, D>(out_row);
}

// ------------------------------------------ bf16: the group on tensor cores
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  const __nv_bfloat162 p = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Four 8 x 8 bf16 matrices from shared memory, lane i giving the address
// of row i % 8 of matrix i / 8; `trans` transposes each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// The transpose of an 8 x 8 bf16 matrix held as a fragment (lane 4 g + t:
// row g, columns 2t and 2t + 1).
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(y)
               : "r"(x));
  return y;
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
// Fragments, lane 4 g + t: a0 (row g, columns 2t, 2t + 1), a1 (g + 8, 2t),
// a2 (g, 2t + 8), a3 (g + 8, 2t + 8); b0 (rows 2t, 2t + 1, column g), b1
// (rows 2t + 8, 2t + 9, g); c0, c1 (row g, columns 2t, 2t + 1), c2, c3
// (row g + 8).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int D>
struct MmaPlan {
  static constexpr int kChunk = 16;                    // keys a warp a tile
  static constexpr int kTileKeys = kChunk * kWarps;    // 64
  // A staged row: D bf16 and 16 bytes of padding, so that the eight rows
  // an ldmatrix reads fall in distinct banks at every D.
  static constexpr int kLds = D + 8;
  static constexpr size_t kTileBytes =
      (size_t)kStages * 2 * kTileKeys * kLds * sizeof(__nv_bfloat16);
  // the warps' merge reuses the tiles: each warp's m and l of every head,
  // then its accumulators (head, channel)
  static constexpr int kWarpFloats = 2 * kGroupMax + kGroupMax * D;
  static constexpr size_t kMergeBytes = sizeof(float) * kWarps * kWarpFloats;
  // the cluster's inbox: over the tiles, past the warps' accumulators
  static constexpr size_t kInbox = kMergeBytes;
  static constexpr size_t kSmem = kTileBytes > kInbox + inbox_bytes<D>()
                                      ? kTileBytes
                                      : kInbox + inbox_bytes<D>();
  static_assert(kInbox % 16 == 0, "the inbox must stay 16-byte aligned");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int32_t* __restrict__ lengths,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ part, int b, int h, int s, int kv,
                      int head_blocks, int splits, int keys_per_split,
                      float scale, bool vec, int emit) {
  using P = MmaPlan<D>;
  using bf16 = __nv_bfloat16;
  constexpr int TK = P::kTileKeys;
  constexpr int LDS = P::kLds;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  const int split = blockIdx.x;
  const int hb = head_blocks == 1 ? 0 : blockIdx.y % head_blocks;
  const int kvh = head_blocks == 1 ? blockIdx.y : blockIdx.y / head_blocks;
  const int row = blockIdx.z;
  const int group = h / kv;
  const int g_first = hb * kGroupMax;
  const int gb = min(kGroupMax, group - g_first);  // heads of this block
  const int head0 = g_first + kvh * group;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* tiles = reinterpret_cast<bf16*>(smem_raw);
  float* inbox = reinterpret_cast<float*>(smem_raw + P::kInbox);

  const size_t key_stride = (size_t)kv * D;
  const bf16* k_row = k + ((size_t)row * s * kv + kvh) * D;
  const bf16* v_row = v + ((size_t)row * s * kv + kvh) * D;
  const int begin = split * keys_per_split;
  // Stage tile t of the keys [begin, stop); rows past `stop` are zeros, so
  // a chunk's keys past the range (weight 0) meet finite V.
  auto issue = [&](int tile, int stop) {
    const int key0 = begin + tile * TK;
    const int rows = min(TK, stop - key0);
    bf16* k_s = tiles + (size_t)(tile % kStages) * 2 * TK * LDS;
    tc::stage(k_s, LDS, k_row + key0 * key_stride, (long long)key_stride,
              rows, TK, D, D, vec);
    tc::stage(k_s + TK * LDS, LDS, v_row + key0 * key_stride,
              (long long)key_stride, rows, TK, D, D, vec);
    tc::cp_async_commit();
  };
  issue(0, min(begin + keys_per_split, s));

  // q^T as the B fragments of S^T = K . q^T: channels 16 kk + 2t, 2t + 1
  // (and + 8) of head g; heads past the block's are zeros
  uint32_t qf[D / 16][2];
  {
    const bf16* q_head = q + ((size_t)row * h + head0 + min(g, gb - 1)) * D;
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = 16 * kk + 2 * t;
      qf[kk][0] = g < gb ? pack_bf16(q_head[c], q_head[c + 1])
                         : pack_bf16(zero, zero);
      qf[kk][1] = g < gb ? pack_bf16(q_head[c + 8], q_head[c + 9])
                         : pack_bf16(zero, zero);
    }
  }

  const int length = lengths[row];
  // As in decode_split_kernel: only the valid prefix is read, and a row
  // with no valid key scores every key -1e30 (the mean of V).
  const bool masked = length < 1;
  const int n_keys = masked ? s : min(length, s);
  const int end = min(begin + keys_per_split, n_keys);
  const int n_tiles = begin < end ? (end - begin + TK - 1) / TK : 0;
  const float scale_log2 = scale * 1.44269504088896341f;

  // this warp's online softmax of heads 2t and 2t + 1 (the same in every
  // lane of a t), its lane's part of their sums, and O^T's fragments:
  // channel 16 mt + g (+ 8), heads 2t, 2t + 1
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[D / 16][4];
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    tc::cp_async_wait<0>();
    // tile `tile` is in; every warp is done with the buffer the next fills
    __syncthreads();
    if (tile + 1 < n_tiles) issue(tile + 1, end);
    const int key0 = begin + tile * TK + P::kChunk * warp;
    if (key0 >= end) continue;  // warp-uniform; no barrier below
    const bf16* k_s = tiles + (size_t)(tile % kStages) * 2 * TK * LDS +
                      P::kChunk * warp * LDS;
    const bf16* v_s = k_s + TK * LDS;

    // S^T (16 keys x 8 heads): A from K by ldmatrix (matrices: keys 0-7 /
    // 8-15 x channels 0-7, then channels 8-15)
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* k_lane =
        k_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 8 * (lane >> 4);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, k_lane + 16 * kk);
      mma_bf16(c, a, qf[kk]);
    }
    // the scale in f32, then the masks: key0 + g and key0 + g + 8
    const bool in0 = key0 + g < end, in1 = key0 + g + 8 < end;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = e < 2 ? in0 : in1;
      c[e] = !in ? -INFINITY : masked ? kNegInf : c[e] * scale_log2;
    }
    float mx0 = fmaxf(c[0], c[2]), mx1 = fmaxf(c[1], c[3]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    mx0 = fmaxf(m0, mx0);
    mx1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    c[0] = exp2f(c[0] - m0);
    c[1] = exp2f(c[1] - m1);
    c[2] = exp2f(c[2] - m0);
    c[3] = exp2f(c[3] - m1);
    l0 = l0 * alpha0 + (c[0] + c[2]);
    l1 = l1 * alpha1 + (c[1] + c[3]);
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      acc[mt][0] *= alpha0;
      acc[mt][1] *= alpha1;
      acc[mt][2] *= alpha0;
      acc[mt][3] *= alpha1;
    }
    // P^T as B (keys 2t, 2t + 1 (+ 8), head g): P in bf16, transposed
    const uint32_t pb[2] = {movmatrix_trans(pack_bf16(c[0], c[1])),
                            movmatrix_trans(pack_bf16(c[2], c[3]))};
    // O^T += V^T . P^T: A from V by ldmatrix.trans (matrices: keys 0-7 x
    // channels 0-7, 8-15, then keys 8-15)
    const bf16* v_lane =
        v_s + ((lane & 7) + 8 * (lane >> 4)) * LDS + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int mt = 0; mt < D / 16; ++mt) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, v_lane + 16 * mt);
      mma_bf16(acc[mt], a, pb);
    }
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // merge the four warps over the tiles, which every warp is done with
  tc::cp_async_wait<0>();
  if (emit == kCluster) cluster_arrive();  // barrier A: tiles read
  __syncthreads();
  float* mine = reinterpret_cast<float*>(smem_raw) + warp * P::kWarpFloats;
  if (g == 0) {
    mine[2 * t] = m0;
    mine[2 * t + 1] = m1;
    mine[kGroupMax + 2 * t] = l0;
    mine[kGroupMax + 2 * t + 1] = l1;
  }
#pragma unroll
  for (int mt = 0; mt < D / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mine[2 * kGroupMax + (2 * t + (e & 1)) * D + 16 * mt + g +
           8 * (e >> 1)] = acc[mt][e];
  __syncthreads();

  if (emit == kCluster) cluster_wait();  // every rank's tiles are free

  const float* ws = reinterpret_cast<const float*>(smem_raw);
  const size_t bh = (size_t)b * h;
  const size_t part_row = ((size_t)split * b + row) * h + head0;
  float* part_acc = part + 2 * (size_t)splits * bh + part_row * D;
  bf16* out_row = out + ((size_t)row * h + head0) * D;
  const ClusterPush push{inbox, gb * D};
  for (int i = tid; i < gb * D; i += kThreads) {
    const int hd = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, ws[w * P::kWarpFloats + hd]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wf = ws + w * P::kWarpFloats;
      const float wt = exp2f(wf[hd] - mx);
      den = fmaf(wt, wf[kGroupMax + hd], den);
      num = fmaf(wt, wf[2 * kGroupMax + i], num);
    }
    if (emit == kOut) {
      out_row[i] = __float2bfloat16(num / fmaxf(den, 1e-30f));
    } else if (emit == kCluster) {
      push.acc(i, num);
      if (i - hd * D == 0) push.ml(hd, mx, den);
    } else {
      part_acc[i] = num;
      if (i - hd * D == 0) put_part_ml(part, part_row, hd, mx, den);
    }
  }
  if (emit == kCluster) push.merge<bf16, D>(out_row);
}

// One warp per (row, query head): merges the splits' partials.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                          int bh, int splits) {
  constexpr int PER = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int rh = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (rh >= bh) return;
  const float* part_ml = part;
  const float* part_acc = part + 2 * (size_t)splits * bh;
  float mx = kNegInf;
  for (int i = 0; i < splits; ++i)
    mx = fmaxf(mx, part_ml[2 * ((size_t)i * bh + rh)]);
  float den = 0.f;
  float num[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) num[j] = 0.f;
  for (int i = 0; i < splits; ++i) {
    const size_t r = (size_t)i * bh + rh;
    const float wt = exp2f(part_ml[2 * r] - mx);
    den = fmaf(wt, part_ml[2 * r + 1], den);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = lane + 32 * j;
      if (e < D) num[j] = fmaf(wt, part_acc[r * D + e], num[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = lane + 32 * j;
    if (e < D)
      out[(size_t)rh * D + e] = from_float<T>(num[j] / fmaxf(den, 1e-30f));
  }
}

// The block kernel of this (T, KV, D): tensor cores for bf16 q and cache,
// CUDA cores under f32 q.
template <typename T, typename KV, int D>
struct BlockKernel {
  using Fn = void (*)(const T*, const KV*, const KV*, const int32_t*, T*,
                      float*, int, int, int, int, int, int, int, float, bool,
                      int);
  static constexpr bool kMma = sizeof(T) == 2 && sizeof(KV) == 2;
  static constexpr size_t kSmem =
      kMma ? MmaPlan<D>::kSmem : Plan<KV, D>::kSmem;
  static Fn fn() {
    if constexpr (kMma)
      return decode_mma_kernel<D>;
    else
      return decode_split_kernel<T, KV, D>;
  }
};

// T: q's and out's type; KV: K's and V's.  splits <= kClusterMax: one
// launch, the splits of a (row, KV head, head group) one cluster; more:
// the partials through `part`, merged by a second launch.
template <typename T, typename KV, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, void* part, int b, int h,
                   int s, int kv, int splits, int keys_per_split, float scale,
                   cudaStream_t stream) {
  using K = BlockKernel<T, KV, D>;
  constexpr size_t smem = K::kSmem;
  static_assert(smem <= kMaxSmem, "decode tiles exceed shared memory");
  const auto kernel = K::fn();
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int head_blocks = (h / kv + kGroupMax - 1) / kGroupMax;
  const bool vec = ((reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int emit = splits == 1 ? kOut : splits <= kClusterMax ? kCluster
                                                               : kPart;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(splits, kv * head_blocks, b);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  if (emit == kCluster) {
    config.attrs = cluster;
    config.numAttrs = 1;
  }
  cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), static_cast<float*>(part), b, h, s, kv,
      head_blocks, splits, keys_per_split, scale, vec, emit);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || emit != kPart) return err;
  const int bh = b * h;
  decode_combine_kernel<T, D><<<(bh + kWarps - 1) / kWarps, kThreads, 0,
                                stream>>>(static_cast<const float*>(part),
                                          static_cast<T*>(out), bh, splits);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              const void* lengths, void* out, void* part,
                              int b, int h, int s, int kv, int d, int splits,
                              int keys_per_split, float scale,
                              cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, KV, 16>(q, k, v, lengths, out, part, b, h, s, kv,
                               splits, keys_per_split, scale, stream);
    case 32:
      return launch<T, KV, 32>(q, k, v, lengths, out, part, b, h, s, kv,
                               splits, keys_per_split, scale, stream);
    case 64:
      return launch<T, KV, 64>(q, k, v, lengths, out, part, b, h, s, kv,
                               splits, keys_per_split, scale, stream);
    case 128:
      return launch<T, KV, 128>(q, k, v, lengths, out, part, b, h, s, kv,
                                splits, keys_per_split, scale, stream);
    case 256:
      return launch<T, KV, 256>(q, k, v, lengths, out, part, b, h, s, kv,
                                splits, keys_per_split, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (q and out) and kv_dtype (K and V): 0 = float32, 1 = bfloat16; the
// pairs (0, 0), (1, 1) and (0, 1).  `part` holds splits * b * h * (d + 2)
// floats and is used only when splits > kClusterMax (8); up to that the
// splits merge in a cluster and a call is one launch.  The key ranges of
// the splits, keys_per_split each, must cover s with none empty.  Returns
// the launches' cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* out, void* part, int b, int h,
                                      int s, int kv, int d, int dtype,
                                      int kv_dtype, int splits,
                                      int keys_per_split, float scale,
                                      void* stream) {
  if (b < 1 || b > 65535 || kv < 1 || h % kv != 0 || s < 1 || splits < 1 ||
      keys_per_split < 1 || (long long)splits * keys_per_split < s ||
      (long long)(splits - 1) * keys_per_split >= s ||
      (splits > kClusterMax && part == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && kv_dtype == 0)
    return dispatch_head_dim<float, float>(q, k, v, lengths, out, part, b, h,
                                           s, kv, d, splits, keys_per_split,
                                           scale, st);
  if (dtype == 1 && kv_dtype == 1)
    return dispatch_head_dim<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, lengths, out, part, b, h, s, kv, d, splits, keys_per_split,
        scale, st);
  if (dtype == 0 && kv_dtype == 1)
    return dispatch_head_dim<float, __nv_bfloat16>(
        q, k, v, lengths, out, part, b, h, s, kv, d, splits, keys_per_split,
        scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
