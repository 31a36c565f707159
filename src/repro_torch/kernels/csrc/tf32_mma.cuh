// Shared pieces of the tensor-core kernels (flash_attention.cu,
// ssd_scan.cu and their backwards): f32-accurate products from three TF32
// `mma.sync` passes.
// The `cp.async` staging and element conversions are in cp_async.cuh.
//
// Three passes.  One TF32 product keeps about three decimal digits, too
// few for the f32 tolerances the kernels are held to.  Each f32 operand x
// is split into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
// (`cvt.rna`), and a product a.b is taken as lo_a.hi_b + hi_a.lo_b +
// hi_a.hi_b, small terms first, with f32 accumulation.  The dropped
// lo_a.lo_b term is ~2^-22 of the product: as accurate as an f32 FMA loop.
// This is what CUTLASS's OpMultiplyAddFastF32 does for f32 on tensor cores.
//
// Fragments of mma.m16n8k8 (tf32): with lane = 4 g + t,
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                    a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)       (row = k, col = n)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                    c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cp_async.cuh"

namespace tc {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 relative, each a TF32 value.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a.b, one TF32 pass.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b to f32 accuracy: lo.hi + hi.lo + hi.hi.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4],
                                     const uint32_t (&b_hi)[2],
                                     const uint32_t (&b_lo)[2]) {
  mma(c, a_lo, b_hi);
  mma(c, a_hi, b_lo);
  mma(c, a_hi, b_hi);
}

// c[i] += a.b[i] for N products that share a, to f32 accuracy, issued
// pass by pass so that the N accumulations overlap.
template <int N>
__device__ __forceinline__ void mma3_n(float (*c)[4],
                                       const uint32_t (&a_hi)[4],
                                       const uint32_t (&a_lo)[4],
                                       const uint32_t (*b_hi)[2],
                                       const uint32_t (*b_lo)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a_lo, b_hi[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a_hi, b_lo[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a_hi, b_hi[i]);
}

// One warp: acc[nt] += A[0 .. 16, 0 .. K) . B[0 .. K, 8 nt .. 8 nt + 8) for
// K a multiple of 8, with a(r, k) and b(k, c) returning f32 elements (from
// shared memory, or built in registers) relative to the warp's tile.
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_mma3(float (&acc)[NT][4], int K, FA a,
                                          FB b) {
  constexpr int NG = NT < 4 ? NT : 4;  // n-tiles whose passes interleave
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    split(a(g, k0 + t), ah[0], al[0]);
    split(a(g + 8, k0 + t), ah[1], al[1]);
    split(a(g, k0 + t + 4), ah[2], al[2]);
    split(a(g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NG) {
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        split(b(k0 + t, 8 * (n0 + i) + g), bh[i][0], bl[i][0]);
        split(b(k0 + t + 4, 8 * (n0 + i) + g), bh[i][1], bl[i][1]);
      }
      mma3_n<NG>(acc + n0, ah, al, bh, bl);
    }
  }
}

// One warp: acc[nt] += P[0 .. 16, 0 .. 8 KT) . B[0 .. 8 KT, 8 nt .. 8 nt + 8)
// with P held in registers as the C fragments p[KT][4] of a 16 x 8 KT
// product, to f32 accuracy.  No shuffles: A's column t stands for P's
// column 2t and column t + 4 for 2t + 1, so B's rows are read in that
// order, b(k, c) returning the f32 element of B's row k.
template <int NT, int KT, typename FB>
__device__ __forceinline__ void frag_mma3(float (&acc)[NT][4],
                                          const float (&p)[KT][4], FB b) {
  constexpr int NG = NT < 4 ? NT : 4;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t ah[4], al[4];
    split(p[kk][0], ah[0], al[0]);  // (g, 2t)
    split(p[kk][2], ah[1], al[1]);  // (g + 8, 2t)
    split(p[kk][1], ah[2], al[2]);  // (g, 2t + 1)
    split(p[kk][3], ah[3], al[3]);  // (g + 8, 2t + 1)
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NG) {
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        split(b(8 * kk + 2 * t, 8 * (n0 + i) + g), bh[i][0], bl[i][0]);
        split(b(8 * kk + 2 * t + 1, 8 * (n0 + i) + g), bh[i][1], bl[i][1]);
      }
      mma3_n<NG>(acc + n0, ah, al, bh, bl);
    }
  }
}

}  // namespace tc
