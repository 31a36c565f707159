// Shared pieces of flash attention's mma.sync routes (flash_attention.cu
// and its backward): f32-accurate products from three TF32 `mma.sync`
// passes.  The SSD scan's products are on wgmma (ssd_pipe.cuh).
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

}  // namespace tc
