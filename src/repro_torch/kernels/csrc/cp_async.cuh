// Asynchronous staging from device memory into shared memory (`cp.async`)
// and element conversions, shared by every kernel of the port: flash
// attention and the SSD scan (through tf32_mma.cuh), decode attention and
// V-trace.  A copy is issued by each thread for its own chunks, committed
// as a group and waited for with `cp_async_wait`; a barrier then makes the
// tile visible to the whole block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace tc {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes from global to shared memory; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// 4 bytes from global to shared memory, through L1; src_bytes 0 fills
// zeros.  For rows that are not whole 16-byte chunks.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Whether rows of `row_stride` elements from `base` can go by 16-byte
// copies.
template <typename T>
__device__ __forceinline__ bool aligned16(const T* base,
                                          long long row_stride) {
  return ((reinterpret_cast<uintptr_t>(base) |
           (uintptr_t)(row_stride * (long long)sizeof(T))) &
          15) == 0;
}

// Stage a tile into shared memory, all threads of the block taking part:
// smem[r * lds + c] = src[r * ld + c] for r < rows, c < cols, and 0 for
// rows in [rows, rows_pad) and columns in [cols, cols_pad).  By 16-byte
// cp.async when `vec` (the caller checked the alignment, and cols and
// cols_pad are whole 16-byte chunks), else by plain loads.  The caller
// commits and waits.
template <typename T>
__device__ __forceinline__ void stage(T* smem, int lds, const T* src,
                                      long long ld, int rows, int rows_pad,
                                      int cols, int cols_pad, bool vec) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  if (vec) {
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
    const int chunks = cols_pad / E;
    for (int idx = tid; idx < rows_pad * chunks; idx += nthreads) {
      const int r = idx / chunks;
      const int c = (idx - r * chunks) * E;
      const bool in = r < rows && c < cols;
      cp_async16(smem + r * lds + c, in ? src + r * ld + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < rows_pad * cols_pad; idx += nthreads) {
      const int r = idx / cols_pad;
      const int c = idx - r * cols_pad;
      smem[r * lds + c] =
          r < rows && c < cols ? src[r * ld + c] : static_cast<T>(0.f);
    }
  }
}

}  // namespace tc
