// V-trace targets and policy-gradient advantages for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_vtrace_kernel` / `vtrace` in
// src/repro/kernels/vtrace_kernel.py.  For time-major (T, B) float32 inputs
// values V, next_values V', rewards r, discounts g and importance ratios
// rho, and the clips rho_bar and c_bar:
//
//     rho_c_t = min(rho_t, rho_bar),  c_t = min(rho_t, c_bar)
//     acc_t   = rho_c_t (r_t + g_t V'_t - V_t) + g_t c_t acc_{t+1},  acc_T = 0
//     vs_t    = V_t + acc_t
//     adv_t   = rho_c_t (r_t + g_t vs_{t+1} - V_t),  vs_T = V'_{T-1}
//
// exactly the plain version `vtrace_ref` in ../ref.py.
//
// What bounds it: bytes.  Each element is read once from five inputs and
// written once to two outputs (28 bytes) for about ten flops, far below the
// ~20 f32 operations per byte the card needs before compute is the limit.
// The recurrence runs backwards along T and is independent across B, so the
// design gives each column b one thread (blocks of 128) that walks t from
// T-1 down to 0.  At each t neighbouring threads read neighbouring columns
// of row t, so every load and store is coalesced.  vs_t and adv_t are
// written in the same pass: adv_t needs vs_{t+1}, which is the value the
// previous iteration produced, kept in a register.  Any B >= 1 and T >= 1.
// More columns per thread and prefetching the loads that do not depend on
// the recurrence are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

__global__ void vtrace_kernel(const float* __restrict__ values,
                              const float* __restrict__ next_values,
                              const float* __restrict__ rewards,
                              const float* __restrict__ discounts,
                              const float* __restrict__ rhos,
                              float* __restrict__ vs,
                              float* __restrict__ pg_adv, int T, int B,
                              float clip_rho, float clip_c) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t stride = static_cast<size_t>(B);
  size_t i = static_cast<size_t>(T - 1) * stride + b;
  float acc = 0.0f;
  float vs_next = next_values[i];  // vs_T := next_values[T-1]
  for (int t = T - 1; t >= 0; --t, i -= stride) {
    const float v = values[i];
    const float r = rewards[i];
    const float g = discounts[i];
    const float rho = rhos[i];
    const float rho_c = fminf(rho, clip_rho);
    const float c = fminf(rho, clip_c);
    const float delta = rho_c * (r + g * next_values[i] - v);
    acc = delta + g * c * acc;
    const float vs_t = v + acc;
    vs[i] = vs_t;
    pg_adv[i] = rho_c * (r + g * vs_next - v);
    vs_next = vs_t;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  All
// pointers are contiguous (T, B) float32 arrays on the current device.
extern "C" int repro_vtrace(const void* values, const void* next_values,
                            const void* rewards, const void* discounts,
                            const void* rhos, void* vs, void* pg_adv, int T,
                            int B, float clip_rho, float clip_c,
                            void* stream) {
  if (T < 1 || B < 1) return cudaErrorInvalidValue;
  const dim3 grid((B + kThreads - 1) / kThreads);
  vtrace_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(next_values),
      static_cast<const float*>(rewards), static_cast<const float*>(discounts),
      static_cast<const float*>(rhos), static_cast<float*>(vs),
      static_cast<float*>(pg_adv), T, B, clip_rho, clip_c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
