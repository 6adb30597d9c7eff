// Helpers shared by the port's kernels. Each kernel source is built into a
// shared library of its own with a plain C interface; every launch function
// returns cudaGetLastError() as an int, and <name>_error_string turns that
// code into text for the Python wrapper that raises on it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

#define REPRO_ERROR_STRING(name)                                    \
  extern "C" const char* name##_error_string(int code) {            \
    return cudaGetErrorString(static_cast<cudaError_t>(code));      \
  }

// Sum over the warp, returned to every lane. A down-sweep then a broadcast
// of lane 0, so that all lanes hold the same bits (a butterfly would give
// each lane its own summation order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(FULL_MASK, v, off));
  return __shfl_sync(FULL_MASK, v, 0);
}

// The clip of knowledge_bank.pending_delta for one row, given the sum of
// the squared entries of its averaged gradient and its clamped count:
//   scale = min(1, zmax * max(rms, 1e-12) / max(norm, 1e-12)).
// Every operation is rounded on its own (no fused multiply-add), as the
// PyTorch and JAX references compute it.
__device__ __forceinline__ float clip_scale(float norm, float sqnorm_sum,
                                            float cnt, float zmax) {
  const float rms = __fsqrt_rn(__fdiv_rn(sqnorm_sum, cnt));
  const float cap = __fmul_rn(zmax, fmaxf(rms, 1e-12f));
  return fminf(1.f, __fdiv_rn(cap, fmaxf(norm, 1e-12f)));
}

// One row's update, table + (-lr * avg) * scale, rounded step by step.
__device__ __forceinline__ float apply_delta(float t, float avg, float neg_lr,
                                             float scale) {
  return __fadd_rn(t, __fmul_rn(__fmul_rn(neg_lr, avg), scale));
}
