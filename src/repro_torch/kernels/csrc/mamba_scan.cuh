// What the Mamba scan's forward (mamba_scan.cu) and backward
// (mamba_scan_bwd.cu) must share for the backward to recompute the
// forward's states bit for bit from its checkpoints: the chunk of steps
// between checkpoints, and the decay exp(delta A) taken as exp2 of
// delta (A log2 e) on the special-function unit.
#pragma once

namespace {

constexpr int TC = 16;   // time steps a chunk: the checkpoint spacing
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the MUFU pipe (ex2.approx.ftz, max relative error 2^-22)
__device__ __forceinline__ float exp2_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
