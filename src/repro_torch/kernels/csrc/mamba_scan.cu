// Mamba selective scan in the JAX layout: delta, x (B, S, di), B, C
// (B, S, ds) and A (di, ds); out y (B, S, di), the scan's output before the
// D skip and the gate, and the state after the last step h_fin (B, di, ds),
// both fp32. delta, B, C and A are fp32; x is fp32 or bf16 (the model
// dtype); ds is 4, 8, 16 or 32; S and di are any sizes.
//
// Replaces: src/repro/kernels/mamba_scan.py:55, mamba_scan_pallas (the JAX
// model path's time scan, models/ssm.py:126-137, computes the same
// recurrence). The Pallas kernel keeps h in VMEM scratch and asks for
// di % 512 == 0 and S % 256 == 0; here h_fin is an output, since the decode
// cache starts from it, and any S and di are taken.
//
// What it computes: with h_0 = 0, for t = 0 .. S-1 and each channel i,
//   h[i][s] <- exp(delta_t[i] A[i][s]) h[i][s] + (delta_t[i] x_t[i]) B_t[s],
//   y_t[i]   = sum_s h[i][s] C_t[s].
//
// What bounds it: operations, then bytes. At the jamba prefill (B 4,
// S 2048, di 16384, ds 16; delta fp32, x bf16) it reads 537 MB of delta and
// 268 MB of x and writes 537 MB of y (B, C, A and h_fin are a few MB):
// 0.40 ms at 3.35 TB/s. It takes one exp per state element and step, 2.15 G
// of them: 0.51 ms at the special-function units' 16 a clock per SM (132
// SMs, 1.98 GHz). Its multiplies and FMAs (10.7 GFLOP) take 0.16 ms at the
// fp32 peak.
//
// Design: one thread per (b, channel), its ds states and its row of A in
// registers for the whole sequence; a block holds 128 consecutive channels
// of one b, so a row of delta, x or y is read or written by the block as
// one coalesced run. B and C, the same for every channel of a b, are staged
// into shared memory TC steps at a time with cp.async (double-buffered) and
// read as broadcasts. Each thread loads its own delta and x PF steps ahead
// into a ring of registers, in x's own dtype, so that a load has PF steps
// of work to land in and any di (no alignment) is taken. y is written
// every step; h_fin once at the end. exp is expf (the accurate one), and
// each state update one fused multiply-add.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_pipeline.h>

namespace {

constexpr int NT = 128;  // threads (channels) a block
constexpr int TC = 32;   // time steps of B and C staged at a time
constexpr int PF = 4;    // steps of delta and x loaded ahead; divides TC

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows t0 .. t0 + TC - 1 of one b's (S, DS) slice into dst[TC][DS], 16
// bytes a copy with cp.async; rows past S are zeros.
template <int DS>
__device__ __forceinline__ void copy_bc(float* dst, const float* src, int t0,
                                        int S) {
  constexpr int PER_ROW = DS / 4;
  for (int idx = threadIdx.x; idx < TC * PER_ROW; idx += NT) {
    const int r = idx / PER_ROW, c = idx % PER_ROW;
    float* d = dst + r * DS + 4 * c;
    if (t0 + r < S)
      __pipeline_memcpy_async(
          d, src + static_cast<int64_t>(t0 + r) * DS + 4 * c, 16);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T, int DS>
__global__ void __launch_bounds__(NT, 4)
scan_kernel(const float* __restrict__ delta, const float* __restrict__ bm,
            const float* __restrict__ cm, const T* __restrict__ x,
            const float* __restrict__ A, float* __restrict__ y,
            float* __restrict__ h_fin, int S, int di) {
  __shared__ __align__(16) float sb[2][TC * DS];
  __shared__ __align__(16) float sc[2][TC * DS];

  const int b = blockIdx.y;
  const int i = blockIdx.x * NT + threadIdx.x;
  const bool live = i < di;
  const int ic = live ? i : di - 1;        // a ragged block's spare lanes
  const int64_t base = static_cast<int64_t>(b) * S * di + ic;
  const float* dp = delta + base;
  const T* xp = x + base;
  float* yp = y + base;
  const float* bb = bm + static_cast<int64_t>(b) * S * DS;
  const float* cb = cm + static_cast<int64_t>(b) * S * DS;

  float a[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a[s] = A[static_cast<int64_t>(ic) * DS + s];
    h[s] = 0.f;
  }
  float dr[PF];  // delta and x of the next PF steps
  T xr[PF];
#pragma unroll
  for (int k = 0; k < PF; ++k) {          // steps past S: never used
    const int64_t off = static_cast<int64_t>(min(k, S - 1)) * di;
    dr[k] = dp[off];
    xr[k] = xp[off];
  }

  const int n_chunks = (S + TC - 1) / TC;
  copy_bc<DS>(sb[0], bb, 0, S);
  copy_bc<DS>(sc[0], cb, 0, S);
  __pipeline_commit();

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, t0 = c * TC;
    __pipeline_wait_prior(0);              // this thread's copies of c
    // every copy of chunk c has landed, and every thread is done with
    // chunk c - 1, whose buffer the next copies overwrite
    __syncthreads();
    if (c + 1 < n_chunks) {
      copy_bc<DS>(sb[buf ^ 1], bb, t0 + TC, S);
      copy_bc<DS>(sc[buf ^ 1], cb, t0 + TC, S);
      __pipeline_commit();
    }
    const int steps = min(TC, S - t0);
    for (int tt = 0; tt < steps; tt += PF) {
#pragma unroll
      for (int k = 0; k < PF; ++k) {
        const int t = t0 + tt + k;
        if (tt + k < steps) {
          const float dt = dr[k];
          const float dx = dt * to_f(xr[k]);
          if (t + PF < S) {
            dr[k] = dp[static_cast<int64_t>(t + PF) * di];
            xr[k] = xp[static_cast<int64_t>(t + PF) * di];
          }
          const float* bt = sb[buf] + (tt + k) * DS;
          const float* ct = sc[buf] + (tt + k) * DS;
          float acc = 0.f;
#pragma unroll
          for (int s = 0; s < DS; s += 4) {
            const float4 b4 = *reinterpret_cast<const float4*>(bt + s);
            const float4 c4 = *reinterpret_cast<const float4*>(ct + s);
            const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              h[s + e] = fmaf(expf(dt * a[s + e]), h[s + e], dx * bv[e]);
              acc = fmaf(h[s + e], cv[e], acc);
            }
          }
          if (live) yp[static_cast<int64_t>(t) * di] = acc;
        }
      }
    }
  }
  if (live) {
    float4* hp = reinterpret_cast<float4*>(
        h_fin + (static_cast<int64_t>(b) * di + i) * DS);
#pragma unroll
    for (int s = 0; s < DS; s += 4)
      hp[s / 4] = make_float4(h[s], h[s + 1], h[s + 2], h[s + 3]);
  }
}

template <typename T, int DS>
int launch_typed(const float* delta, const float* bm, const float* cm,
                 const void* x, const float* A, float* y, float* h_fin,
                 int B, int S, int di, cudaStream_t stream) {
  const dim3 grid((di + NT - 1) / NT, B);
  scan_kernel<T, DS><<<grid, NT, 0, stream>>>(
      delta, bm, cm, static_cast<const T*>(x), A, y, h_fin, S, di);
  return cudaGetLastError();
}

template <int DS>
int launch_ds(int bf16, const float* delta, const float* bm, const float* cm,
              const void* x, const float* A, float* y, float* h_fin, int B,
              int S, int di, cudaStream_t stream) {
  if (bf16)
    return launch_typed<__nv_bfloat16, DS>(delta, bm, cm, x, A, y, h_fin, B,
                                           S, di, stream);
  return launch_typed<float, DS>(delta, bm, cm, x, A, y, h_fin, B, S, di,
                                 stream);
}

}  // namespace

REPRO_ERROR_STRING(mamba_scan)

extern "C" int mamba_scan_launch(const float* delta, const float* bm,
                                 const float* cm, const void* x,
                                 const float* A, float* y, float* h_fin,
                                 int B, int S, int di, int ds, int bf16,
                                 cudaStream_t stream) {
  if (B <= 0 || S <= 0 || di <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  switch (ds) {
    case 4:
      return launch_ds<4>(bf16, delta, bm, cm, x, A, y, h_fin, B, S, di,
                          stream);
    case 8:
      return launch_ds<8>(bf16, delta, bm, cm, x, A, y, h_fin, B, S, di,
                          stream);
    case 16:
      return launch_ds<16>(bf16, delta, bm, cm, x, A, y, h_fin, B, S, di,
                           stream);
    case 32:
      return launch_ds<32>(bf16, delta, bm, cm, x, A, y, h_fin, B, S, di,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}
