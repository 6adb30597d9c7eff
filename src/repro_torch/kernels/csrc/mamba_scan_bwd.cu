// The backward of mamba_scan.cu, in the JAX layout: delta (B, S, di), B and
// C (B, S, ds), A (di, ds) fp32, x (B, S, di) fp32 or bf16, the forward's
// chunk-start states ckpt (B, ceil(S / TC), di, ds) fp32, and the gradients
// of y (B, S, di) and of h_fin (B, di, ds), fp32 -> ddelta, dx (B, S, di),
// dB, dC (B, S, ds) and dA (di, ds), fp32. ds in {4, 8, 16, 32}; di a
// multiple of 8 (the wrapper pads and cuts).
//
// Replaces: none. The Pallas kernel (src/repro/kernels/mamba_scan.py:55) has
// no backward: the JAX trainer differentiates the checkpointed lax.scan of
// models/ssm.py:126-137. This kernel gives the port's autograd.Function its
// backward.
//
// What it computes: with a_t = exp(delta_t A) and Gh the gradient of h_t
// (starting at the gradient of h_fin), for t = S-1 .. 0 and each channel c:
//   Gh += dy_t[c] C_t,
//   dC_t += dy_t[c] h_t[c],  dB_t += Gh delta_t[c] x_t[c]  (sums over c),
//   dx_t[c] = delta_t[c] (Gh . B_t),
//   ddelta_t[c] = x_t[c] (Gh . B_t) + sum_s Gh[s] h_{t-1}[s] a_t[s] A[c][s],
//   dA[c] += Gh h_{t-1} a_t delta_t[c]  (a sum over b and t),
//   Gh <- a_t Gh.
// h_{t-1} is recomputed forward from the chunk's checkpoint with the
// forward's own formula (exp2 of delta (A log2 e) by ex2.approx, the same
// fused multiply-adds), so it equals the forward's state bit for bit; never
// by dividing by a_t, which can be ~0. a_t is recomputed the same way.
//
// What bounds it: the function needs per state element and step one exp
// (a_t) and ~21 flops; this kernel computes a_t twice, once in the
// recompute of the forward's step and once in the step back. At the jamba
// layer's shape (B 4, S 2048, di 16384, ds 16) the bytes bind: 2.4 GB of
// delta, x (bf16), dy, ddelta and dx and 0.54 GB of checkpoints, 0.88 ms
// at 3.35 TB/s. The function's 2.1 G exps take 0.44 ms at the least (the
// special-function and FMA pipes balanced); this kernel's 4.3 G, all on
// the special-function units, take 1.1 ms at 16 a clock per SM and 1.98
// GHz. The warps' partial sums of dB and dC add 0.54 GB, written and read
// again. The recomputed states go through local memory (1 KB a thread a
// chunk).
//
// Design: one thread per (b, channel), 128 channels a block, its ds values
// of Gh, of A and of dA in registers; it walks the chunks from the last,
// with the chunk's B and C staged in shared memory. dB and dC are sums over
// every channel: each step's 2 ds values are summed over the warp's 32
// channels by a reduce-scatter of shuffles (one value a lane at ds 16) and
// written as that warp's partial; dA is written per b. A second launch sums
// the warps' partials into dB and dC and the batches' into dA, each in a
// fixed order. No atomics: repeated runs agree bit for bit.
#include "common.cuh"
#include "mamba_scan.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int NC = 128;  // channels (threads) a block

template <typename T, int DS>
__global__ void __launch_bounds__(NC)
scan_bwd(const float* __restrict__ delta, const float* __restrict__ bm,
         const float* __restrict__ cm, const T* __restrict__ x,
         const float* __restrict__ A, const float* __restrict__ ckpt,
         const float* __restrict__ dy, const float* __restrict__ dh_fin,
         float* __restrict__ ddelta, float* __restrict__ dx,
         float* __restrict__ da_part, float* __restrict__ bc_part, int S,
         int di) {
  constexpr int NR = 2 * DS;                      // dC then dB, a step
  constexpr int NF = NR / 32 > 0 ? NR / 32 : 1;   // sums a lane holds
  __shared__ __align__(16) float bs[TC][DS], cs[TC][DS];
  const int tid = threadIdx.x, b = blockIdx.y;
  const int i = blockIdx.x * NC + tid;
  const bool live = i < di;
  const int ic = live ? i : di - 1;      // a ragged block's spare lanes
  const int n_chunks = (S + TC - 1) / TC;
  const int warps = gridDim.x * (NC / 32);
  const int gw = blockIdx.x * (NC / 32) + (tid >> 5);
  float a2[DS], Af[DS], G[DS], dA[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    Af[s] = A[static_cast<int64_t>(ic) * DS + s];
    a2[s] = Af[s] * LOG2E;
    G[s] = live ? dh_fin[(static_cast<int64_t>(b) * di + i) * DS + s] : 0.f;
    dA[s] = 0.f;
  }
  float hst[TC * DS];           // the chunk's h_{t-1}, local memory

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * TC, n = min(TC, S - t0);
    __syncthreads();            // the last chunk's reads are done
    for (int idx = tid; idx < n * DS; idx += NC) {
      const int64_t off = (static_cast<int64_t>(b) * S + t0) * DS + idx;
      bs[idx / DS][idx % DS] = bm[off];
      cs[idx / DS][idx % DS] = cm[off];
    }
    __syncthreads();
    // the chunk's states before each step, as the forward computed them
    float h[DS];
#pragma unroll
    for (int s = 0; s < DS; ++s)
      h[s] = live ? ckpt[((static_cast<int64_t>(b) * n_chunks + c) * di + i) *
                             DS + s]
                  : 0.f;
#pragma unroll 1
    for (int tt = 0; tt < n; ++tt) {
      const int64_t o = (static_cast<int64_t>(b) * S + t0 + tt) * di + ic;
      const float dt = live ? delta[o] : 0.f;
      const float dxv = dt * to_f(x[o]);
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        hst[tt * DS + s] = h[s];
        h[s] = fmaf(exp2_mufu(dt * a2[s]), h[s], dxv * bs[tt][s]);
      }
    }
#pragma unroll 1
    for (int tt = n - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      const int64_t o = (static_cast<int64_t>(b) * S + t) * di + ic;
      const float dt = live ? delta[o] : 0.f;
      const float xv = live ? to_f(x[o]) : 0.f;
      const float dyt = live ? dy[o] : 0.f;
      const float dxv = dt * xv;
      float red[NR], gb = 0.f, dd = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        const float hp = hst[tt * DS + s];
        const float a = exp2_mufu(dt * a2[s]);
        const float ht = fmaf(a, hp, dxv * bs[tt][s]);
        const float g = fmaf(dyt, cs[tt][s], G[s]);
        red[s] = dyt * ht;
        red[DS + s] = g * dxv;
        gb = fmaf(g, bs[tt][s], gb);
        const float gha = g * hp * a;
        dd = fmaf(gha, Af[s], dd);
        dA[s] = fmaf(gha, dt, dA[s]);
        G[s] = a * g;
      }
      if (live) {
        ddelta[o] = fmaf(xv, gb, dd);
        dx[o] = dt * gb;
      }
      int idx;
      bool writer;
      warp_reduce_scatter<NR, 1>(red, idx, writer);
      if (writer) {
        float* pp = bc_part +
                    ((static_cast<int64_t>(b) * warps + gw) * S + t) * NR +
                    idx;
#pragma unroll
        for (int f = 0; f < NF; ++f) pp[f] = red[f];
      }
    }
  }
  if (live)
#pragma unroll
    for (int s = 0; s < DS; ++s)
      da_part[(static_cast<int64_t>(b) * di + i) * DS + s] = dA[s];
}

// dC, dB (B, S, ds) from the warps' partials, in order of the warp; then dA
// (di, ds) from the batches', in order of b
template <int DS>
__global__ void bc_sum(const float* __restrict__ bc_part,
                       float* __restrict__ dbm, float* __restrict__ dcm,
                       int B, int S, int warps) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * S * 2 * DS) return;
  const int v = static_cast<int>(idx % (2 * DS));
  const int64_t bt = idx / (2 * DS);              // b * S + t
  const int64_t b = bt / S, t = bt % S;
  float acc = 0.f;
  for (int wq = 0; wq < warps; ++wq)
    acc += bc_part[((b * warps + wq) * S + t) * 2 * DS + v];
  if (v < DS)
    dcm[bt * DS + v] = acc;
  else
    dbm[bt * DS + v - DS] = acc;
}

__global__ void da_sum(const float* __restrict__ da_part,
                       float* __restrict__ dA, int B, int64_t n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += da_part[b * n + idx];
  dA[idx] = acc;
}

template <typename T, int DS>
int launch_typed(const float* delta, const float* bm, const float* cm,
                 const void* x, const float* A, const float* ckpt,
                 const float* dy, const float* dh_fin, float* ddelta,
                 float* dbm, float* dcm, float* dx, float* dA,
                 float* da_part, float* bc_part, int B, int S, int di,
                 cudaStream_t stream) {
  const dim3 grid((di + NC - 1) / NC, B);
  scan_bwd<T, DS><<<grid, NC, 0, stream>>>(
      delta, bm, cm, static_cast<const T*>(x), A, ckpt, dy, dh_fin, ddelta,
      dx, da_part, bc_part, S, di);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps = static_cast<int>(grid.x) * (NC / 32);
  const int64_t nbc = static_cast<int64_t>(B) * S * 2 * DS;
  bc_sum<DS><<<static_cast<unsigned>((nbc + 255) / 256), 256, 0, stream>>>(
      bc_part, dbm, dcm, B, S, warps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t na = static_cast<int64_t>(di) * DS;
  da_sum<<<static_cast<unsigned>((na + 255) / 256), 256, 0, stream>>>(
      da_part, dA, B, na);
  return cudaGetLastError();
}

template <int DS>
int launch_ds(int bf16, const float* delta, const float* bm, const float* cm,
              const void* x, const float* A, const float* ckpt,
              const float* dy, const float* dh_fin, float* ddelta, float* dbm,
              float* dcm, float* dx, float* dA, float* da_part,
              float* bc_part, int B, int S, int di, cudaStream_t stream) {
  if (bf16)
    return launch_typed<__nv_bfloat16, DS>(delta, bm, cm, x, A, ckpt, dy,
                                           dh_fin, ddelta, dbm, dcm, dx, dA,
                                           da_part, bc_part, B, S, di,
                                           stream);
  return launch_typed<float, DS>(delta, bm, cm, x, A, ckpt, dy, dh_fin,
                                 ddelta, dbm, dcm, dx, dA, da_part, bc_part,
                                 B, S, di, stream);
}

}  // namespace

REPRO_ERROR_STRING(mamba_scan_bwd)

// da_part: (B, di, ds) and bc_part: (B, ceil(di / 128) * 4, S, 2 ds) fp32
// scratch for the partial sums
extern "C" int mamba_scan_bwd_launch(
    const float* delta, const float* bm, const float* cm, const void* x,
    const float* A, const float* ckpt, const float* dy, const float* dh_fin,
    float* ddelta, float* dbm, float* dcm, float* dx, float* dA,
    float* da_part, float* bc_part, int B, int S, int di, int ds, int bf16,
    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || di <= 0 || di % 8 || B > 65535)
    return cudaErrorInvalidValue;
  switch (ds) {
    case 4:
      return launch_ds<4>(bf16, delta, bm, cm, x, A, ckpt, dy, dh_fin,
                          ddelta, dbm, dcm, dx, dA, da_part, bc_part, B, S,
                          di, stream);
    case 8:
      return launch_ds<8>(bf16, delta, bm, cm, x, A, ckpt, dy, dh_fin,
                          ddelta, dbm, dcm, dx, dA, da_part, bc_part, B, S,
                          di, stream);
    case 16:
      return launch_ds<16>(bf16, delta, bm, cm, x, A, ckpt, dy, dh_fin,
                           ddelta, dbm, dcm, dx, dA, da_part, bc_part, B, S,
                           di, stream);
    case 32:
      return launch_ds<32>(bf16, delta, bm, cm, x, A, ckpt, dy, dh_fin,
                           ddelta, dbm, dcm, dx, dA, da_part, bc_part, B, S,
                           di, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
