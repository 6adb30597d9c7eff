// The backward of rwkv_wkv.cu, in the JAX layout: r, k, v (B, S, H, d) in
// the model dtype (fp32 or bf16), w (B, S, H, d) and u (H, d) fp32, the
// forward's chunk-start states ckpt (B, H, ceil(S / TC), d, d) fp32, and the
// gradients of y (B, S, H, d) and of S_fin (B, H, d, d), fp32 -> dr, dk, dv,
// dw (B, S, H, d) and du (H, d), fp32. d in {16, 32, 64}.
//
// Replaces: none. The Pallas kernel (src/repro/kernels/rwkv_wkv.py:54) has
// no backward: the JAX trainer differentiates the checkpointed lax.scan of
// models/ssm.py:253-264. This kernel gives the port's autograd.Function its
// backward.
//
// What it computes: with S_t the state after step t and G the gradient of
// S_t (G starts at the gradient of S_fin), for t = S-1 .. 0:
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i][j] + u[i] k_t[i] (dy_t . v_t),
//   dk_t[i] = r_t[i] u[i] (dy_t . v_t) + sum_j G[i][j] v_t[j],
//   dv_t[j] = dy_t[j] c_t + sum_i G[i][j] k_t[i], c_t = sum_i r_t u k_t,
//   dw_t[i] = sum_j G[i][j] S_{t-1}[i][j],
//   du[i]  += r_t[i] k_t[i] (dy_t . v_t),
//   G[i][j] <- w_t[i] G[i][j] + r_t[i] dy_t[j].
// S_{t-1} is recomputed forward from the chunk's checkpoint with the
// forward's own fused multiply-adds (so it equals the forward's state bit
// for bit), never by dividing by w_t, which can be ~0.
//
// What bounds it: per state element and step it does the forward's state
// update again (3 flops) and 10 flops of its own: 13 B H S d^2 flops, 1.7
// GFLOP at the rwkv6-7b training shape (B 8, S 64, H 64, d 64), 0.026 ms at
// the fp32 peak; the bytes (r, k, v, w, dy, the checkpoints read, four
// gradients written) take longer, ~0.46 ms at the prefill shape (B 4, S
// 2048). The S steps of a head run in
// series, and each step ends in a barrier, so this first version is bound
// by its per-step latency, not by either.
//
// Design: one block per (b, h), 4 d threads; thread (i, q) holds row i and
// columns q d/4 .. q d/4 + d/4 - 1 of G in registers for the whole sequence
// and walks the chunks from the last. A chunk's r, k, v, w and dy are
// staged in shared memory (fp32), with each step's dy . v and c_t (a warp
// a step); the thread recomputes its slice of the chunk's states S_{t-1}
// into local memory, then steps back through them: the row sums dr, dk,
// dw over the row's 4 threads by shuffles; dv's column sums over the
// warp's 8 rows by a reduce-scatter of shuffles, then over the warps
// through shared memory (double-buffered by step, one barrier a step). du
// is summed over time per (b, h) in a fixed order, then over b by a second
// launch. No atomics: repeated runs agree bit for bit.
#include "common.cuh"
#include "rwkv_wkv.cuh"

#include <cuda_bf16.h>

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(4 * D)
wkv_bwd(const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const float* __restrict__ w,
        const float* __restrict__ u, const float* __restrict__ ckpt,
        const float* __restrict__ dy, const float* __restrict__ ds_fin,
        float* __restrict__ dr, float* __restrict__ dk,
        float* __restrict__ dv, float* __restrict__ dw,
        float* __restrict__ du_part, int S, int H) {
  constexpr int THREADS = 4 * D, NC = D / 4, NW = THREADS / 32;
  constexpr int NV = NC * 4 / 32 > 0 ? NC * 4 / 32 : 1;  // dv sums a lane
  __shared__ float rs[TC][D], ks[TC][D], vs[TC][D], ws[TC][D], dys[TC][D];
  __shared__ float us[D], dyv[TC], cts[TC], part[2][NW][D];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid >> 2, j0 = (tid & 3) * NC;
  const bool row_writer = (tid & 3) == 0;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int n_chunks = (S + TC - 1) / TC;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const int64_t step = static_cast<int64_t>(H) * D;     // between steps
  const int64_t base = static_cast<int64_t>(b) * S * step + h * D;

  for (int e = tid; e < D; e += THREADS) us[e] = u[h * D + e];
  float G[NC];
#pragma unroll
  for (int x = 0; x < NC; ++x) G[x] = ds_fin[(bh * D + i) * D + j0 + x];
  float st[TC * NC];            // the chunk's S_{t-1}, local memory
  float du_acc = 0.f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * TC, n = min(TC, S - t0);
    __syncthreads();            // the last chunk's reads are done
    for (int idx = tid; idx < TC * D; idx += THREADS) {
      const int tt = idx / D, e = idx % D;
      const bool in = tt < n;
      const int64_t off = base + (t0 + tt) * step + e;
      rs[tt][e] = in ? to_f(r[off]) : 0.f;
      ks[tt][e] = in ? to_f(k[off]) : 0.f;
      vs[tt][e] = in ? to_f(v[off]) : 0.f;
      ws[tt][e] = in ? w[off] : 0.f;
      dys[tt][e] = in ? dy[off] : 0.f;
    }
    __syncthreads();
    for (int tt = warp; tt < n; tt += NW) {     // dy_t . v_t and c_t
      float a = 0.f, cc = 0.f;
      for (int e = lane; e < D; e += 32) {
        a = fmaf(dys[tt][e], vs[tt][e], a);
        cc = fmaf(rs[tt][e] * us[e], ks[tt][e], cc);
      }
      a = warp_sum(a);
      cc = warp_sum(cc);
      if (lane == 0) {
        dyv[tt] = a;
        cts[tt] = cc;
      }
    }
    // the chunk's states before each step, as the forward computed them
    float s[NC];
#pragma unroll
    for (int x = 0; x < NC; ++x)
      s[x] = ckpt[((bh * n_chunks + c) * D + i) * D + j0 + x];
#pragma unroll 1
    for (int tt = 0; tt < n; ++tt) {
      const float wi = ws[tt][i], ki = ks[tt][i];
#pragma unroll
      for (int x = 0; x < NC; ++x) {
        st[tt * NC + x] = s[x];
        s[x] = fmaf(s[x], wi, ki * vs[tt][j0 + x]);
      }
    }
    __syncthreads();            // dyv and cts are in
#pragma unroll 1
    for (int tt = n - 1; tt >= 0; --tt) {
      const int64_t off = base + (t0 + tt) * step;
      const float rr = rs[tt][i], kk = ks[tt][i], wi = ws[tt][i];
      const float ui = us[i], a_dyv = dyv[tt];
      float pr = 0.f, pw = 0.f, pk = 0.f, col[NC];
#pragma unroll
      for (int x = 0; x < NC; ++x) {
        const float sp = st[tt * NC + x];
        pr = fmaf(dys[tt][j0 + x], sp, pr);
        pw = fmaf(G[x], sp, pw);
        pk = fmaf(G[x], vs[tt][j0 + x], pk);
        col[x] = G[x] * kk;
      }
      // the row sums over the row's 4 threads (lane bits 0 and 1)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        pr += __shfl_xor_sync(FULL_MASK, pr, o);
        pw += __shfl_xor_sync(FULL_MASK, pw, o);
        pk += __shfl_xor_sync(FULL_MASK, pk, o);
      }
      if (row_writer) {
        dr[off + i] = fmaf(ui * kk, a_dyv, pr);
        dk[off + i] = fmaf(rr * ui, a_dyv, pk);
        dw[off + i] = pw;
      }
      du_acc = fmaf(rr * kk, a_dyv, du_acc);
      // dv: sums over the warp's 8 rows (lane bits 2-4), then the warps
      int idx;
      bool writer;
      warp_reduce_scatter<NC, 4>(col, idx, writer);
      if (writer)
#pragma unroll
        for (int x = 0; x < NV; ++x) part[tt & 1][warp][j0 + idx + x] = col[x];
      __syncthreads();
      for (int jj = tid; jj < D; jj += THREADS) {
        float sum = 0.f;
#pragma unroll
        for (int wq = 0; wq < NW; ++wq) sum += part[tt & 1][wq][jj];
        dv[off + jj] = fmaf(dys[tt][jj], cts[tt], sum);
      }
#pragma unroll
      for (int x = 0; x < NC; ++x)
        G[x] = fmaf(wi, G[x], rr * dys[tt][j0 + x]);
    }
  }
  if (row_writer) du_part[bh * D + i] = du_acc;
}

// du[h][i] = sum over b of du_part[b][h][i], in order of b
__global__ void du_sum(const float* __restrict__ du_part,
                       float* __restrict__ du, int B, int HD) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= HD) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[static_cast<int64_t>(b) * HD +
                                             idx];
  du[idx] = acc;
}

template <typename T, int D>
int launch_typed(const void* r, const void* k, const void* v, const float* w,
                 const float* u, const float* ckpt, const float* dy,
                 const float* ds_fin, float* dr, float* dk, float* dv,
                 float* dw, float* du, float* du_part, int B, int S, int H,
                 cudaStream_t stream) {
  wkv_bwd<T, D><<<B * H, 4 * D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, ckpt, dy, ds_fin, dr, dk, dv, dw,
      du_part, S, H);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  du_sum<<<(H * D + 127) / 128, 128, 0, stream>>>(du_part, du, B, H * D);
  return cudaGetLastError();
}

template <int D>
int launch_d(int bf16, const void* r, const void* k, const void* v,
             const float* w, const float* u, const float* ckpt,
             const float* dy, const float* ds_fin, float* dr, float* dk,
             float* dv, float* dw, float* du, float* du_part, int B, int S,
             int H, cudaStream_t stream) {
  if (bf16)
    return launch_typed<__nv_bfloat16, D>(r, k, v, w, u, ckpt, dy, ds_fin,
                                          dr, dk, dv, dw, du, du_part, B, S,
                                          H, stream);
  return launch_typed<float, D>(r, k, v, w, u, ckpt, dy, ds_fin, dr, dk, dv,
                                dw, du, du_part, B, S, H, stream);
}

}  // namespace

REPRO_ERROR_STRING(rwkv_wkv_bwd)

// du_part: (B, H, d) fp32 scratch for the per-batch sums of du
extern "C" int rwkv_wkv_bwd_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* ckpt, const float* dy, const float* ds_fin,
    float* dr, float* dk, float* dv, float* dw, float* du, float* du_part,
    int B, int S, int H, int d, int bf16, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch_d<16>(bf16, r, k, v, w, u, ckpt, dy, ds_fin, dr, dk, dv,
                          dw, du, du_part, B, S, H, stream);
    case 32:
      return launch_d<32>(bf16, r, k, v, w, u, ckpt, dy, ds_fin, dr, dk, dv,
                          dw, du, du_part, B, S, H, stream);
    case 64:
      return launch_d<64>(bf16, r, k, v, w, u, ckpt, dy, ds_fin, dr, dk, dv,
                          dw, du, du_part, B, S, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
