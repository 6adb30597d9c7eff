// The backward of flash_attention.cu, in the JAX layout: q, dout and out
// (B, S, H, d), k and v (B, S, KV, d), one dtype (bf16 or fp32), and the
// forward's log-sum-exp lse (B, H, S) fp32 -> dq (B, S, H, d), dk and dv
// (B, S, KV, d), fp32. d in {32, 64, 128}; the masks and the soft cap of the
// forward; GQA's shared KV heads read and written in place.
//
// Replaces: none. The Pallas kernel (src/repro/kernels/flash_attention.py:85)
// has no backward: the JAX trainer differentiates flash_attention_jax
// (models/layers.py:149), whose chunked online softmax XLA's autodiff
// follows. This kernel gives the port's autograd.Function its backward.
//
// What it computes (FlashAttention-2's backward, all in fp32): with the
// scaled score s = q.k / sqrt(d), under a soft cap c first s <- c tanh(s/c),
// P = exp(s - lse) on the pairs the mask keeps (0 elsewhere), D = rowsum
// (dout * out), dP = dout . v, dS = P (dP - D), under a soft cap times
// 1 - tanh^2; then dq = dS . k / sqrt(d), dk = dS^T . q / sqrt(d) and
// dv = P^T . dout, dk and dv summed over the H / KV query heads of their KV
// head.
//
// What bounds it: operations. Per (query, key) pair the mask keeps it does
// five products of d (S, dP, dV, dK, dQ), 2.5x the forward's two: at the LM
// serve shapes (B 4, S 2048, H 32, KV 4, d 128, causal) ~344 GFLOP, 0.35 ms
// at the bf16 tensor-core peak and 5.1 ms at the fp32 CUDA-core peak. This
// first version recomputes S and dP in the dQ pass (seven products) and runs
// them all as fp32 FMAs on the CUDA cores for both dtypes; a tensor-core
// (wgmma) version is later work.
//
// Design, three launches, no atomics (every output element is written once,
// by one thread, its sums in a fixed order, so repeated runs agree bit for
// bit):
// - dot_rows: D, one warp per (b, s, h) row;
// - dkdv: one block per (b, KV head, 64-key tile), heaviest tile first. K
//   and V of the tile stay in shared memory (fp32); the block walks the KV
//   head's query heads and, for each, the 64-query tiles the mask reaches,
//   staging each tile's q, dout, lse and D. 256 threads as a 16 x 16 grid:
//   thread (ty, tx) scores queries 4ty .. 4ty + 3 against keys tx + 16j
//   (S and dP, float4 reads), writes P and dS to shared memory, then adds
//   P^T . dout and dS^T . q into its keys 4ty .. 4ty + 3, dims tx + 16e;
// - dq: one block per (b, head, 64-query tile), heaviest first, q and dout
//   staged once; the same scores over the key tiles the mask reaches, then
//   dS . k into its queries 4ty .. 4ty + 3, dims tx + 16e.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;          // queries a tile
constexpr int BK = 64;          // keys a tile
constexpr int NT = 256;         // threads a block: a 16 x 16 grid
constexpr int PLD = BK + 4;     // row stride (floats) of the P and dS tiles

template <int HD>
__host__ __device__ constexpr int ld() { return HD + 4; }

__device__ __forceinline__ bool live(int qp, int kp, int S, int causal,
                                     int window) {
  bool ok = qp < S && kp < S;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

// rows r0 .. r0 + ROWS - 1 of one head (src at row 0 of that head, rows
// row_stride elements apart) into the fp32 tile dst (row stride LD);
// rows >= S read as zeros
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const T* __restrict__ src,
                                          int64_t row_stride, int r0, int S) {
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD;
    dst[r * ld<HD>() + c] =
        r0 + r < S ? to_f(src[static_cast<int64_t>(r0 + r) * row_stride + c])
                   : 0.f;
  }
}

// lse and D of query rows q0 .. q0 + BQ - 1 of head h (zeros past S)
__device__ __forceinline__ void load_row_stats(float* lse_s, float* dv_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ dvec,
                                               int64_t bh, int q0, int S) {
  for (int i = threadIdx.x; i < BQ; i += NT) {
    const bool in = q0 + i < S;
    lse_s[i] = in ? lse[bh * S + q0 + i] : 0.f;
    dv_s[i] = in ? dvec[bh * S + q0 + i] : 0.f;
  }
}

// This thread's S and dP: queries 4ty + a against keys tx + 16j of the tiles
template <int HD>
__device__ __forceinline__ void products(const float* Qs, const float* Os,
                                         const float* Ks, const float* Vs,
                                         float (&s)[4][4], float (&dp)[4][4]) {
  constexpr int L = ld<HD>();
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[a][j] = dp[a][j] = 0.f;
#pragma unroll 2
  for (int dd = 0; dd < HD; dd += 4) {
    float4 qa[4], oa[4], kj[4], vj[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = *reinterpret_cast<const float4*>(Qs + (4 * ty + a) * L + dd);
      oa[a] = *reinterpret_cast<const float4*>(Os + (4 * ty + a) * L + dd);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kj[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L + dd);
      vj[j] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * j) * L + dd);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[a][j] = fmaf(qa[a].x, kj[j].x, s[a][j]);
        s[a][j] = fmaf(qa[a].y, kj[j].y, s[a][j]);
        s[a][j] = fmaf(qa[a].z, kj[j].z, s[a][j]);
        s[a][j] = fmaf(qa[a].w, kj[j].w, s[a][j]);
        dp[a][j] = fmaf(oa[a].x, vj[j].x, dp[a][j]);
        dp[a][j] = fmaf(oa[a].y, vj[j].y, dp[a][j]);
        dp[a][j] = fmaf(oa[a].z, vj[j].z, dp[a][j]);
        dp[a][j] = fmaf(oa[a].w, vj[j].w, dp[a][j]);
      }
  }
}

// P and dS of this thread's pairs into the (BQ, PLD) tiles (P only with
// kP): queries q0 + 4ty + a, keys k0 + tx + 16j
template <bool kP>
__device__ __forceinline__ void probs(const float (&s)[4][4],
                                      const float (&dp)[4][4],
                                      const float* lse_s, const float* dv_s,
                                      int q0, int k0, int S, int causal,
                                      int window, float softcap, float scale,
                                      float* Ps, float* dSs) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = 4 * ty + a;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float x = s[a][j] * scale, th = 0.f;
      if (softcap > 0.f) {
        th = tanhf(x / softcap);
        x = th * softcap;
      }
      const float p = live(q0 + i, k0 + c, S, causal, window)
                          ? expf(x - lse_s[i]) : 0.f;
      float ds = p * (dp[a][j] - dv_s[i]);
      if (softcap > 0.f) ds *= 1.f - th * th;
      if constexpr (kP) Ps[i * PLD + c] = p;
      dSs[i * PLD + c] = ds;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
dot_rows(const T* __restrict__ o, const T* __restrict__ dout,
         float* __restrict__ dvec, int S, int H, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (NT / 32) +
                      threadIdx.x / 32;
  if (row >= rows) return;                       // warp-uniform
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32)
    acc = fmaf(to_f(o[row * HD + c]), to_f(dout[row * HD + c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const int64_t bs = row / H;                  // b * S + s
    dvec[((bs / S) * H + h) * S + bs % S] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1)
dkdv(const T* __restrict__ q, const T* __restrict__ k,
     const T* __restrict__ v, const T* __restrict__ dout,
     const float* __restrict__ lse, const float* __restrict__ dvec,
     float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KV,
     int causal, int window, float softcap, float scale) {
  constexpr int L = ld<HD>(), DPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // BK x L
  float* Vs = Ks + BK * L;          // BK x L
  float* Qs = Vs + BK * L;          // BQ x L
  float* Os = Qs + BQ * L;          // BQ x L: dout
  float* Ps = Os + BQ * L;          // BQ x PLD
  float* dSs = Ps + BQ * PLD;       // BQ x PLD
  float* lse_s = dSs + BQ * PLD;    // BQ
  float* dv_s = lse_s + BQ;         // BQ

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qrow = static_cast<int64_t>(H) * HD;
  const int64_t krow = static_cast<int64_t>(KV) * HD;
  load_rows<T, HD, BK>(Ks, k + (static_cast<int64_t>(b) * S * KV + kvh) * HD,
                       krow, k0, S);
  load_rows<T, HD, BK>(Vs, v + (static_cast<int64_t>(b) * S * KV + kvh) * HD,
                       krow, k0, S);
  float acc_k[4][DPT], acc_v[4][DPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc_k[a][e] = acc_v[a][e] = 0.f;

  // the query tiles with a pair the mask keeps
  const int q_first = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + BK - 1 + window) : S;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    const int64_t head = (static_cast<int64_t>(b) * S * H + h) * HD;
    for (int q0 = q_first / BQ * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();              // the last tile's reads are done
      load_rows<T, HD, BQ>(Qs, q + head, qrow, q0, S);
      load_rows<T, HD, BQ>(Os, dout + head, qrow, q0, S);
      load_row_stats(lse_s, dv_s, lse, dvec, bh, q0, S);
      __syncthreads();
      float s[4][4], dp[4][4];
      products<HD>(Qs, Os, Ks, Vs, s, dp);
      probs<true>(s, dp, lse_s, dv_s, q0, k0, S, causal, window, softcap,
                  scale, Ps, dSs);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + i * PLD +
                                                           4 * ty);
        const float4 d4 = *reinterpret_cast<const float4*>(dSs + i * PLD +
                                                           4 * ty);
        const float pa[4] = {p4.x, p4.y, p4.z, p4.w};
        const float da[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          const float o_ = Os[i * L + tx + 16 * e];
          const float q_ = Qs[i * L + tx + 16 * e];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc_v[a][e] = fmaf(pa[a], o_, acc_v[a][e]);
            acc_k[a][e] = fmaf(da[a], q_, acc_k[a][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kp = k0 + 4 * ty + a;
    if (kp >= S) continue;
    const int64_t off = (static_cast<int64_t>(b) * S + kp) * krow + kvh * HD;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      dk[off + tx + 16 * e] = acc_k[a][e] * scale;
      dv[off + tx + 16 * e] = acc_v[a][e];
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dvec,
          float* __restrict__ dq, int S, int H, int KV, int causal,
          int window, float softcap, float scale) {
  constexpr int L = ld<HD>(), DPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // BQ x L
  float* Os = Qs + BQ * L;          // BQ x L: dout
  float* Ks = Os + BQ * L;          // BK x L
  float* Vs = Ks + BK * L;          // BK x L
  float* dSs = Vs + BK * L;         // BQ x PLD
  float* lse_s = dSs + BQ * PLD;    // BQ
  float* dv_s = lse_s + BQ;         // BQ

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qrow = static_cast<int64_t>(H) * HD;
  const int64_t krow = static_cast<int64_t>(KV) * HD;
  const int64_t head = (static_cast<int64_t>(b) * S * H + h) * HD;
  load_rows<T, HD, BQ>(Qs, q + head, qrow, q0, S);
  load_rows<T, HD, BQ>(Os, dout + head, qrow, q0, S);
  load_row_stats(lse_s, dv_s, lse, dvec, static_cast<int64_t>(b) * H + h, q0,
                 S);
  float acc[4][DPT];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[a][e] = 0.f;

  // the key tiles with a pair the mask keeps
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const T* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  const T* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  for (int k0 = k_first / BK * BK; k0 < k_end; k0 += BK) {
    __syncthreads();                // the last tile's reads are done
    load_rows<T, HD, BK>(Ks, kb, krow, k0, S);
    load_rows<T, HD, BK>(Vs, vb, krow, k0, S);
    __syncthreads();
    float s[4][4], dp[4][4];
    products<HD>(Qs, Os, Ks, Vs, s, dp);
    probs<false>(s, dp, lse_s, dv_s, q0, k0, S, causal, window, softcap,
                 scale, nullptr, dSs);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float da[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float4 d4 = *reinterpret_cast<const float4*>(
            dSs + (4 * ty + a) * PLD + j);
        da[a][0] = d4.x;
        da[a][1] = d4.y;
        da[a][2] = d4.z;
        da[a][3] = d4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          const float k_ = Ks[(j + jj) * L + tx + 16 * e];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            acc[a][e] = fmaf(da[a][jj], k_, acc[a][e]);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qp = q0 + 4 * ty + a;
    if (qp >= S) continue;
    const int64_t off = (static_cast<int64_t>(b) * S + qp) * qrow + h * HD;
#pragma unroll
    for (int e = 0; e < DPT; ++e) dq[off + tx + 16 * e] = acc[a][e] * scale;
  }
}

template <int HD>
constexpr int dkdv_smem() {
  return 4 * (2 * BK * ld<HD>() + 2 * BQ * ld<HD>() + 2 * BQ * PLD + 2 * BQ);
}
template <int HD>
constexpr int dq_smem() {
  return 4 * (2 * BQ * ld<HD>() + 2 * BK * ld<HD>() + BQ * PLD + 2 * BQ);
}

template <typename T, int HD>
int launch_typed(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* dvec, float* dq,
                 float* dk, float* dv, int B, int S, int H, int KV,
                 int causal, int window, float softcap, float scale,
                 cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int64_t rows = static_cast<int64_t>(B) * S * H;
  dot_rows<T, HD><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)),
                    NT, 0, stream>>>(static_cast<const T*>(o), tdo, dvec, S,
                                     H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int s1 = dkdv_smem<HD>(), s2 = dq_smem<HD>();
  if ((err = cudaFuncSetAttribute(dkdv<T, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dq_kernel<T, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s2)) != cudaSuccess)
    return err;
  const dim3 g1((S + BK - 1) / BK, KV, B), g2((S + BQ - 1) / BQ, H, B);
  dkdv<T, HD><<<g1, NT, s1, stream>>>(tq, tk, tv, tdo, lse, dvec, dk, dv, S,
                                      H, KV, causal, window, softcap, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<T, HD><<<g2, NT, s2, stream>>>(tq, tk, tv, tdo, lse, dvec, dq, S,
                                           H, KV, causal, window, softcap,
                                           scale);
  return cudaGetLastError();
}

template <int HD>
int launch_hd(int bf16, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* dvec,
              float* dq, float* dk, float* dv, int B, int S, int H, int KV,
              int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  if (bf16)
    return launch_typed<__nv_bfloat16, HD>(q, k, v, o, dout, lse, dvec, dq,
                                           dk, dv, B, S, H, KV, causal,
                                           window, softcap, scale, stream);
  return launch_typed<float, HD>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B,
                                 S, H, KV, causal, window, softcap, scale,
                                 stream);
}

}  // namespace

REPRO_ERROR_STRING(flash_attention_bwd)

// dvec: (B, H, S) fp32 scratch for D; dq, dk, dv: fp32 outputs
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dvec, float* dq, float* dk,
    float* dv, int B, int S, int H, int KV, int d, int bf16, int causal,
    int window, float softcap, float scale, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  switch (d) {
    case 32:
      return launch_hd<32>(bf16, q, k, v, o, dout, lse, dvec, dq, dk, dv, B,
                           S, H, KV, causal, window, softcap, scale, stream);
    case 64:
      return launch_hd<64>(bf16, q, k, v, o, dout, lse, dvec, dq, dk, dv, B,
                           S, H, KV, causal, window, softcap, scale, stream);
    case 128:
      return launch_hd<128>(bf16, q, k, v, o, dout, lse, dvec, dq, dk, dv, B,
                            S, H, KV, causal, window, softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
