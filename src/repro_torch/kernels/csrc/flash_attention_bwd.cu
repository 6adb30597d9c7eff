// The backward of flash_attention.cu, in the JAX layout: q, dout and out
// (B, S, H, d), k and v (B, S, KV, d), one dtype (bf16 or fp32), and the
// forward's log-sum-exp lse (B, H, S) fp32 -> dq (B, S, H, d), dk and dv
// (B, S, KV, d), fp32. d in {32, 64, 112, 128}; the masks and the soft cap
// of the forward; GQA's shared KV heads read and written in place.
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
// What bounds it: operations. Per (query, key) pair the mask keeps the
// function needs five products of d (S, dP, dV, dK, dQ), 2.5x the
// forward's two: at the LM serve shapes (B 4, S 2048, H 32, KV 4, d 128,
// causal) ~344 GFLOP, 0.35 ms at the bf16 tensor-core peak and 5.1 ms at
// the fp32 CUDA-core peak.
//
// No float atomics in either instance: every output element is written
// once, its sums taken in a fixed order, so repeated runs agree bit for
// bit. Both first launch dot_rows, D for each (b, s, h) row (one warp a
// row); the bf16 instance's also copies lse beside it, both in rows of SP
// (S rounded up to 128) entries whose padding holds zeros, so that TMA can
// fetch a tile's 64 entries of each as one 256-byte copy.
//
// bf16 (the training path), on the tensor cores: every product is a wgmma
// (wgmma.cuh) on bf16 tiles that TMA streams into shared memory, in two
// kernels of three warpgroups (two consumers of 64 rows each, and a
// producer warpgroup whose one thread issues the copies and gives its
// registers to the consumers by setmaxnreg), as the forward's kernel:
// - dkdv_wg: a block per (b, KV head, 128 keys, group of query heads),
//   heaviest causal tile first; its K and V tiles stay in shared memory,
//   and the producer streams, through a ring of RING stages with full and
//   empty mbarriers, the Q and dout tiles (64 queries) of every query head
//   of its group and every query tile the mask reaches, with their lse and
//   D. The wrapper splits each KV head's H / KV query heads into the
//   fewest groups P that give the card two blocks an SM (at yi-6b's
//   training shape, B 2, 128 blocks of all 8 heads would leave the card
//   waiting on the first key tiles, which carry the most causal work);
//   with P > 1 each group's block writes its partial dK and dV to a plane
//   of its own and sum_planes adds the planes in the groups' order. A
//   consumer owns 64 keys: S^T = K.Q^T and dP^T = V.dout^T (keys as M,
//   both operands K-major in shared memory), then P^T and dS^T in
//   registers, in the accumulator layout, which is the A operand's, then
//   dV += P^T.dout and dK += dS^T.Q with dout and Q read MN-major (the
//   transpose bit). A tile the mask leaves empty for a consumer's keys is
//   skipped; only the tiles that cross the causal diagonal, the window's
//   edge or S test each pair.
// - dq_wg: a block per (b, head, 128 queries), heaviest first; Q and dout
//   stay, the producer streams the K and V tiles (64 keys) the mask
//   reaches; a consumer owns 64 queries: S = Q.K^T, dP = dout.V^T, dS in
//   registers, dQ += dS.K with K read MN-major.
// P and dS rounded once to bf16 would miss the bound the kernel is held
// to against the plain backward (1e-4 plus 1e-4 of the gradient's largest
// entry: a bf16 rounding is 2^-9 of the value, and the largest dV entries
// come from keys few queries share, where P is near 1). So, as the
// forward does for P.V, each of dV, dK and dQ runs on bf16 hi and lo parts
// of P or dS (lo = x - hi, rounded: ~2^-17 of x), two wgmmas back to back
// on one accumulator: ten products of d a kept pair against the bound's
// five, a floor of ~0.70 ms at the serve shapes (B 4) and ~0.35 ms at
// yi-6b's training shape (B 2). S and dP take the bf16 inputs as they are;
// their products are exact in fp32.
//
// d 112 (kimi-k2's heads) takes the forward's tiles (flash_attention.cu):
// 128 wide, two column blocks whose second box starts at h * 112 + 64 and
// reads 16 columns past the head (the next head's, or TMA's zero fill past
// the last). Four products contract over d: S = Q.K^T and dP = dout.V^T
// in dq_wg, S^T = K.Q^T and dP^T = V.dout^T in dkdv_wg. Each runs d / 16
// = 7 k-steps (two_products), never an 8th, which would add the next
// head's columns into the scores. The three products whose N is d (dV +=
// P^T.dout, dK += dS^T.Q, dQ += dS.K) run at N 128: columns 112-127 of
// their accumulators take the next head's values and are never stored.
// dot_rows reads exactly d. The tensor work of those three is 128/112 of
// the head's; the loads of the streamed tiles 8/7.
//
// fp32, on the CUDA cores (dkdv and dq_kernel, three launches with
// dot_rows): fp32 FMAs, the same tiles and order as above at 64 keys or
// queries a block of 256 threads as a 16 x 16 grid: thread (ty, tx) scores
// queries 4ty .. 4ty + 3 against keys tx + 16j (S and dP, float4 reads),
// writes P and dS to shared memory, then adds P^T . dout and dS^T . q into
// its keys 4ty .. 4ty + 3, dims tx + 16e (dkdv), or dS . k into its queries
// (dq_kernel). S and dP are computed in both kernels (seven products).
// d 112 as it is: 28 float4 reads a row, 7 dims a thread (e < d / 16).
#include "common.cuh"
#include "wgmma.cuh"

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

// D of each (b, s, h) row into dvec (B, H, SP) and, with lse_pad, that
// row's lse (B, H, S) beside it in lse_pad (B, H, SP)
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
dot_rows(const T* __restrict__ o, const T* __restrict__ dout,
         const float* __restrict__ lse, float* __restrict__ dvec,
         float* __restrict__ lse_pad, int S, int SP, int H, int64_t rows) {
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
    const int64_t bh = (bs / S) * H + h;
    dvec[bh * SP + bs % S] = acc;
    if (lse_pad != nullptr) lse_pad[bh * SP + bs % S] = lse[bh * S + bs % S];
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

// fp32: dot_rows, dkdv, dq_kernel
template <int HD>
int launch_fp32(const float* q, const float* k, const float* v,
                const float* o, const float* dout, const float* lse,
                float* dvec, float* dq, float* dk, float* dv, int B, int S,
                int H, int KV, int causal, int window, float softcap,
                float scale, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * S * H;
  dot_rows<float, HD><<<static_cast<unsigned>((rows + NT / 32 - 1) /
                                              (NT / 32)),
                        NT, 0, stream>>>(o, dout, lse, dvec, nullptr, S, S,
                                         H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int s1 = dkdv_smem<HD>(), s2 = dq_smem<HD>();
  if ((err = cudaFuncSetAttribute(dkdv<float, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dq_kernel<float, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s2)) != cudaSuccess)
    return err;
  const dim3 g1((S + BK - 1) / BK, KV, B), g2((S + BQ - 1) / BQ, H, B);
  dkdv<float, HD><<<g1, NT, s1, stream>>>(q, k, v, dout, lse, dvec, dk, dv,
                                          S, H, KV, causal, window, softcap,
                                          scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<float, HD><<<g2, NT, s2, stream>>>(q, k, v, dout, lse, dvec, dq,
                                               S, H, KV, causal, window,
                                               softcap, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;       // keys (dK/dV) or queries (dQ) a consumer
constexpr int BT = 2 * WG_ROWS;   // keys or queries a block owns
constexpr int ST = 64;            // queries (dK/dV) or keys (dQ) a streamed tile
constexpr int RING = 3;           // stages of the ring
constexpr int WG_THREADS = 384;   // consumer warpgroups 0, 1; producer 2
constexpr float LOG2E = 1.4426950408889634f;

// bytes of a tile of `rows` rows, tile_dim<HD>() (whole column blocks) wide
template <int HD>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * tile_dim<HD>() * 2;
}
template <int HD>
constexpr size_t dkdv_wg_smem() {   // + 1024 to align the tiles
  return 1024 + 2 * tile_bytes<HD>(BT) + RING * 2 * tile_bytes<HD>(ST) +
         RING * 2 * ST * sizeof(float);
}
template <int HD>
constexpr size_t dq_wg_smem() {
  return 1024 + 2 * tile_bytes<HD>(BT) + RING * 2 * tile_bytes<HD>(ST);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void init_ring(uint64_t* once, uint64_t* full,
                                          uint64_t* empty) {
  if (threadIdx.x == 0) {
    mbar_init(once, 1);
    for (int st = 0; st < RING; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);      // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// one tile of `rows` rows of a head from a (d * heads, S, B) map, all of
// its column blocks, completing on `bar`
template <int HD>
__device__ __forceinline__ void load_head_tile(uint8_t* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int rows,
                                               int head, int r0, int b) {
#pragma unroll
  for (int cb = 0; cb < col_blocks<HD>(); ++cb)
    tma_load_3d(dst + cb * rows * swz_bytes<HD>(), map, bar,
                head * HD + cb * swz_elems<HD>(), r0, b);
}

// S^T (or S) and dP^T (or dP) of one 64 x 64 tile, both K-major operand
// pairs in shared memory: s = A1 . B1^T, dp = A2 . B2^T over d
template <int HD>
__device__ __forceinline__ void two_products(float (&s)[32], float (&dp)[32],
                                             uint32_t a1, uint32_t a2,
                                             int a_rows, int a_row0,
                                             uint32_t b1, uint32_t b2) {
  // d / 16 k-steps: at d 112 seven, which never reach the columns past
  // the head that a tile's second column block holds
  constexpr int KSTEPS = HD / 16;
  // no fence on s and dp first: their first steps do not read them, so
  // their registers may hold other values until here
  wgmma_fence();
  wgmma_ss_n64_first(s, kmajor_desc<HD>(a1, a_rows, a_row0, 0),
                     kmajor_desc<HD>(b1, ST, 0, 0));
#pragma unroll
  for (int kk = 1; kk < KSTEPS; ++kk)
    wgmma_ss_n64(s, kmajor_desc<HD>(a1, a_rows, a_row0, kk),
                 kmajor_desc<HD>(b1, ST, 0, kk), 1);
  wgmma_ss_n64_first(dp, kmajor_desc<HD>(a2, a_rows, a_row0, 0),
                     kmajor_desc<HD>(b2, ST, 0, 0));
#pragma unroll
  for (int kk = 1; kk < KSTEPS; ++kk)
    wgmma_ss_n64(dp, kmajor_desc<HD>(a2, a_rows, a_row0, kk),
                 kmajor_desc<HD>(b2, ST, 0, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
}

// acc += X . T over the tile's 64 rows, X (64 x 64) in registers as bf16
// hi and lo parts, T a tile of ST rows read MN-major (N = tile_dim: d,
// or 128 at d 112)
template <int HD>
__device__ __forceinline__ void add_product(float (&acc)[tile_dim<HD>() / 2],
                                            const uint32_t (&hi)[ST / 16][4],
                                            const uint32_t (&lo)[ST / 16][4],
                                            uint32_t tile) {
  constexpr int TD = tile_dim<HD>();
#pragma unroll
  for (int kk = 0; kk < ST / 16; ++kk) {
    const uint64_t db = mnmajor_desc<HD>(tile, ST, kk);
    wgmma_rs_d<TD>(acc, hi[kk], db);
    wgmma_rs_d<TD>(acc, lo[kk], db);
  }
}

// One pair's P and dS from its scaled score s (times `scale` here), dP,
// -lse in log2 units and D
__device__ __forceinline__ void pair_grad(float& s, float& dp, float nl,
                                          float d, float scale,
                                          float softcap, bool keep) {
  float x = s * scale, th = 0.f;
  if (softcap > 0.f) {
    th = tanhf(x / softcap);
    x = th * softcap;
  }
  const float p = ex2(fmaf(x, LOG2E, nl));
  float ds = p * (dp - d);
  if (softcap > 0.f) ds *= 1.f - th * th;
  s = keep ? p : 0.f;
  dp = keep ? ds : 0.f;
}

// dK and dV of 128 keys of one KV head: see the header
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
dkdv_wg(const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const float* __restrict__ lse_pad, const float* __restrict__ dvec,
        float* __restrict__ dk, float* __restrict__ dv, int B, int S, int SP,
        int H, int KV, int P, int causal, int window, float softcap,
        float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t kv_full, q_full[RING], q_empty[RING];
  uint8_t* const smem = align_1024(smem_raw);
  uint8_t* const Ks = smem;
  uint8_t* const Vs = Ks + tile_bytes<HD>(BT);
  auto Qs = [&](int st) {
    return smem + 2 * tile_bytes<HD>(BT) + st * 2 * tile_bytes<HD>(ST);
  };
  auto Os = [&](int st) { return Qs(st) + tile_bytes<HD>(ST); };
  float* const stats = reinterpret_cast<float*>(
      smem + 2 * tile_bytes<HD>(BT) + RING * 2 * tile_bytes<HD>(ST));
  auto lse_s = [&](int st) { return stats + st * 2 * ST; };
  auto d_s = [&](int st) { return stats + st * 2 * ST + ST; };

  // heaviest first: the causal key tiles from the start of the sequence
  // and the heads of the KV head in P groups (dk and dv then point at
  // group p's plane of partial sums)
  const int p = blockIdx.x % P, w = blockIdx.x / P;
  const int k0 = (w / (KV * B)) * BT, kvh = w % KV, b = (w / KV) % B;
  const int GP = H / KV / P, g0 = p * GP;
  // the query tiles with a pair the mask keeps
  const int q_first = causal ? k0 : 0;
  const int q_end = window > 0 ? min(S, k0 + BT - 1 + window) : S;
  const int n_qt = (q_end - q_first + ST - 1) / ST;
  init_ring(&kv_full, q_full, q_empty);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ---------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(&kv_full, 2 * tile_bytes<HD>(BT));
      load_head_tile<HD>(Ks, &tm_k, &kv_full, BT, kvh, k0, b);
      load_head_tile<HD>(Vs, &tm_v, &kv_full, BT, kvh, k0, b);
      int T = 0;
      for (int g = g0; g < g0 + GP; ++g) {
        const int h = kvh * (H / KV) + g;
        const int64_t row = (static_cast<int64_t>(b) * H + h) * SP;
        for (int i = 0; i < n_qt; ++i, ++T) {
          const int st = T % RING, q0 = q_first + i * ST;
          mbar_wait(&q_empty[st], ((T / RING) & 1) ^ 1);
          mbar_expect_tx(&q_full[st], 2 * tile_bytes<HD>(ST) +
                                          2 * ST * sizeof(float));
          load_head_tile<HD>(Qs(st), &tm_q, &q_full[st], ST, h, q0, b);
          load_head_tile<HD>(Os(st), &tm_do, &q_full[st], ST, h, q0, b);
          bulk_load_1d(lse_s(st), lse_pad + row + q0, ST * sizeof(float),
                       &q_full[st]);
          bulk_load_1d(d_s(st), dvec + row + q0, ST * sizeof(float),
                       &q_full[st]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys kb .. kb + 63 --------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int tig = lane & 3;
    const int kb = k0 + WG_ROWS * wg;
    const int kr0 = kb + 16 * warp + (lane >> 2);   // this thread's keys:
                                                    // kr0 and kr0 + 8
    // dka and dva hold tile_dim columns; those past HD (d 112) are never
    // stored
    float dka[tile_dim<HD>() / 2], dva[tile_dim<HD>() / 2], s[32], dp[32];
    uint32_t phi[ST / 16][4], plo[ST / 16][4], dhi[ST / 16][4],
        dlo[ST / 16][4];
#pragma unroll
    for (int j = 0; j < tile_dim<HD>() / 2; ++j) dka[j] = dva[j] = 0.f;
    const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
    mbar_wait(&kv_full, 0);
    int T = 0;
    for (int g = g0; g < g0 + GP; ++g) {
      for (int i = 0; i < n_qt; ++i, ++T) {
        const int st = T % RING, q0 = q_first + i * ST;
        mbar_wait(&q_full[st], (T / RING) & 1);
        // a tile whose pairs the mask all drops for these keys
        const bool skip = kb >= S || (causal && q0 + ST - 1 < kb) ||
                          (window > 0 && q0 - (kb + WG_ROWS - 1) >= window);
        if (!skip) {
          const uint32_t q_addr = smem_u32(Qs(st)), o_addr = smem_u32(Os(st));
          two_products<HD>(s, dp, k_addr, v_addr, BT, WG_ROWS * wg, q_addr,
                           o_addr);
          const bool mask =
              (causal && q0 < kb + WG_ROWS - 1) ||
              (window > 0 && q0 + ST - 1 - kb >= window) || q0 + ST > S ||
              kb + WG_ROWS > S;
          const float* ls = lse_s(st);
          const float* ds = d_s(st);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int qi = 8 * (j >> 2) + 2 * tig + (j & 1);
            const bool keep =
                !mask || live(q0 + qi, kr0 + 8 * ((j >> 1) & 1), S, causal,
                              window);
            pair_grad(s[j], dp[j], -ls[qi] * LOG2E, ds[qi], scale, softcap,
                      keep);
          }
          to_operand<ST>(s, phi, plo);
          to_operand<ST>(dp, dhi, dlo);
          fence_regs(dva);
          fence_regs(dka);
          wgmma_fence();
          add_product<HD>(dva, phi, plo, o_addr);
          add_product<HD>(dka, dhi, dlo, q_addr);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dva);
          fence_regs(dka);
        }
        if (lane == 0) mbar_arrive(&q_empty[st]);
      }
    }
    const int64_t krow = static_cast<int64_t>(KV) * HD;
    const int64_t plane = static_cast<int64_t>(p) * B * S * krow;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = kr0 + 8 * r;
      if (kp >= S) continue;
      const int64_t off = plane + (static_cast<int64_t>(b) * S + kp) * krow +
                          kvh * HD + 2 * tig;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        *reinterpret_cast<float2*>(dk + off + 8 * i) = make_float2(
            dka[4 * i + 2 * r] * scale, dka[4 * i + 2 * r + 1] * scale);
        *reinterpret_cast<float2*>(dv + off + 8 * i) =
            make_float2(dva[4 * i + 2 * r], dva[4 * i + 2 * r + 1]);
      }
    }
  }
}

// dQ of 128 queries of one head: see the header
template <int HD>
__global__ void __launch_bounds__(WG_THREADS, 1)
dq_wg(const __grid_constant__ CUtensorMap tm_q,
      const __grid_constant__ CUtensorMap tm_do,
      const __grid_constant__ CUtensorMap tm_k,
      const __grid_constant__ CUtensorMap tm_v,
      const float* __restrict__ lse_pad, const float* __restrict__ dvec,
      float* __restrict__ dq, int B, int S, int SP, int H, int KV,
      int causal, int window, float softcap, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full, kv_full[RING], kv_empty[RING];
  uint8_t* const smem = align_1024(smem_raw);
  uint8_t* const Qs = smem;
  uint8_t* const Os = Qs + tile_bytes<HD>(BT);
  auto Ks = [&](int st) {
    return smem + 2 * tile_bytes<HD>(BT) + st * 2 * tile_bytes<HD>(ST);
  };
  auto Vs = [&](int st) { return Ks(st) + tile_bytes<HD>(ST); };

  // heaviest first: the causal query tiles from the end of the sequence
  const int w = blockIdx.x;
  const int n_qt = (S + BT - 1) / BT;
  const int q0 = (n_qt - 1 - w / (H * B)) * BT, h = w % H,
            b = (w / H) % B;
  const int kvh = h / (H / KV);
  // the key tiles with a pair the mask keeps
  const int k_first =
      window > 0 ? max(0, q0 - window + 1) / ST * ST : 0;
  const int k_end = causal ? min(S, q0 + BT) : S;
  const int n_kt = (k_end - k_first + ST - 1) / ST;
  init_ring(&q_full, kv_full, kv_empty);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(&q_full, 2 * tile_bytes<HD>(BT));
      load_head_tile<HD>(Qs, &tm_q, &q_full, BT, h, q0, b);
      load_head_tile<HD>(Os, &tm_do, &q_full, BT, h, q0, b);
      for (int i = 0; i < n_kt; ++i) {
        const int st = i % RING, k0 = k_first + i * ST;
        mbar_wait(&kv_empty[st], ((i / RING) & 1) ^ 1);
        mbar_expect_tx(&kv_full[st], 2 * tile_bytes<HD>(ST));
        load_head_tile<HD>(Ks(st), &tm_k, &kv_full[st], ST, kvh, k0, b);
        load_head_tile<HD>(Vs(st), &tm_v, &kv_full[st], ST, kvh, k0, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int tig = lane & 3;
    const int qb = q0 + WG_ROWS * wg;
    const int qr0 = qb + 16 * warp + (lane >> 2);   // this thread's
                                                    // queries: qr0, + 8
    float nl[2], dd[2];
    const int64_t row = (static_cast<int64_t>(b) * H + h) * SP;
#pragma unroll
    for (int r = 0; r < 2; ++r) {      // SP >= n_qt * BT: in the padding
      nl[r] = -lse_pad[row + qr0 + 8 * r] * LOG2E;
      dd[r] = dvec[row + qr0 + 8 * r];
    }
    float dqa[tile_dim<HD>() / 2], s[32], dp[32];
    uint32_t dhi[ST / 16][4], dlo[ST / 16][4];
#pragma unroll
    for (int j = 0; j < tile_dim<HD>() / 2; ++j) dqa[j] = 0.f;
    const uint32_t q_addr = smem_u32(Qs), o_addr = smem_u32(Os);
    mbar_wait(&q_full, 0);
    for (int i = 0; i < n_kt; ++i) {
      const int st = i % RING, k0 = k_first + i * ST;
      mbar_wait(&kv_full[st], (i / RING) & 1);
      const bool skip = qb >= S || (causal && k0 > qb + WG_ROWS - 1) ||
                        (window > 0 && qb - (k0 + ST - 1) >= window);
      if (!skip) {
        const uint32_t k_addr = smem_u32(Ks(st)), v_addr = smem_u32(Vs(st));
        two_products<HD>(s, dp, q_addr, o_addr, BT, WG_ROWS * wg, k_addr,
                         v_addr);
        const bool mask = (causal && qb < k0 + ST - 1) ||
                          (window > 0 && qb + WG_ROWS - 1 - k0 >= window) ||
                          k0 + ST > S || qb + WG_ROWS > S;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int r = (j >> 1) & 1;
          const bool keep =
              !mask || live(qr0 + 8 * r, k0 + 8 * (j >> 2) + 2 * tig + (j & 1),
                            S, causal, window);
          pair_grad(s[j], dp[j], nl[r], dd[r], scale, softcap, keep);
        }
        to_operand<ST>(dp, dhi, dlo);
        fence_regs(dqa);
        wgmma_fence();
        add_product<HD>(dqa, dhi, dlo, k_addr);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
      }
      if (lane == 0) mbar_arrive(&kv_empty[st]);
    }
    const int64_t qrow = static_cast<int64_t>(H) * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = qr0 + 8 * r;
      if (qp >= S) continue;
      float* out = dq + (static_cast<int64_t>(b) * S + qp) * qrow + h * HD +
                   2 * tig;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i)
        *reinterpret_cast<float2*>(out + 8 * i) = make_float2(
            dqa[4 * i + 2 * r] * scale, dqa[4 * i + 2 * r + 1] * scale);
    }
  }
}

// out[i] = sum over p of part[p][i], p in order (the head groups' partial
// dK or dV), four entries a thread
__global__ void __launch_bounds__(NT)
sum_planes(const float* __restrict__ part, int P, int64_t n4,
           float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= n4) return;
  const float4* src = reinterpret_cast<const float4*>(part);
  float4 acc = src[i];
  for (int p = 1; p < P; ++p) {
    const float4 x = src[p * n4 + i];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  reinterpret_cast<float4*>(out)[i] = acc;
}

// bf16: dot_rows (D, and lse copied beside it), dkdv_wg (then sum_planes
// where the heads are split), dq_wg
template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* dvec,
                float* lse_pad, float* dq, float* dk, float* dv,
                float* part, int B, int S, int SP, int H, int KV, int P,
                int causal, int window, float softcap, float scale,
                cudaStream_t stream) {
  using T = __nv_bfloat16;
  const int64_t rows = static_cast<int64_t>(B) * S * H;
  dot_rows<T, HD><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)),
                    NT, 0, stream>>>(static_cast<const T*>(o),
                                     static_cast<const T*>(dout), lse, dvec,
                                     lse_pad, S, SP, H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mdo, mk, mv;
  // dK/dV: Q and dout tiles of ST rows, K and V of BT
  if ((err = head_map<HD>(&mq, q, B, S, H, ST)) != cudaSuccess ||
      (err = head_map<HD>(&mdo, dout, B, S, H, ST)) != cudaSuccess ||
      (err = head_map<HD>(&mk, k, B, S, KV, BT)) != cudaSuccess ||
      (err = head_map<HD>(&mv, v, B, S, KV, BT)) != cudaSuccess)
    return err;
  constexpr size_t s1 = dkdv_wg_smem<HD>(), s2 = dq_wg_smem<HD>();
  if ((err = cudaFuncSetAttribute(dkdv_wg<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s1))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dq_wg<HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(s2))) != cudaSuccess)
    return err;
  const int tiles = (S + BT - 1) / BT;
  const int64_t plane = static_cast<int64_t>(B) * S * KV * HD;
  dkdv_wg<HD><<<static_cast<unsigned>(tiles * KV * B * P), WG_THREADS, s1,
                stream>>>(mq, mdo, mk, mv, lse_pad, dvec,
                          P > 1 ? part : dk, P > 1 ? part + P * plane : dv,
                          B, S, SP, H, KV, P, causal, window, softcap,
                          scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (P > 1) {
    const unsigned nb = static_cast<unsigned>((plane / 4 + NT - 1) / NT);
    sum_planes<<<nb, NT, 0, stream>>>(part, P, plane / 4, dk);
    sum_planes<<<nb, NT, 0, stream>>>(part + P * plane, P, plane / 4, dv);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // dQ: Q and dout tiles of BT rows, K and V of ST
  if ((err = head_map<HD>(&mq, q, B, S, H, BT)) != cudaSuccess ||
      (err = head_map<HD>(&mdo, dout, B, S, H, BT)) != cudaSuccess ||
      (err = head_map<HD>(&mk, k, B, S, KV, ST)) != cudaSuccess ||
      (err = head_map<HD>(&mv, v, B, S, KV, ST)) != cudaSuccess)
    return err;
  dq_wg<HD><<<static_cast<unsigned>(tiles * H * B), WG_THREADS, s2,
              stream>>>(mq, mdo, mk, mv, lse_pad, dvec, dq, B, S, SP, H, KV,
                        causal, window, softcap, scale);
  return cudaGetLastError();
}

template <int HD>
int launch_hd(int bf16, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* dvec,
              float* lse_pad, float* dq, float* dk, float* dv, float* part,
              int B, int S, int SP, int H, int KV, int P, int causal,
              int window, float softcap, float scale, cudaStream_t stream) {
  if (bf16) {
    if (lse_pad == nullptr || SP < (S + BT - 1) / BT * BT || P < 1 ||
        (H / KV) % P != 0 || (P > 1 && part == nullptr))
      return cudaErrorInvalidValue;
    return launch_bf16<HD>(q, k, v, o, dout, lse, dvec, lse_pad, dq, dk, dv,
                           part, B, S, SP, H, KV, P, causal, window, softcap,
                           scale, stream);
  }
  if (SP != S || P != 1) return cudaErrorInvalidValue;
  return launch_fp32<HD>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, dvec, dq, dk, dv, B, S, H, KV,
      causal, window, softcap, scale, stream);
}

}  // namespace

REPRO_ERROR_STRING(flash_attention_bwd)

// dvec: (B, H, SP) fp32 scratch for D; lse_pad: null (fp32), or (B, H, SP)
// fp32 zeros for the bf16 kernels' copy of lse; SP: S (fp32), or S rounded
// up to a multiple of 128 (bf16); dq, dk, dv: fp32 outputs; P: the groups
// the bf16 dK/dV kernel splits each KV head's query heads into (1 for
// fp32), and part: null where P is 1, else (2, P, B, S, KV, d) fp32 scratch
// for the groups' partial dK and dV
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dvec, float* lse_pad,
    float* dq, float* dk, float* dv, float* part, int B, int S, int SP,
    int H, int KV, int P, int d, int bf16, int causal, int window,
    float softcap, float scale, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  switch (d) {
    case 32:
      return launch_hd<32>(bf16, q, k, v, o, dout, lse, dvec, lse_pad, dq,
                           dk, dv, part, B, S, SP, H, KV, P, causal, window,
                           softcap, scale, stream);
    case 64:
      return launch_hd<64>(bf16, q, k, v, o, dout, lse, dvec, lse_pad, dq,
                           dk, dv, part, B, S, SP, H, KV, P, causal, window,
                           softcap, scale, stream);
    case 112:
      return launch_hd<112>(bf16, q, k, v, o, dout, lse, dvec, lse_pad, dq,
                            dk, dv, part, B, S, SP, H, KV, P, causal, window,
                            softcap, scale, stream);
    case 128:
      return launch_hd<128>(bf16, q, k, v, o, dout, lse, dvec, lse_pad, dq,
                            dk, dv, part, B, S, SP, H, KV, P, causal, window,
                            softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
