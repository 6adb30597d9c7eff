// Causal / sliding-window / soft-capped attention with an online softmax,
// in the JAX layout: q (B, S, H, d), k and v (B, S, KV, d), o (B, S, H, d),
// bf16 or fp32, d in {32, 64, 128}. GQA is read in place: query head h
// reads KV head h / (H / KV), with no repeated copy of k and v.
//
// Replaces: src/repro/kernels/flash_attention.py:85, flash_attention_pallas
// (and the model path's flash_attention_jax, models/layers.py:149).
//
// What it computes, as both JAX versions do: fp32 scores q.k / sqrt(d),
// the optional tanh soft cap, masked scores -1e30, a running max m, sum l
// and accumulator acc per query row over KV tiles (p = exp(s - m_new),
// corr = exp(m - m_new)), and o = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: operations. At the LM serve shapes (B 4, S 2048, H 32,
// KV 4, d 128, causal) the causal pairs need 4 B H d S^2/2 ~ 137 GFLOP
// against ~151 MB of q, k, v and o: 0.139 ms at the 989 TFLOP/s bf16
// tensor-core peak (2.05 ms at the 67 TFLOP/s fp32 peak for fp32 inputs),
// 0.045 ms of bytes.
//
// Both paths run one block per (head, batch, 64-query tile), heaviest
// causal tiles launched first, and loop over the KV tiles that the causal
// diagonal and the window leave (the Pallas kernel's block-triangular
// skip). Keys past S (the ragged edge) score -1e30 and read zero rows.
//
// bf16 (the serve path; flash_bf16): the two products on the tensor cores
// with mma.sync m16n8k16 (bf16 in, fp32 sums). Four warps, 16 query rows
// each; Q, K and V tiles of 64 rows staged in shared memory by cp.async
// (V's copy in flight while Q.K^T runs), rows padded by 16 bytes so that
// ldmatrix reads no bank twice. The scores stay in the mma accumulators;
// a row's max and sum are reduced over the 4 lanes that hold it, and P
// stays in registers as the A operand of P.V (the accumulator layout of
// one product is the operand layout of the next). Products of bf16 values
// are exact in fp32, so the scale 1/sqrt(d) is applied to the fp32 score
// rather than to q first: the two orders differ by fp32 rounding only. P
// rounded once to bf16 would move an output by up to a few bf16 ulps of
// it, so P.V runs twice, on bf16 hi and lo parts of P (lo = P - hi,
// rounded): P keeps ~16 bits, and the output agrees with the fp32 plain
// version but for its final rounding to bf16. wgmma, TMA and a pipelined
// ring of tiles are for a later PR.
//
// fp32 (flash_fp32): fp32 FMAs on the CUDA cores, q cast and scaled before
// the product as in JAX. 256 threads as a 16 x 16 grid: thread (ty, tx)
// owns query rows 4ty..4ty+3, scores them against keys tx and tx + 16 of a
// 32-key tile over float4 reads, keeps m and l in registers (reduced over
// the 16 lanes that share a row), writes p to shared memory and
// accumulates output dims tx, tx + 16, ... of its rows.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_pipeline.h>

namespace {

constexpr int BQ = 64;          // query rows per block (both paths)
constexpr float NEG = -1e30f;

// the first KV tile start (a multiple of bk) that the window leaves to
// query tile q0: tiles with q0 - (k0 + bk - 1) >= window are skipped
__device__ __forceinline__ int first_kv_tile(int q0, int window, int bk) {
  if (window <= 0) return 0;
  const int lo = q0 - window - bk + 2;
  return lo > 0 ? (lo + bk - 1) / bk * bk : 0;
}

__device__ __forceinline__ bool live(int qp, int kp, int S, int causal,
                                     int window) {
  bool ok = kp < S;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_BK = 64;      // keys per KV tile
constexpr int MMA_NT = 128;     // 4 warps x 16 query rows

template <int HD>
__host__ __device__ constexpr int mma_stride() { return HD + 8; }  // bf16s

template <int HD>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (BQ + 2 * MMA_BK) * mma_stride<HD>();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b for one m16n8k16 tile: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as two packed bf16 pairs: hi rounds them, lo rounds what hi
// leaves (exact in fp32), so hi + lo holds x and y to ~2^-17 of them
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Rows [r0, r0 + ROWS) of one head into a bf16 tile of row stride
// mma_stride<HD>(), 16 bytes a copy with cp.async; rows >= S are zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int r0, int S) {
  constexpr int PER_ROW = HD / 8;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += MMA_NT) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 8;
    __nv_bfloat16* d = dst + r * mma_stride<HD>() + c;
    if (r0 + r < S)
      __pipeline_memcpy_async(
          d, src + static_cast<int64_t>(r0 + r) * row_stride + c, 16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(MMA_NT)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
           int S, int H, int KV, int causal, int window, float softcap,
           float scale) {
  constexpr int LD = mma_stride<HD>();
  constexpr int NKT = MMA_BK / 8;            // 8-key score tiles per warp
  constexpr int NDT = HD / 8;                // 8-dim output tiles per warp
  extern __shared__ __align__(16) __nv_bfloat16 smem_h[];
  __nv_bfloat16* Qs = smem_h;                // BQ x LD
  __nv_bfloat16* Ks = Qs + BQ * LD;          // MMA_BK x LD
  __nv_bfloat16* Vs = Ks + MMA_BK * LD;      // MMA_BK x LD

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest first
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;   // mma fragment row and column
  const int64_t qrow = static_cast<int64_t>(H) * HD;
  const int64_t krow = static_cast<int64_t>(KV) * HD;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * HD;

  copy_tile<HD, BQ>(Qs, q + (static_cast<int64_t>(b) * S * H + h) * HD, qrow,
                    q0, S);
  __pipeline_commit();

  // rows 16 warp + g and 16 warp + g + 8 of the tile: m, l, and the output
  // accumulators (fragment layout: [dim tile][row half * 2 + column])
  const int qp0 = q0 + 16 * warp + g, qp1 = qp0 + 8;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] =
      acc[j][3] = 0.f;

  // ldmatrix row addresses of this lane: A (Q rows), B of Q.K^T (K rows,
  // two 8-key tiles per x4), B of P.V (V rows, transposed)
  const int a_row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = first_kv_tile(q0, window, MMA_BK); k0 < k_end;
       k0 += MMA_BK) {
    __syncthreads();          // the last tile's K and V reads are done
    copy_tile<HD, MMA_BK>(Ks, kb, krow, k0, S);
    __pipeline_commit();
    copy_tile<HD, MMA_BK>(Vs, vb, krow, k0, S);
    __pipeline_commit();
    __pipeline_wait_prior(1);                // Q (first tile) and K
    __syncthreads();

    float s[NKT][4];
#pragma unroll
    for (int t = 0; t < NKT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, Qs + a_row * LD + kk + a_col);
#pragma unroll
      for (int t = 0; t < NKT; t += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, Ks + (8 * t + k_row) * LD + kk + k_col);
        mma_bf16(s[t], a, bk[0], bk[1]);
        mma_bf16(s[t + 1], a, bk[2], bk[3]);
      }
    }

    // scale, cap and mask; row max over the quad that holds the row
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int t = 0; t < NKT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const int kp = k0 + 8 * t + 2 * tig + (e & 1);
        x = live(e < 2 ? qp0 : qp1, kp, S, causal, window) ? x : NEG;
        s[t][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < NKT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = expf(s[t][e] - m[e >> 1]);
        sum[e >> 1] += s[t][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(FULL_MASK, sum[r], 1);
      sum[r] += __shfl_xor_sync(FULL_MASK, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    __pipeline_wait_prior(0);                // V
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      // P's 16-key slice kk as the A operand (score tiles 2kk and 2kk + 1),
      // split into bf16 terms hi + lo: two products keep ~16 bits of P
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* pr = &s[2 * kk + (r >> 1)][2 * (r & 1)];
        split_bf16(pr[0], pr[1], hi[r], lo[r]);
      }
#pragma unroll
      for (int j = 0; j < NDT; j += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, Vs + (16 * kk + v_row) * LD + 8 * j + v_col);
        mma_bf16(acc[j], hi, bv[0], bv[1]);
        mma_bf16(acc[j], lo, bv[0], bv[1]);
        mma_bf16(acc[j + 1], hi, bv[2], bv[3]);
        mma_bf16(acc[j + 1], lo, bv[2], bv[3]);
      }
    }
  }

  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r ? qp1 : qp0;
    if (qp >= S) continue;
    __nv_bfloat16* orow = o + (static_cast<int64_t>(b) * S + qp) * qrow +
                          h * HD + 2 * tig;
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(__fdiv_rn(acc[j][2 * r], den[r]),
                                __fdiv_rn(acc[j][2 * r + 1], den[r]));
  }
}

// ---------------------------------------------------------------------------
// fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_BK = 32;      // keys per KV tile
constexpr int F32_NT = 256;     // threads per block: a 16 x 16 grid
constexpr int PS = F32_BK + 4;  // row stride of the probability tile

// row stride (floats) of the Q and K tiles
template <int HD>
__host__ __device__ constexpr int f32_stride() { return HD + 4; }

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (BQ * f32_stride<HD>() + F32_BK * f32_stride<HD>() +
                          F32_BK * HD + BQ * PS);
}

// Rows [r0, r0 + ROWS) of one head, src pointing at (row 0, that head) of a
// row-major tensor whose rows are row_stride elements apart, into the fp32
// tile dst (row stride `stride`), each value times mul; rows >= S are
// zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* __restrict__ src,
                                          int64_t row_stride, int r0, int S,
                                          float mul) {
  constexpr int PER_ROW = HD / 4;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += F32_NT) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) {
      x = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(r0 + r) * row_stride + c);
      x = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
    }
    *reinterpret_cast<float4*>(dst + r * stride + c) = x;
  }
}

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// a butterfly: every lane of the 16 ends with the same bits (IEEE addition
// commutes)
__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

template <int HD>
__global__ void __launch_bounds__(F32_NT, 2)
flash_fp32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, int S, int H,
           int KV, int causal, int window, float softcap, float scale) {
  constexpr int QS = f32_stride<HD>();
  constexpr int DPT = HD / 16;               // output dims per thread
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;                        // BQ x QS, q * scale
  float* Ks = Qs + BQ * QS;                  // F32_BK x QS
  float* Vs = Ks + F32_BK * QS;              // F32_BK x HD
  float* Ps = Vs + F32_BK * HD;              // BQ x PS

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest first
  const int kvh = h / (H / KV);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qrow = static_cast<int64_t>(H) * HD;
  const int64_t krow = static_cast<int64_t>(KV) * HD;
  const float* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  const float* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * HD;

  load_tile<HD, BQ>(Qs, QS, q + (static_cast<int64_t>(b) * S * H + h) * HD,
                    qrow, q0, S, scale);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = first_kv_tile(q0, window, F32_BK); k0 < k_end;
       k0 += F32_BK) {
    __syncthreads();          // the last tile's K, V and P reads are done
    load_tile<HD, F32_BK>(Ks, QS, kb, krow, k0, S, 1.f);
    load_tile<HD, F32_BK>(Vs, HD, vb, krow, k0, S, 1.f);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < HD; dd += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * QS + dd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[i][j] = live(qp, k0 + tx + 16 * j, S, causal, window) ? x : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(4 * ty + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group16_sum(sum);
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    __syncwarp();             // a warp reads only the P rows it wrote

#pragma unroll 2
    for (int c = 0; c < F32_BK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DPT];
#pragma unroll
        for (int e = 0; e < DPT; ++e) vv[e] = Vs[(c + cc) * HD + 16 * e + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pc = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                         : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pc, vv[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp < S) {
      const float den = fmaxf(l[i], 1e-30f);
      float* orow = o + (static_cast<int64_t>(b) * S + qp) * qrow + h * HD;
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        orow[16 * e + tx] = __fdiv_rn(acc[i][e], den);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD>
int launch_hd(int bf16, const void* q, const void* k, const void* v,
              void* o, int B, int S, int H, int KV, int causal, int window,
              float softcap, float scale, cudaStream_t stream) {
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  cudaError_t err;
  if (bf16) {
    using T = __nv_bfloat16;
    const size_t smem = mma_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_bf16<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_bf16<HD><<<grid, MMA_NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, causal,
        window, softcap, scale);
  } else {
    const size_t smem = f32_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_fp32<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_fp32<HD><<<grid, F32_NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, KV,
        causal, window, softcap, scale);
  }
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING(flash_attention)

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int d, int bf16,
                                      int causal, int window, float softcap,
                                      float scale, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  switch (d) {
    case 32:
      return launch_hd<32>(bf16, q, k, v, o, B, S, H, KV, causal, window,
                           softcap, scale, stream);
    case 64:
      return launch_hd<64>(bf16, q, k, v, o, B, S, H, KV, causal, window,
                           softcap, scale, stream);
    case 128:
      return launch_hd<128>(bf16, q, k, v, o, B, S, H, KV, causal, window,
                            softcap, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
