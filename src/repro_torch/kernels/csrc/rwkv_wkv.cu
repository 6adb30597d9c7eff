// RWKV6 "Finch" WKV recurrence in the JAX layout: r, k, v and w
// (B, S, H, d), u (H, d); out y (B, S, H, d) and the state after the last
// step S_fin (B, H, d, d), both fp32. r, k and v are fp32 or bf16 (the
// model dtype), w and u fp32, d in {16, 32, 64}.
//
// Replaces: src/repro/kernels/rwkv_wkv.py:54, rwkv_wkv_pallas (the JAX
// model path's time scan, models/ssm.py:253-262, computes the same
// recurrence). The Pallas kernel keeps S_fin in scratch; here it is an
// output, since the decode cache starts from it.
//
// What it computes: with S_0 = 0, for t = 0 .. S-1,
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j]),
//   S[i][j] <- S[i][j] w_t[i] + k_t[i] v_t[j],
// in the equal form y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] c_t with
// c_t = sum_i r_t[i] u[i] k_t[i], so that each (i, j) costs one FMA for y
// and a multiply and an FMA for S.
//
// What bounds it: bytes. At the rwkv6-7b prefill (B 4, S 2048, H 64,
// d 64, r/k/v bf16) it reads 201 MB of r, k, v and 134 MB of w and writes
// 134 MB of y and 4 MB of S_fin: 0.14 ms at 3.35 TB/s; its 2 B H S d^2
// FMAs (8.6 GFLOP) take 0.13 ms at the fp32 peak. Neither is reached: the
// 2048 steps run in series, and each step's broadcast reads of r, k and w
// from shared memory, more than its FMAs, appear to set its pace.
//
// Design: one block per (b, h), d^2 / 16 threads (256 at d 64); the
// (d, d) state stays in fp32 registers for the whole sequence (the Pallas
// kernel chunks time only to fit VMEM, and carries the same numbers across
// chunks). Thread (q, j) holds rows 8 q .. 8 q + 7 of columns j and
// j + d / 2, so each float4 of r, k and w it reads feeds two columns, and
// every lane of a warp reads the same float4 (one broadcast). One thread a
// column, holding all d of its rows, ran 1.37x slower at the prefill: one
// warp a scheduler, and twice the shared loads a step. Time runs in
// chunks of TC steps. The next chunk of r, k, v and w is copied into
// shared memory with cp.async, in its own dtype, while the current one
// runs. r and k are widened to fp32 once a chunk, and c_t summed once a
// step (d / TC threads a step, joined by shuffles in a fixed order). Each
// step writes the d / 8 partial y sums of a column to shared memory; at
// the end of the chunk the block adds them in a fixed order, adds
// v_j c_t, and writes the chunk's y rows whole. S_fin goes out at the end.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_pipeline.h>

namespace {

constexpr int TC = 16;   // time steps per chunk
constexpr int RT = 8;    // state rows a thread, in each of its 2 columns

// threads a block: d / RT row groups x d / 2 column pairs
__host__ __device__ constexpr int threads(int D) { return D * D / (2 * RT); }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows t0 .. t0 + TC - 1 of one (b, h) slice of a (B, S, H, D) tensor
// into dst[TC][D], 16 bytes a copy with cp.async; rows past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src,
                                           int64_t row_stride, int t0,
                                           int S) {
  constexpr int PER_ROW = D * static_cast<int>(sizeof(T)) / 16;
  for (int idx = threadIdx.x; idx < TC * PER_ROW; idx += threads(D)) {
    const int r = idx / PER_ROW, c = idx % PER_ROW;
    char* d = reinterpret_cast<char*>(dst + r * D) + 16 * c;
    if (t0 + r < S)
      __pipeline_memcpy_async(
          d,
          reinterpret_cast<const char*>(
              src + static_cast<int64_t>(t0 + r) * row_stride) + 16 * c,
          16);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// The block's shared memory (dynamic: above 48 KB for fp32 inputs). Every
// array's size is a multiple of 16 bytes, so each starts 16-byte aligned.
template <typename T, int D>
struct alignas(16) Smem {
  T raw_r[2][TC * D];                        // chunks as copied, two buffers
  T raw_k[2][TC * D];
  T raw_v[2][TC * D];
  float raw_w[2][TC * D];
  float fr[TC * D];                          // the chunk's r and k in fp32
  float fk[TC * D];
  float yp[D / RT][TC * D];                  // partial y sums of a chunk
  float su[D];
  float cs[TC];                              // c_t of the chunk's steps
};

template <typename T, int D>
__global__ void __launch_bounds__(threads(D))
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_fin, int S, int H) {
  static_assert(D % TC == 0 && D <= 64, "d must be 16, 32 or 64");
  constexpr int L = D / TC;                  // threads that sum one c_t
  constexpr int NT = threads(D), G = D / RT, HALF = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T, D>& sm = *reinterpret_cast<Smem<T, D>*>(smem_raw);
  auto& raw_r = sm.raw_r;
  auto& raw_k = sm.raw_k;
  auto& raw_v = sm.raw_v;
  auto& raw_w = sm.raw_w;
  float* fr = sm.fr;
  float* fk = sm.fk;
  auto& yp = sm.yp;
  float* su = sm.su;
  float* cs = sm.cs;

  // thread (q, j): rows q RT .. q RT + RT - 1 of columns j and j + d / 2
  const int tid = threadIdx.x, q = tid / HALF, j = tid % HALF;
  const int i0 = q * RT;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t row = static_cast<int64_t>(H) * D;   // elements a step
  const int64_t base = (static_cast<int64_t>(b) * S * H + h) * D;
  const T* rb = r + base;
  const T* kb = k + base;
  const T* vb = v + base;
  const float* wb = w + base;
  float* yb = y + base;

  if (tid < D) su[tid] = u[h * D + tid];
  float s0[RT], s1[RT];        // S[i0 + e][j], S[i0 + e][j + d / 2]
#pragma unroll
  for (int e = 0; e < RT; ++e) s0[e] = s1[e] = 0.f;

  const int n_chunks = (S + TC - 1) / TC;
  copy_chunk<T, D>(raw_r[0], rb, row, 0, S);
  copy_chunk<T, D>(raw_k[0], kb, row, 0, S);
  copy_chunk<T, D>(raw_v[0], vb, row, 0, S);
  copy_chunk<float, D>(raw_w[0], wb, row, 0, S);
  __pipeline_commit();

  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1, t0 = c * TC;
    __pipeline_wait_prior(0);                // this thread's copies of c
    // every copy of chunk c has landed, and every thread is done with
    // chunk c - 1 (its fp32 arrays, partial sums and the raw buffer
    // copied into next)
    __syncthreads();
    if (c + 1 < n_chunks) {
      const int nb = buf ^ 1, t1 = t0 + TC;
      copy_chunk<T, D>(raw_r[nb], rb, row, t1, S);
      copy_chunk<T, D>(raw_k[nb], kb, row, t1, S);
      copy_chunk<T, D>(raw_v[nb], vb, row, t1, S);
      copy_chunk<float, D>(raw_w[nb], wb, row, t1, S);
      __pipeline_commit();
    }
    for (int e = tid; e < TC * D; e += NT) {
      fr[e] = to_f(raw_r[buf][e]);
      fk[e] = to_f(raw_k[buf][e]);
    }
    __syncthreads();
    if (tid < D) {  // c_t: threads L tt .. L tt + L - 1 sum TC terms each
      const int tt = tid / L, c0 = (tid % L) * TC;
      float part = 0.f;
#pragma unroll
      for (int i = c0; i < c0 + TC; ++i)
        part = fmaf(fr[tt * D + i] * su[i], fk[tt * D + i], part);
      if constexpr (L >= 2)
        part += __shfl_xor_sync(FULL_MASK, part, 1);
      if constexpr (L >= 4)
        part += __shfl_xor_sync(FULL_MASK, part, 2);
      if (tid % L == 0) cs[tt] = part;
    }
    const int steps = min(TC, S - t0);
    for (int tt = 0; tt < steps; ++tt) {
      const float v0 = to_f(raw_v[buf][tt * D + j]);
      const float v1 = to_f(raw_v[buf][tt * D + j + HALF]);
      const float* rt = fr + tt * D + i0;
      const float* kt = fk + tt * D + i0;
      const float* wt = raw_w[buf] + tt * D + i0;
      float a0 = 0.f, a1 = 0.f;              // column j, j + d / 2
#pragma unroll
      for (int e = 0; e < RT; e += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + e);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + e);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + e);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          a0 = fmaf(rr[x], s0[e + x], a0);
          s0[e + x] = fmaf(s0[e + x], ww[x], kk[x] * v0);
          a1 = fmaf(rr[x], s1[e + x], a1);
          s1[e + x] = fmaf(s1[e + x], ww[x], kk[x] * v1);
        }
      }
      yp[q][tt * D + j] = a0;
      yp[q][tt * D + j + HALF] = a1;
    }
    __syncthreads();                         // partial sums and c_t
    for (int e = tid; e < steps * D; e += NT) {
      const int tt = e / D;
      float a = yp[0][e] + yp[1][e];
#pragma unroll
      for (int p = 2; p < G; p += 2) a += yp[p][e] + yp[p + 1][e];
      yb[static_cast<int64_t>(t0 + tt) * row + e % D] =
          fmaf(to_f(raw_v[buf][e]), cs[tt], a);
    }
  }
  float* sf = s_fin + ((static_cast<int64_t>(b) * H + h) * D + i0) * D + j;
#pragma unroll
  for (int e = 0; e < RT; ++e) {
    sf[e * D] = s0[e];
    sf[e * D + HALF] = s1[e];
  }
}

template <typename T, int D>
int launch_typed(const void* r, const void* k, const void* v, const float* w,
                 const float* u, float* y, float* s_fin, int B, int S, int H,
                 cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(Smem<T, D>));
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wkv_kernel<T, D><<<B * H, threads(D), smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, y, s_fin, S, H);
  return cudaGetLastError();
}

template <int D>
int launch_d(int bf16, const void* r, const void* k, const void* v,
             const float* w, const float* u, float* y, float* s_fin, int B,
             int S, int H, cudaStream_t stream) {
  if (bf16)
    return launch_typed<__nv_bfloat16, D>(r, k, v, w, u, y, s_fin, B, S, H,
                                          stream);
  return launch_typed<float, D>(r, k, v, w, u, y, s_fin, B, S, H, stream);
}

}  // namespace

REPRO_ERROR_STRING(rwkv_wkv)

extern "C" int rwkv_wkv_launch(const void* r, const void* k, const void* v,
                               const float* w, const float* u, float* y,
                               float* s_fin, int B, int S, int H, int d,
                               int bf16, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch_d<16>(bf16, r, k, v, w, u, y, s_fin, B, S, H, stream);
    case 32:
      return launch_d<32>(bf16, r, k, v, w, u, y, s_fin, B, S, H, stream);
    case 64:
      return launch_d<64>(bf16, r, k, v, w, u, y, s_fin, B, S, H, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
