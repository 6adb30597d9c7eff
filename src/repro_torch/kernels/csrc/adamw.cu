// AdamW's step over a tree of leaves: the global norm of the gradients,
// the clip scale, and each entry's update of its parameter and two
// moments, in place. A leaf's gradient and parameter are bf16 or fp32,
// its moments fp32 or bf16 (AdamW's moments_dtype).
//
// Replaces: none. JAX's update (src/repro/optim/optimizer.py:37-73) is jnp
// code that XLA fuses into a few passes; the port's eager version
// (kernels/ref.py adamw_ref) runs about twenty elementwise kernels per
// chunk of 2^24 entries. This source is that fusion, written by hand.
//
// What it computes, as the eager version does, operation for operation:
//   gn    = sqrt(sum over leaves, in the tree's order, of sum g^2)
//   scale = min(1, (1 / max(gn, 1e-12)) * clip)      (torch's clip / gn)
//   g'    = g * scale                                 (clip > 0 only)
//   m'    = m * b1 + g' * (1 - b1)
//   v'    = v * b2 + (g' * g') * (1 - b2)
//   step  = (m' / bc1) / (sqrt(v' / bc2) + eps) [+ p * wd]
//   p'    = p - lr * step
// each operation rounded on its own to fp32 (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn: nvcc would otherwise contract a multiply and an
// add into one FMA, which the eager kernels never do), the Python
// constants rounded to fp32 as torch rounds a scalar operand, and p', m'
// and v' stored in their own dtypes (bf16 by round to nearest even). bc1,
// bc2 and lr are 0-d fp32 tensors on the card, read through pointers, so
// that a step never waits on the host; m' / bc1 is a true division. Given
// the same scale, p', m' and v' are bit-identical to the eager version's.
//
// What bounds it: bytes. An entry reads g twice (the norm, the update), p,
// m and v once, and writes p, m and v: 24 bytes an entry with bf16 g and p
// and fp32 moments, ~79 GB for yi-6b's 16 layers (3.29 B entries), 24 ms at
// 3.35 TB/s. Its operations (~15 fp32 a entry, a division, a square root)
// are far below the card's rate.
//
// Design: no float atomics, so two runs agree bit for bit.
// - sumsq_partials, one launch a leaf: each of up to NORM_SLOTS blocks
//   adds the squares of a grid-stride share of the leaf in fp64 (each
//   square of an fp32 value is exact in fp64), reduces its threads in a
//   fixed order and writes its sum to its slot; block 0 writes zeros to
//   the leaf's unused slots.
// - norm_finalize, one block: the slots of each leaf in a fixed order,
//   the leaves in the tree's order; writes gn and the scale to the card.
// - adamw_update, one launch a leaf: a grid-stride loop of 8 entries a
//   thread an iteration, each load and store 16 bytes (bf16 x 8 or two
//   float4s), where the leaf's four tensors start on 16-byte boundaries
//   (else one entry at a time); the entries past the last multiple of 8
//   one at a time.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int NT = 256;            // threads a block
constexpr int VEC = 8;             // entries a thread takes at a time
constexpr int NORM_SLOTS = 1024;   // partial sums a leaf (the most blocks)
constexpr int UPDATE_BLOCKS_PER_SM = 8;

// 8 entries of a leaf as fp32, from 16 bytes (bf16) or 32 (fp32)
__device__ __forceinline__ void load8(const float* p, float (&x)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __low2float(h[i]);
    x[2 * i + 1] = __high2float(h[i]);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&x)[VEC]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __halves2bfloat162(__float2bfloat16_rn(x[2 * i]),
                              __float2bfloat16_rn(x[2 * i + 1]));
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The block's sum of one fp64 value a thread, to thread 0: each warp adds
// down its lanes, then warp 0 adds the warps' sums in warp order.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[NT / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(FULL_MASK, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                 // the last call's reads are done
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) total += warp_sums[w];
  return total;
}

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(NT)
sumsq_partials(const T* __restrict__ x, int64_t n,
               double* __restrict__ slots) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  double acc = 0.0;
  int64_t done = 0;
  if constexpr (VECTOR) {
    const int64_t chunks = n / VEC;
    for (int64_t c = tid; c < chunks; c += stride) {
      float e[VEC];
      load8(x + c * VEC, e);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc = fma(static_cast<double>(e[i]), static_cast<double>(e[i]), acc);
    }
    done = chunks * VEC;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    const double e = to_f(x[i]);
    acc = fma(e, e, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) slots[blockIdx.x] = acc;
  if (blockIdx.x == 0)
    for (int s = gridDim.x + threadIdx.x; s < NORM_SLOTS; s += NT)
      slots[s] = 0.0;
}

// gn and the clip scale (1 where clip <= 0) into out[0], out[1]
__global__ void __launch_bounds__(NT)
norm_finalize(const double* __restrict__ slots, int leaves, float clip,
              float* __restrict__ out) {
  double total = 0.0;
  for (int leaf = 0; leaf < leaves; ++leaf) {
    double part = 0.0;
    for (int s = threadIdx.x; s < NORM_SLOTS; s += NT)
      part += slots[static_cast<int64_t>(leaf) * NORM_SLOTS + s];
    total += block_sum(part);      // thread 0's
  }
  if (threadIdx.x == 0) {
    const float gn = __double2float_rn(sqrt(total));
    float scale = 1.f;
    if (clip > 0.f) {
      // torch: clamp(reciprocal(clamp(gn, min=1e-12)) * clip, max=1),
      // NaN kept
      const float den = gn != gn ? gn : fmaxf(gn, 1e-12f);
      const float r = __fmul_rn(__frcp_rn(den), clip);
      scale = r != r ? r : fminf(r, 1.f);
    }
    out[0] = gn;
    out[1] = scale;
  }
}

struct Hyper {
  float b1, c1, b2, c2, eps, wd;   // c1 = 1 - b1, c2 = 1 - b2 (fp32)
  int has_wd;
};

// one entry's update, the eager version's operations in its order
__device__ __forceinline__ void adamw_entry(float g, float& m, float& v,
                                            float& p, bool has_scale,
                                            float scale, float bc1,
                                            float bc2, float lr,
                                            const Hyper& hp) {
  if (has_scale) g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, hp.b1), __fmul_rn(g, hp.c1));
  v = __fadd_rn(__fmul_rn(v, hp.b2), __fmul_rn(__fmul_rn(g, g), hp.c2));
  float step = __fdiv_rn(__fdiv_rn(m, bc1),
                         __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), hp.eps));
  if (hp.has_wd) step = __fadd_rn(step, __fmul_rn(p, hp.wd));
  p = __fsub_rn(p, __fmul_rn(lr, step));
}

template <typename TG, typename TP, typename TM, bool VECTOR>
__global__ void __launch_bounds__(NT)
adamw_update(const TG* __restrict__ g, TM* __restrict__ m,
             TM* __restrict__ v, TP* __restrict__ p, int64_t n,
             const float* __restrict__ scale_ptr,
             const float* __restrict__ bc1_ptr,
             const float* __restrict__ bc2_ptr,
             const float* __restrict__ lr_ptr, Hyper hp) {
  const bool has_scale = scale_ptr != nullptr;
  const float scale = has_scale ? *scale_ptr : 1.f;
  const float bc1 = *bc1_ptr, bc2 = *bc2_ptr, lr = *lr_ptr;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NT;
  int64_t done = 0;
  if constexpr (VECTOR) {
    const int64_t chunks = n / VEC;
    for (int64_t c = tid; c < chunks; c += stride) {
      const int64_t o = c * VEC;
      float ge[VEC], me[VEC], ve[VEC], pe[VEC];
      load8(g + o, ge);
      load8(m + o, me);
      load8(v + o, ve);
      load8(p + o, pe);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        adamw_entry(ge[i], me[i], ve[i], pe[i], has_scale, scale, bc1, bc2,
                    lr, hp);
      store8(p + o, pe);
      store8(m + o, me);
      store8(v + o, ve);
    }
    done = chunks * VEC;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    float me = to_f(m[i]), ve = to_f(v[i]), pe = to_f(p[i]);
    adamw_entry(to_f(g[i]), me, ve, pe, has_scale, scale, bc1, bc2, lr, hp);
    store1(p + i, pe);
    store1(m + i, me);
    store1(v + i, ve);
  }
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 132;
  return sms;
}

unsigned blocks_for(int64_t n, int64_t most) {
  const int64_t want = (n + static_cast<int64_t>(NT) * VEC - 1) /
                       (static_cast<int64_t>(NT) * VEC);
  return static_cast<unsigned>(want < 1 ? 1 : want < most ? want : most);
}

bool aligned16(const void* a) {
  return (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

template <typename T>
void launch_sumsq(const void* x, int64_t n, double* slots,
                  cudaStream_t stream) {
  const unsigned nb = blocks_for(n, NORM_SLOTS);
  if (aligned16(x))
    sumsq_partials<T, true><<<nb, NT, 0, stream>>>(static_cast<const T*>(x),
                                                   n, slots);
  else
    sumsq_partials<T, false><<<nb, NT, 0, stream>>>(
        static_cast<const T*>(x), n, slots);
}

template <typename TG, typename TP, typename TM>
void launch_update(const void* g, void* m, void* v, void* p, int64_t n,
                   const float* scale, const float* bc1, const float* bc2,
                   const float* lr, const Hyper& hp, int sms,
                   cudaStream_t stream) {
  const unsigned nb = blocks_for(n, static_cast<int64_t>(sms) *
                                        UPDATE_BLOCKS_PER_SM);
  const TG* tg = static_cast<const TG*>(g);
  TM* tm = static_cast<TM*>(m);
  TM* tv = static_cast<TM*>(v);
  TP* tp = static_cast<TP*>(p);
  if (aligned16(g) && aligned16(m) && aligned16(v) && aligned16(p))
    adamw_update<TG, TP, TM, true><<<nb, NT, 0, stream>>>(
        tg, tm, tv, tp, n, scale, bc1, bc2, lr, hp);
  else
    adamw_update<TG, TP, TM, false><<<nb, NT, 0, stream>>>(
        tg, tm, tv, tp, n, scale, bc1, bc2, lr, hp);
}

using Bf16 = __nv_bfloat16;

// kind: bit 0 g bf16, bit 1 p bf16, bit 2 moments bf16
void launch_update_kind(int kind, const void* g, void* m, void* v, void* p,
                        int64_t n, const float* scale, const float* bc1,
                        const float* bc2, const float* lr, const Hyper& hp,
                        int sms, cudaStream_t stream) {
  switch (kind) {
    case 0: return launch_update<float, float, float>(
        g, m, v, p, n, scale, bc1, bc2, lr, hp, sms, stream);
    case 1: return launch_update<Bf16, float, float>(
        g, m, v, p, n, scale, bc1, bc2, lr, hp, sms, stream);
    case 2: return launch_update<float, Bf16, float>(
        g, m, v, p, n, scale, bc1, bc2, lr, hp, sms, stream);
    case 3: return launch_update<Bf16, Bf16, float>(
        g, m, v, p, n, scale, bc1, bc2, lr, hp, sms, stream);
    case 4: return launch_update<float, float, Bf16>(
        g, m, v, p, n, scale, bc1, bc2, lr, hp, sms, stream);
    case 5: return launch_update<Bf16, float, Bf16>(
        g, m, v, p, n, scale, bc1, bc2, lr, hp, sms, stream);
    case 6: return launch_update<float, Bf16, Bf16>(
        g, m, v, p, n, scale, bc1, bc2, lr, hp, sms, stream);
    default: return launch_update<Bf16, Bf16, Bf16>(
        g, m, v, p, n, scale, bc1, bc2, lr, hp, sms, stream);
  }
}

}  // namespace

REPRO_ERROR_STRING(adamw)

// One AdamW step over `leaves` leaves (host arrays of their pointers,
// entry counts and kinds), on `stream`: the norm's slots (leaves x
// NORM_SLOTS fp64 on the card), out = (gn, scale) fp32 on the card, then
// each leaf's update. clip <= 0: no clip (the scale is not applied).
extern "C" int adamw_launch(int leaves, const void* const* g,
                            void* const* m, void* const* v, void* const* p,
                            const long long* n, const int* kind,
                            double* slots, float* out, const float* bc1,
                            const float* bc2, const float* lr, float b1,
                            float c1, float b2, float c2, float eps, float wd,
                            float clip, cudaStream_t stream) {
  if (leaves <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < leaves; ++i) {
    double* s = slots + static_cast<int64_t>(i) * NORM_SLOTS;
    if (kind[i] & 1)
      launch_sumsq<Bf16>(g[i], n[i], s, stream);
    else
      launch_sumsq<float>(g[i], n[i], s, stream);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  norm_finalize<<<1, NT, 0, stream>>>(slots, leaves, clip, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Hyper hp{b1, c1, b2, c2, eps, wd, wd != 0.f};
  const float* scale = clip > 0.f ? out + 1 : nullptr;
  const int sms = sm_count();
  for (int i = 0; i < leaves; ++i) {
    if (n[i] == 0) continue;
    launch_update_kind(kind[i], g[i], m[i], v[i], p[i], n[i], scale, bc1,
                       bc2, lr, hp, sms, stream);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}
