// Fused Knowledge Bank lookup over an int8-coded bank: for each requested
// row with pending lazy gradients, dequantize it, apply the clipped average,
// re-quantize it and write codes, scale and offset back; zero the row's
// three gradient caches; return the dequantization of what the bank now
// stores. A row without pending gradients keeps its exact codes, scale and
// offset, so a read-only lookup returns the same bits every time.
//
// Replaces: src/repro/kernels/kb_fused_lookup.py:209,
// kb_fused_lookup_q_pallas (body _fused_kernel_q, :142): kb_lookup_q
// without the version bump, which the caller makes.
//
// What bounds it: bytes. A lookup of B ids with U distinct rows, P of them
// with pending gradients, must read U code rows (D bytes each), U scale /
// offset pairs and 2U counters, P grad_sum rows (4D bytes); write P code
// rows and scale / offset pairs, U zeroed grad_sum rows, 2U counters and B
// fp32 output rows: tens to hundreds of KB at serving batches, so the few
// microseconds of two launches, not HBM's 3.35 TB/s, are what a call costs.
//
// Design: PR 13's fused lookup (kb_fused_lookup.cu) over codes. The TPU
// kernel streams the WHOLE bank through a one-hot matmul; here only the
// requested rows are touched, one warp per request slot:
//   1. the warp of a row's FIRST occurrence owns the row. If the row has
//      pending gradients it stages the averaged gradient in shared memory
//      (grad_sum is read once), clips it, overwrites each staged entry with
//      the updated value dequant(code) + delta while it takes the row's max
//      and min, then codes the row again: offset = (hi + lo) / 2,
//      scale = (hi - lo) / 254 (1 where that is not > 0),
//      code = clip(rint((v - offset) / scale), -127, 127), rint rounding
//      half to even as jnp.round does. Every float operation is rounded on
//      its own (no FMA contraction) and divisions are IEEE, so the kernel
//      repeats the plain version's arithmetic step by step; only the sum of
//      squares runs in another order. Later occurrences and ids outside
//      [0, N) skip the row (ids outside read zeros), so no two warps write
//      one row;
//   2. every later occurrence copies the owner's output slot.
#include "common.cuh"

namespace {

__device__ __forceinline__ float dequant(int8_t c, float scale, float off) {
  return __fadd_rn(__fmul_rn(static_cast<float>(c), scale), off);
}

__global__ void apply_first_occurrences_q(
    int8_t* __restrict__ codes, float* __restrict__ qscale,
    float* __restrict__ qoffset, float* __restrict__ grad_sum,
    float* __restrict__ grad_cnt, float* __restrict__ grad_sqnorm,
    const int64_t* __restrict__ ids, int B, int64_t N, int D, float lazy_lr,
    float zmax, float* __restrict__ vals) {
  extern __shared__ float s_row[];  // [rows per block][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= B) return;
  const int64_t id = ids[j];
  float* out = vals + static_cast<int64_t>(j) * D;
  if (id < 0 || id >= N) {
    for (int d = lane; d < D; d += 32) out[d] = 0.f;
    return;
  }
  bool seen = false;
  for (int i = lane; i < j; i += 32) seen |= (ids[i] == id);
  if (__any_sync(FULL_MASK, seen)) return;  // pass 2 fills this slot

  int8_t* row = codes + id * D;
  float* gs = grad_sum + id * D;
  const float cnt = grad_cnt[id];
  float scale = qscale[id], off = qoffset[id];
  if (cnt > 0.f) {
    // each lane reads back only the entries it staged itself
    float* v = s_row + warp * D;
    const float c = fmaxf(cnt, 1.f);
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float a = __fdiv_rn(gs[d], c);
      v[d] = a;
      ss = __fadd_rn(ss, __fmul_rn(a, a));
    }
    const float clip =
        clip_scale(__fsqrt_rn(warp_sum(ss)), grad_sqnorm[id], c, zmax);
    float hi = -FLT_MAX, lo = FLT_MAX;
    for (int d = lane; d < D; d += 32) {
      const float x = apply_delta(dequant(row[d], scale, off), v[d],
                                  -lazy_lr, clip);
      v[d] = x;
      hi = fmaxf(hi, x);
      lo = fminf(lo, x);
    }
    hi = warp_max(hi);
    lo = warp_min(lo);
    off = __fmul_rn(0.5f, __fadd_rn(hi, lo));
    scale = __fdiv_rn(__fsub_rn(hi, lo), 254.f);
    if (!(scale > 0.f)) scale = 1.f;
    for (int d = lane; d < D; d += 32) {
      const float q = rintf(__fdiv_rn(__fsub_rn(v[d], off), scale));
      const int8_t code =
          static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
      row[d] = code;
      out[d] = dequant(code, scale, off);
      gs[d] = 0.f;
    }
    if (lane == 0) {
      qscale[id] = scale;
      qoffset[id] = off;
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      out[d] = dequant(row[d], scale, off);
      gs[d] = 0.f;
    }
  }
  if (lane == 0) {
    grad_cnt[id] = 0.f;
    grad_sqnorm[id] = 0.f;
  }
}

__global__ void copy_duplicates_q(const int64_t* __restrict__ ids, int B,
                                  int64_t N, int D,
                                  float* __restrict__ vals) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= B) return;
  const int64_t id = ids[j];
  if (id < 0 || id >= N) return;
  int first = j;
  for (int i = lane; i < j; i += 32)
    if (ids[i] == id) first = min(first, i);
  first = __reduce_min_sync(FULL_MASK, first);
  if (first == j) return;
  const float* src = vals + static_cast<int64_t>(first) * D;
  float* dst = vals + static_cast<int64_t>(j) * D;
  for (int d = lane; d < D; d += 32) dst[d] = src[d];
}

}  // namespace

REPRO_ERROR_STRING(kb_fused_lookup_q)

extern "C" int kb_fused_lookup_q_launch(
    int8_t* codes, float* qscale, float* qoffset, float* grad_sum,
    float* grad_cnt, float* grad_sqnorm, const int64_t* ids, int B,
    long long N, int D, float lazy_lr, float zmax, int rows_per_block,
    float* vals, cudaStream_t stream) {
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  const int threads = rows_per_block * 32;
  const size_t smem = sizeof(float) * rows_per_block * D;
  cudaError_t err = cudaFuncSetAttribute(
      apply_first_occurrences_q, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  apply_first_occurrences_q<<<blocks, threads, smem, stream>>>(
      codes, qscale, qoffset, grad_sum, grad_cnt, grad_sqnorm, ids, B, N, D,
      lazy_lr, zmax, vals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  copy_duplicates_q<<<blocks, threads, 0, stream>>>(ids, B, N, D, vals);
  return cudaGetLastError();
}
