// Fused Knowledge Bank lookup: apply each requested row's pending lazy
// gradient, write the row back, zero its three gradient caches, return it.
//
// Replaces: src/repro/kernels/kb_fused_lookup.py:84, kb_fused_lookup_pallas
// (kb_lookup(apply_pending=True) without the version bump).
//
// What bounds it: bytes. A lookup of B ids with U distinct rows, P of them
// with pending gradients, must read U table rows, P grad_sum rows and 2U
// counters and write P table rows, U zeroed grad_sum rows, 2U counters and
// B output rows: a few hundred KB at serving batches, so a few microseconds
// of launch latency, not the 3.35 TB/s of HBM, is what a call costs.
//
// Design: the TPU kernel streams the WHOLE bank through a one-hot MXU
// matmul (O(N*D) per lookup), because a TPU has no fast gather. Here a
// lookup touches only the requested rows, in two passes of one warp per
// request slot:
//   1. the warp of a row's FIRST occurrence in ids owns the row: it
//      averages the cached gradient (staged in shared memory, so grad_sum
//      is read once), clips it, writes the row and its output slot and
//      zeroes the caches. Later occurrences and ids outside [0, N) (the
//      Pallas kernel's -1 padding: zeros out, no write) skip the row, so
//      no two warps ever write one row;
//   2. every later occurrence copies the owner's output slot, so all
//      duplicates read the same updated row (the engine always pads a
//      batch with a duplicate, kb_engine.py:521-523).
// The dedupe is an O(B) scan of the ids per warp: B is a serving batch.
#include "common.cuh"

namespace {

__global__ void apply_first_occurrences(
    float* __restrict__ table, float* __restrict__ grad_sum,
    float* __restrict__ grad_cnt, float* __restrict__ grad_sqnorm,
    const int64_t* __restrict__ ids, int B, int64_t N, int D, float lazy_lr,
    float zmax, float* __restrict__ vals) {
  extern __shared__ float s_avg[];  // [rows per block][D]
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

  float* row = table + id * D;
  float* gs = grad_sum + id * D;
  const float cnt = grad_cnt[id];
  if (cnt > 0.f) {
    // each lane reads back only the entries it staged itself
    float* avg = s_avg + warp * D;
    const float c = fmaxf(cnt, 1.f);
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float a = __fdiv_rn(gs[d], c);
      avg[d] = a;
      ss = __fadd_rn(ss, __fmul_rn(a, a));
    }
    const float scale =
        clip_scale(__fsqrt_rn(warp_sum(ss)), grad_sqnorm[id], c, zmax);
    for (int d = lane; d < D; d += 32) {
      const float v = apply_delta(row[d], avg[d], -lazy_lr, scale);
      row[d] = v;
      out[d] = v;
      gs[d] = 0.f;
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      out[d] = row[d];
      gs[d] = 0.f;
    }
  }
  if (lane == 0) {
    grad_cnt[id] = 0.f;
    grad_sqnorm[id] = 0.f;
  }
}

__global__ void copy_duplicates(const int64_t* __restrict__ ids, int B,
                                int64_t N, int D, float* __restrict__ vals) {
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

REPRO_ERROR_STRING(kb_fused_lookup)

extern "C" int kb_fused_lookup_launch(float* table, float* grad_sum,
                                      float* grad_cnt, float* grad_sqnorm,
                                      const int64_t* ids, int B, long long N,
                                      int D, float lazy_lr, float zmax,
                                      int rows_per_block, float* vals,
                                      cudaStream_t stream) {
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  const int threads = rows_per_block * 32;
  const size_t smem = sizeof(float) * rows_per_block * D;
  cudaError_t err = cudaFuncSetAttribute(
      apply_first_occurrences, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  apply_first_occurrences<<<blocks, threads, smem, stream>>>(
      table, grad_sum, grad_cnt, grad_sqnorm, ids, B, N, D, lazy_lr, zmax,
      vals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  copy_duplicates<<<blocks, threads, 0, stream>>>(ids, B, N, D, vals);
  return cudaGetLastError();
}
