// Knowledge Bank flush: apply every row's pending lazy gradient and zero
// all gradient caches (kb_flush on the four cache leaves).
//
// Replaces: src/repro/kernels/lazy_apply.py:46, lazy_apply_pallas.
//
// What bounds it: bytes. Over N rows of width D, P of them with pending
// gradients, the flush must read the 2N counters, P table rows and P
// grad_sum rows, and write P table rows, N zeroed grad_sum rows and 2N
// counters. At ogbn-mag scale (1,939,743 x 128) that is over a GB: HBM's
// 3.35 TB/s is the limit, and nothing in the kernel is close to the fp32
// rate.
//
// Design: row-parallel, one warp per row, every access coalesced along the
// row. A row without pending gradients is never read: only its zeroed
// grad_sum is written, so the bytes moved follow the share of pending
// rows, not N * D * 4. A pending row stages its averaged gradient in
// shared memory, so grad_sum is read once. The norm is the Pallas
// kernel's own sqrt(max(sum(avg^2), 1e-24)) (lazy_apply.py:33-36), which
// differs from pending_delta's max(|avg|, 1e-12) only below that floor.
#include "common.cuh"

namespace {

__global__ void lazy_apply_rows(float* __restrict__ table,
                                float* __restrict__ grad_sum,
                                float* __restrict__ grad_cnt,
                                float* __restrict__ grad_sqnorm, int64_t N,
                                int D, float lazy_lr, float zmax) {
  extern __shared__ float s_avg[];  // [rows per block][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (r >= N) return;
  float* gs = grad_sum + r * D;
  const float cnt = grad_cnt[r];
  if (cnt > 0.f) {
    // each lane reads back only the entries it staged itself
    float* avg = s_avg + warp * D;
    float* row = table + r * D;
    const float c = fmaxf(cnt, 1.f);
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float a = __fdiv_rn(gs[d], c);
      avg[d] = a;
      ss = __fadd_rn(ss, __fmul_rn(a, a));
    }
    const float norm = __fsqrt_rn(fmaxf(warp_sum(ss), 1e-24f));
    const float scale = clip_scale(norm, grad_sqnorm[r], c, zmax);
    for (int d = lane; d < D; d += 32)
      row[d] = apply_delta(row[d], avg[d], -lazy_lr, scale);
  }
  for (int d = lane; d < D; d += 32) gs[d] = 0.f;
  if (lane == 0) {
    grad_cnt[r] = 0.f;
    grad_sqnorm[r] = 0.f;
  }
}

}  // namespace

REPRO_ERROR_STRING(lazy_apply)

extern "C" int lazy_apply_launch(float* table, float* grad_sum,
                                 float* grad_cnt, float* grad_sqnorm,
                                 long long N, int D, float lazy_lr,
                                 float zmax, int rows_per_block,
                                 cudaStream_t stream) {
  const long long blocks = (N + rows_per_block - 1) / rows_per_block;
  const size_t smem = sizeof(float) * rows_per_block * D;
  cudaError_t err = cudaFuncSetAttribute(
      lazy_apply_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lazy_apply_rows<<<static_cast<unsigned>(blocks), rows_per_block * 32,
                    smem, stream>>>(table, grad_sum, grad_cnt, grad_sqnorm,
                                    N, D, lazy_lr, zmax);
  return cudaGetLastError();
}
