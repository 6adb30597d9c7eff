// Fused Knowledge Bank lookup over an int8-coded bank: for each requested
// row with pending lazy gradients, dequantize it, apply the clipped
// average, re-quantize it and write codes, scale and offset back; zero the
// row's three gradient caches; bump its version where it had pending
// gradients; return the dequantization of what the bank now stores. A row
// without pending gradients keeps its exact codes, scale and offset, so a
// read-only lookup returns the same bits every time.
//
// Replaces: src/repro/kernels/kb_fused_lookup.py:209,
// kb_fused_lookup_q_pallas (body _fused_kernel_q, :142), plus the version
// bump that its caller makes (src/repro/core/kb_engine.py:470-474).
//
// Design: the fp32 lookup's one pass (kb_lookup.cuh) over codes, where the
// TPU kernel streams the WHOLE bank through a one-hot matmul: one launch,
// one warp per output slot, only the requested rows touched.
#include "kb_lookup.cuh"

REPRO_ERROR_STRING(kb_fused_lookup_q)

extern "C" int kb_fused_lookup_q_launch(
    int8_t* codes, float* qscale, float* qoffset, float* grad_sum,
    float* grad_cnt, float* grad_sqnorm, int* version, const int64_t* ids,
    int B, long long N, int D, float lazy_lr, float zmax, int rows_per_block,
    int stage_ids, float* vals, cudaStream_t stream) {
  const kb_lookup::Bank bank{nullptr,  codes,    qscale,      qoffset,
                             grad_sum, grad_cnt, grad_sqnorm, version};
  return kb_lookup::launch_fused_lookup<true>(bank, ids, B, N, D, lazy_lr,
                                              zmax, rows_per_block,
                                              stage_ids, vals, stream);
}
