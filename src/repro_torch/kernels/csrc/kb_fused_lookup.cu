// Fused Knowledge Bank lookup over fp32 rows: apply each requested row's
// pending lazy gradient, write the row back, zero its three gradient
// caches, bump its version where it had pending gradients, return it.
//
// Replaces: src/repro/kernels/kb_fused_lookup.py:84, kb_fused_lookup_pallas
// (plus the version bump that its caller makes,
// src/repro/core/kb_engine.py:219-224).
//
// Design: the TPU kernel streams the WHOLE bank through a one-hot MXU
// matmul (O(N*D) per lookup), because a TPU has no fast gather. Here a
// lookup touches only the requested rows, in one launch of one warp per
// output slot, designed for latency: kb_lookup.cuh says how.
#include "kb_lookup.cuh"

REPRO_ERROR_STRING(kb_fused_lookup)

extern "C" int kb_fused_lookup_launch(float* table, float* grad_sum,
                                      float* grad_cnt, float* grad_sqnorm,
                                      int* version, const int64_t* ids,
                                      int B, long long N, int D,
                                      float lazy_lr, float zmax,
                                      int rows_per_block, int stage_ids,
                                      float* vals, cudaStream_t stream) {
  const kb_lookup::Bank bank{table,    nullptr,  nullptr,     nullptr,
                             grad_sum, grad_cnt, grad_sqnorm, version};
  return kb_lookup::launch_fused_lookup<false>(bank, ids, B, N, D, lazy_lr,
                                               zmax, rows_per_block,
                                               stage_ids, vals, stream);
}
