// IVF stage 2 over int8 snapshot rows, scored
// scale * (q . c) + sum(q) * offset without dequantizing a tile: see
// ivf_stage2.cuh for what it replaces (src/repro/kernels/nn_search_ivf.py:281,
// ivf_stage2_quantized_pallas), what bounds it (a quarter of fp32's bytes
// for the same FMAs: the conversions, shared-memory reads and list inserts
// per byte) and its design (TMA ring of 32-dim stages, 4 queries x 4 rows a
// lane, each code converted once per query chunk).
#include "ivf_stage2.cuh"

REPRO_ERROR_STRING(ivf_stage2_q)

extern "C" int ivf_stage2_q_plan(int D, int k, int streamed,
    int* stages, int* per_sm, int* sms) {
  return ivf_plan<true>(D, k, streamed, stages, per_sm, sms);
}

extern "C" int ivf_stage2_q_launch(
    const int8_t* packed_codes, const float* packed_scale,
    const float* packed_offset, const int* packed_ids, const int* bucket_occ,
    int C, long long cap, const float* queries, const int* probes, int B,
    int nprobe, int D, int k, int stages, int streamed, int resident,
    int slices, int* scratch, float* part_s, int* part_i, float* out_s,
    int64_t* out_i, unsigned long long* prof, cudaStream_t stream) {
  return ivf_stage2_run<true>(
      packed_codes, packed_scale, packed_offset, packed_ids, bucket_occ, C,
      cap, queries, probes, B, nprobe, D, k, stages, streamed, resident,
      slices, scratch, part_s, part_i, out_s, out_i, 1, prof, stream);
}
