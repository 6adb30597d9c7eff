// IVF stage 2 over fp32 snapshot rows: see ivf_stage2.cuh for what it
// replaces (src/repro/kernels/nn_search_ivf.py:186, ivf_stage2_pallas),
// what bounds it (bytes: 512 bytes a row against 4 queries' 512 FMAs) and
// its design (TMA ring of 16-dim stages, 4 queries x 2 rows a lane).
#include "ivf_stage2.cuh"

REPRO_ERROR_STRING(ivf_stage2)

extern "C" int ivf_stage2_plan(int D, int k, int streamed,
    int* stages, int* per_sm, int* sms) {
  return ivf_plan<false>(D, k, streamed, stages, per_sm, sms);
}

extern "C" int ivf_stage2_launch(
    const float* packed_vecs, const int* packed_ids, const int* bucket_occ,
    int C, long long cap, const float* queries, const int* probes, int B,
    int nprobe, int D, int k, int stages, int streamed, int resident,
    int slices, int* scratch, float* part_s, int* part_i, float* out_s,
    int64_t* out_i, unsigned long long* prof, cudaStream_t stream) {
  return ivf_stage2_run<false>(
      packed_vecs, nullptr, nullptr, packed_ids, bucket_occ, C, cap, queries,
      probes, B, nprobe, D, k, stages, streamed, resident, slices, scratch,
      part_s, part_i, out_s, out_i, 1, prof, stream);
}
