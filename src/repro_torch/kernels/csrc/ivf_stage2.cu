// IVF stage 2 over fp32 snapshot rows: see ivf_stage2.cuh for what it
// replaces (src/repro/kernels/nn_search_ivf.py:186, ivf_stage2_pallas),
// what bounds it and its design.
#include "ivf_stage2.cuh"

REPRO_ERROR_STRING(ivf_stage2)

extern "C" int ivf_stage2_launch(const float* packed_vecs,
                                 const int* packed_ids,
                                 const int* bucket_occ, int C,
                                 long long cap, const float* queries,
                                 const int* probes, int B, int nprobe,
                                 int D, int k, int tile_rows,
                                 long long rows_per_slice, int slices,
                                 float* part_s, int* part_i, float* out_s,
                                 int64_t* out_i, cudaStream_t stream) {
  return ivf_stage2_run<false>(packed_vecs, nullptr, nullptr, packed_ids,
                               bucket_occ, C, cap, queries, probes, B,
                               nprobe, D, k, tile_rows, rows_per_slice,
                               slices, part_s, part_i, out_s, out_i, 1,
                               stream);
}
