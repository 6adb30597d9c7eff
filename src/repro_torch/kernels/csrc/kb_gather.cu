// Knowledge Bank row gather: out[j] = table[ids[j]], zeros for ids outside
// [0, N) (the Pallas kernel's -1 padding).
//
// Replaces: src/repro/kernels/kb_gather.py:47, kb_gather_pallas.
//
// What bounds it: bytes. B ids with U distinct rows read U rows and write
// B rows: at serving batches a few tens of KB, so launch latency, not HBM
// bandwidth, is what a call costs.
//
// Design: the TPU kernel streams the whole bank through a one-hot MXU
// matmul because a TPU has no fast gather (kb_gather.py:4-9). Here each
// request row is one warp's coalesced copy, 16 bytes a thread when the
// row width and both base addresses allow it (D % 4 == 0, 16-byte aligned:
// one 512-byte row of D = 128 is one float4 per lane), 4 bytes otherwise.
#include "common.cuh"

namespace {

template <bool kVec4>
__global__ void gather_rows(const float* __restrict__ table,
                            const int64_t* __restrict__ ids, int B,
                            int64_t N, int D, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= B) return;
  const int64_t id = ids[j];
  const bool ok = id >= 0 && id < N;
  if (kVec4) {
    const float4* src = reinterpret_cast<const float4*>(table + id * D);
    float4* dst = reinterpret_cast<float4*>(out + static_cast<int64_t>(j) * D);
    for (int c = lane; c < D / 4; c += 32)
      dst[c] = ok ? src[c] : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    const float* src = table + id * D;
    float* dst = out + static_cast<int64_t>(j) * D;
    for (int d = lane; d < D; d += 32) dst[d] = ok ? src[d] : 0.f;
  }
}

}  // namespace

REPRO_ERROR_STRING(kb_gather)

extern "C" int kb_gather_launch(const float* table, const int64_t* ids,
                                int B, long long N, int D, int vec4,
                                int rows_per_block, float* out,
                                cudaStream_t stream) {
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  const int threads = rows_per_block * 32;
  if (vec4)
    gather_rows<true><<<blocks, threads, 0, stream>>>(table, ids, B, N, D,
                                                      out);
  else
    gather_rows<false><<<blocks, threads, 0, stream>>>(table, ids, B, N, D,
                                                       out);
  return cudaGetLastError();
}
