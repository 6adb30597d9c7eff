// Exact top-k maximum-inner-product search over the whole bank:
// scores = queries @ bank^T in fp32, then the k best per query, ties to the
// lowest id.
//
// Replaces: src/repro/kernels/nn_search.py:99, nn_search_pallas (with its
// running top-k _merge_topk, nn_search.py:50-69).
//
// What bounds it: bytes, barely. At B = 32 queries over 1,939,743 rows of
// width 128 the search must read the 993 MB bank once (0.30 ms at 3.35 TB/s)
// and do 2*B*N*D = 15.9 GFLOP (0.24 ms at 67 TFLOP/s of fp32 FMA). Both are
// near, so the product must run close to the fp32 rate while the bank
// streams: no TF32, no bf16, no library GEMM (TF32 would move scores by
// ~1e-3 and flip the ids of near ties).
//
// Design, two launches:
//   1. nn_partial_topk: grid (slices, query tiles of 32). A block keeps its
//      32 queries in shared memory and walks its slice of the bank in tiles
//      of TR rows, copied with cp.async (16 bytes a copy, all in flight at
//      once). Each thread scores 4 queries x TR/32 rows with float4 reads
//      along D (row stride D + 4 keeps the reads of a quarter-warp on 32
//      different banks) and fp32 FMAs in D order. Each warp then offers the
//      tile's scores of its queries to a running top-k list per query in
//      shared memory: a ballot finds the candidates that beat the list's
//      last entry (rare once the list is warm), and these go in one at a
//      time, lowest id first. A block writes its k best per query.
//   2. nn_merge_topk: one block per query merges the slices' lists, each
//      warp into a list of its own, then warp 0 merges the eight.
// Lists are ordered by (score descending, id ascending), a strict total
// order on distinct ids, so the result does not depend on the order of
// the merge, and equal scores go to the lowest id as in _merge_topk. A
// list starts filled with (-1e30, INT_MAX), the Pallas kernel's padding.
#include <climits>
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int QB = 32;         // queries per block of pass 1
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int KMAX = 128;      // largest supported k
constexpr float NEG = -1e30f;

__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// Insert (s, id), which beats ls[k-1], into the sorted list of length k.
// Warp-cooperative: every lane of the warp calls it with the same values.
__device__ void list_insert(float* ls, int* li, int k, float s, int id,
                            int lane) {
  int pos = 0;
  for (int p0 = 0; p0 < k; p0 += 32) {
    const int p = p0 + lane;
    pos += __popc(__ballot_sync(FULL_MASK,
                                p < k && better(ls[p], li[p], s, id)));
  }
  float rs[KMAX / 32];
  int ri[KMAX / 32];
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t) {
    const int p = t * 32 + lane;
    if (p >= pos && p < k - 1) {
      rs[t] = ls[p];
      ri[t] = li[p];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KMAX / 32; ++t) {
    const int p = t * 32 + lane;
    if (p >= pos && p < k - 1) {
      ls[p + 1] = rs[t];
      li[p + 1] = ri[t];
    }
  }
  if (lane == 0) {
    ls[pos] = s;
    li[pos] = id;
  }
  __syncwarp();
}

// Each lane offers one candidate; those that beat the list's last entry go
// in, lowest lane first, and the rest are tested again after each insert.
__device__ void list_offer(float* ls, int* li, int k, float s, int id,
                           bool valid, int lane) {
  bool want = valid && better(s, id, ls[k - 1], li[k - 1]);
  unsigned m = __ballot_sync(FULL_MASK, want);
  while (m) {
    const int src = __ffs(m) - 1;
    const float cs = __shfl_sync(FULL_MASK, s, src);
    const int ci = __shfl_sync(FULL_MASK, id, src);
    list_insert(ls, li, k, cs, ci, lane);
    want = want && lane > src && better(s, id, ls[k - 1], li[k - 1]);
    m = __ballot_sync(FULL_MASK, want);
  }
}

__host__ __device__ constexpr int row_stride(int D) { return D + 4; }

size_t partial_smem_bytes(int D, int k, int tile_rows) {
  const size_t dp = row_stride(D);
  return sizeof(float) * (QB * dp + tile_rows * dp + QB * tile_rows) +
         (sizeof(float) + sizeof(int)) * QB * k;
}

template <int TR>
__global__ void __launch_bounds__(THREADS)
    nn_partial_topk(const float* __restrict__ queries,
                    const float* __restrict__ bank, int B, int64_t N, int D,
                    int k, int64_t rows_per_slice, float* __restrict__ part_s,
                    int* __restrict__ part_i) {
  constexpr int RB = TR / 32;
  extern __shared__ __align__(16) float smem[];
  const int DP = row_stride(D);
  float* qs = smem;                 // [QB][DP]
  float* bs = qs + QB * DP;         // [TR][DP]
  float* sc = bs + TR * DP;         // [QB][TR]
  float* ls = sc + QB * TR;         // [QB][k]
  int* li = reinterpret_cast<int*>(ls + QB * k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * QB;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_slice;
  const int64_t r1 = r0 + rows_per_slice < N ? r0 + rows_per_slice : N;

  for (int q = warp; q < QB; q += WARPS)
    for (int d = lane; d < D; d += 32)
      qs[q * DP + d] = q0 + q < B
                           ? queries[static_cast<int64_t>(q0 + q) * D + d]
                           : 0.f;
  for (int e = tid; e < QB * k; e += THREADS) {
    ls[e] = NEG;
    li[e] = INT_MAX;
  }
  __syncthreads();

  const int D4 = D / 4;
  for (int64_t t0 = r0; t0 < r1; t0 += TR) {
    const int rows = r1 - t0 < TR ? static_cast<int>(r1 - t0) : TR;
    for (int e = tid; e < TR * D4; e += THREADS) {
      const int r = e / D4, c = e - r * D4;
      float* dst = bs + r * DP + 4 * c;
      if (r < rows)
        __pipeline_memcpy_async(dst, bank + (t0 + r) * D + 4 * c, 16);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    // thread (warp, lane) scores queries warp + 8a and rows lane + 32b
    float acc[4][RB];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b) acc[a][b] = 0.f;
    const float4* q4[4];
    const float4* b4[RB];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      q4[a] = reinterpret_cast<const float4*>(qs + (warp + 8 * a) * DP);
#pragma unroll
    for (int b = 0; b < RB; ++b)
      b4[b] = reinterpret_cast<const float4*>(bs + (lane + 32 * b) * DP);
    for (int c = 0; c < D4; ++c) {
      float4 qv[4], bv[RB];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = q4[a][c];
#pragma unroll
      for (int b = 0; b < RB; ++b) bv[b] = b4[b][c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          float v = acc[a][b];
          v = fmaf(qv[a].x, bv[b].x, v);
          v = fmaf(qv[a].y, bv[b].y, v);
          v = fmaf(qv[a].z, bv[b].z, v);
          v = fmaf(qv[a].w, bv[b].w, v);
          acc[a][b] = v;
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < RB; ++b)
        sc[(warp + 8 * a) * TR + lane + 32 * b] = acc[a][b];
    __syncthreads();

    // The next tile's copies overwrite bs only after the barrier above,
    // and its scores overwrite sc only after the barrier that follows
    // them, which every warp reaches once its offers below are done.
    for (int q = warp; q < QB && q0 + q < B; q += WARPS)
      for (int c0 = 0; c0 < TR; c0 += 32) {
        const int c = c0 + lane;
        list_offer(ls + q * k, li + q * k, k, sc[q * TR + c],
                   static_cast<int>(t0 + c), c < rows, lane);
      }
  }

  const int64_t slices = gridDim.x;
  for (int q = warp; q < QB && q0 + q < B; q += WARPS)
    for (int j = lane; j < k; j += 32) {
      const int64_t o = ((q0 + q) * slices + blockIdx.x) * k + j;
      part_s[o] = ls[q * k + j];
      part_i[o] = li[q * k + j];
    }
}

__global__ void __launch_bounds__(THREADS)
    nn_merge_topk(const float* __restrict__ part_s,
                  const int* __restrict__ part_i, int slices, int k,
                  float* __restrict__ out_s, int64_t* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* ls = smem;                                      // [WARPS][k]
  int* li = reinterpret_cast<int*>(smem + WARPS * k);    // [WARPS][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < WARPS * k; e += THREADS) {
    ls[e] = NEG;
    li[e] = INT_MAX;
  }
  __syncthreads();
  const int64_t n = static_cast<int64_t>(slices) * k;
  const float* ps = part_s + blockIdx.x * n;
  const int* pi = part_i + blockIdx.x * n;
  for (int64_t c0 = warp * 32; c0 < n; c0 += THREADS) {
    const int64_t c = c0 + lane;
    const bool ok = c < n;
    list_offer(ls + warp * k, li + warp * k, k, ok ? ps[c] : NEG,
               ok ? pi[c] : INT_MAX, ok, lane);
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < WARPS; ++w)
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int c = c0 + lane;
      const bool ok = c < k;
      list_offer(ls, li, k, ok ? ls[w * k + c] : NEG,
                 ok ? li[w * k + c] : INT_MAX, ok, lane);
    }
  for (int j = lane; j < k; j += 32) {
    out_s[static_cast<int64_t>(blockIdx.x) * k + j] = ls[j];
    out_i[static_cast<int64_t>(blockIdx.x) * k + j] = li[j];
  }
}

template <int TR>
cudaError_t plan_partial(long long N, int D, int k, int* slices,
                         long long* rows_per_slice) {
  const size_t smem = partial_smem_bytes(D, k, TR);
  cudaError_t err = cudaFuncSetAttribute(
      nn_partial_topk<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, nn_partial_topk<TR>, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // one wave of blocks for one query tile, each walking an equal run of
  // whole tiles
  const long long tiles = (N + TR - 1) / TR;
  const long long want = static_cast<long long>(per_sm) * sms;
  const long long tiles_per_slice = (tiles + want - 1) / want;
  *rows_per_slice = tiles_per_slice * TR;
  *slices = static_cast<int>((N + *rows_per_slice - 1) / *rows_per_slice);
  return cudaSuccess;
}

template <int TR>
cudaError_t launch_partial(const float* queries, const float* bank, int B,
                           long long N, int D, int k,
                           long long rows_per_slice, int slices,
                           float* part_s, int* part_i, cudaStream_t stream) {
  const size_t smem = partial_smem_bytes(D, k, TR);
  cudaError_t err = cudaFuncSetAttribute(
      nn_partial_topk<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(slices, (B + QB - 1) / QB);
  nn_partial_topk<TR><<<grid, THREADS, smem, stream>>>(
      queries, bank, B, N, D, k, rows_per_slice, part_s, part_i);
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING(nn_search)

// How pass 1 cuts the bank: the number of slices (blocks per query tile)
// and the rows of each; the caller sizes the partial lists from them.
extern "C" int nn_search_plan(long long N, int D, int k, int tile_rows,
                              int* slices, long long* rows_per_slice) {
  switch (tile_rows) {
    case 32: return plan_partial<32>(N, D, k, slices, rows_per_slice);
    case 64: return plan_partial<64>(N, D, k, slices, rows_per_slice);
    case 128: return plan_partial<128>(N, D, k, slices, rows_per_slice);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int nn_search_launch(const float* queries, const float* bank,
                                int B, long long N, int D, int k,
                                int tile_rows, long long rows_per_slice,
                                int slices, float* part_s, int* part_i,
                                float* out_s, int64_t* out_i,
                                cudaStream_t stream) {
  if (k < 1 || k > KMAX) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (tile_rows) {
    case 32:
      err = launch_partial<32>(queries, bank, B, N, D, k, rows_per_slice,
                               slices, part_s, part_i, stream);
      break;
    case 64:
      err = launch_partial<64>(queries, bank, B, N, D, k, rows_per_slice,
                               slices, part_s, part_i, stream);
      break;
    case 128:
      err = launch_partial<128>(queries, bank, B, N, D, k, rows_per_slice,
                                slices, part_s, part_i, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const size_t smem = (sizeof(float) + sizeof(int)) * WARPS * k;
  nn_merge_topk<<<B, THREADS, smem, stream>>>(part_s, part_i, slices, k,
                                              out_s, out_i);
  return cudaGetLastError();
}
