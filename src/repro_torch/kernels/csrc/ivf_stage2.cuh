// IVF stage 2 on the card: each query's running top-k over the occupied
// rows of its probed buckets in the packed (C * cap, D) layout, with the
// packed ids standing in for the row index. Shared by ivf_stage2.cu (fp32
// snapshot rows), ivf_stage2_q.cu (int8 snapshot rows) and
// ivf_stage2_sharded.cu (the per-shard shortlists of a sharded index).
//
// Replaces: src/repro/kernels/nn_search_ivf.py:186 ivf_stage2_pallas (body
// _ivf_kernel :154), :281 ivf_stage2_quantized_pallas (body
// _ivf_kernel_q :244) and :381 ivf_stage2_sharded_pallas (body
// _ivf_kernel_sharded :344).
//
// What bounds it: bytes. A batch must read each bucket that any of its
// queries probes once: the bucket's occupied rows (4D bytes a row in fp32,
// D + 8 in int8 with the row's scale and offset) and their ids. It computes
// 2 * D operations per (query, probed row): at serving shapes (32 queries,
// 8 probes of 64 buckets over 1,939,743 rows of width 128) that is about a
// GFLOP against up to a GB of fp32 rows, far below the fp32 rate.
//
// Design. The TPU kernel runs one grid row per query and fetches the
// query's probed chunks through a scalar-prefetched BlockSpec, so a bucket
// probed by four queries is fetched four times. Here a bucket is read once
// per tile of 32 queries:
//   1. ivf_partial_topk, grid (slices, buckets, query tiles). A block takes
//      one slice of one bucket's rows. Warp 0 scans the tile's probes to
//      find the queries that probe this bucket, and at which of their probe
//      positions (a query probes each bucket at most once); a block whose
//      bucket no query of its tile probes ends at once. The block then
//      walks its slice in tiles of TR rows, only up to the bucket's
//      occupancy bucket_occ[c] (the packer fills each bucket from its
//      start, so later slots are -1 padding, which never enters a top-k:
//      the same result as ivf_chunk_plan's schedule). A tile is copied to
//      shared memory with cp.async in its own format (int8 codes stay int8
//      there, a quarter of the fp32 tile's bytes, and are converted to
//      float in registers as the product uses them, never dequantized), and
//      each thread scores 4 queries x TR/32 rows with fp32 FMAs in D order,
//      as nn_search.cu does; only the warps that hold a query of this bucket
//      compute. int8 rows are scored
//      scale * (q . c) + sum(q) * offset, each product and the sum rounded
//      on their own. Each query's candidates go through a running top-k
//      list in shared memory (common.cuh), and the block writes the list to
//      the query's slot (query, probe position, slice).
//   2. merge_topk_lists (common.cuh): one block per query merges its
//      nprobe * slices lists.
// Groups (the sharded index): a query's probes may come in `groups` equal
// runs, one per shard, holding GLOBAL bucket ids (the caller adds each
// shard's offset). Step 1 is unchanged; step 2 runs one block per (query,
// group) over the group's nprobe/groups * slices lists, contiguous in the
// [query][probe position][slice][k] partial layout, so each (query,
// group) gets its own top-k, as the Pallas kernel restarts its running
// top-k at each shard's first chunk. One group is the single index.
// Lists are ordered by (score descending, id ascending) and padded with
// (-1e30, INT_MAX), exactly the Pallas _merge_topk's order and padding,
// so a query with fewer than k candidates returns the same padding.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int IVF_QB = 32;        // queries per block
constexpr int IVF_THREADS = 256;  // 8 warps
constexpr int IVF_WARPS = IVF_THREADS / 32;

// Row strides in shared memory. fp32: D + 4 floats, so the 32 rows a warp
// reads at one column fall in 32 distinct banks. int8: D + 16 bytes, which
// keeps rows 16-byte aligned for cp.async, and the 8 rows of a quarter warp
// reading 16 bytes each fall in 8 distinct 16-byte bank groups.
__host__ __device__ constexpr int ivf_row_stride(int D) { return D + 4; }
__host__ __device__ constexpr int ivf_code_stride(int D) { return D + 16; }

// floats of shared memory one tile of rows takes
__host__ __device__ constexpr int ivf_tile_floats(int D, int tile_rows,
                                                  bool int8) {
  return int8 ? tile_rows * ivf_code_stride(D) / 4
              : tile_rows * ivf_row_stride(D);
}

size_t ivf_partial_smem_bytes(int D, int k, int tile_rows, bool int8) {
  const size_t dp = ivf_row_stride(D);
  return sizeof(float) * (IVF_QB * dp + ivf_tile_floats(D, tile_rows, int8) +
                          IVF_QB * tile_rows + IVF_QB + 2 * tile_rows) +
         sizeof(int) * (tile_rows + 2 * IVF_QB) +
         (sizeof(float) + sizeof(int)) * IVF_QB * k;
}

// the four int8 codes of one 32-bit word (lowest address first) as floats,
// exactly
__device__ __forceinline__ float4 ivf_codes_to_float4(int w) {
  const char4 c = *reinterpret_cast<const char4*>(&w);
  return make_float4(c.x, c.y, c.z, c.w);
}

// acc[a][b] += queries a (< na) . rows b over the 4 columns 4cc .. 4cc+3,
// one fp32 FMA per column in column order
template <int RB>
__device__ __forceinline__ void ivf_fma4(float (&acc)[4][RB],
                                         const float4* const (&q4)[4],
                                         int cc, int na,
                                         const float4 (&bv)[RB]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (a < na) {
      const float4 qv = q4[a][cc];
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        float v = acc[a][b];
        v = fmaf(qv.x, bv[b].x, v);
        v = fmaf(qv.y, bv[b].y, v);
        v = fmaf(qv.z, bv[b].z, v);
        v = fmaf(qv.w, bv[b].w, v);
        acc[a][b] = v;
      }
    }
  }
}

template <int TR, bool kInt8>
__global__ void __launch_bounds__(IVF_THREADS)
    ivf_partial_topk(const void* __restrict__ packed,
                     const float* __restrict__ packed_scale,
                     const float* __restrict__ packed_offset,
                     const int* __restrict__ packed_ids,
                     const int* __restrict__ bucket_occ,
                     const float* __restrict__ queries,
                     const int* __restrict__ probes, int B, int nprobe,
                     int D, int k, int64_t cap, int64_t rows_per_slice,
                     float* __restrict__ part_s, int* __restrict__ part_i) {
  constexpr int RB = TR / 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_qn;
  const int DP = ivf_row_stride(D);
  float* qs = smem;                        // [QB][DP]
  float* bs = qs + IVF_QB * DP;            // [TR][DP] f32 or [TR][SB] int8
  float* sc = bs + ivf_tile_floats(D, TR, kInt8);   // [QB][TR]
  float* sumq = sc + IVF_QB * TR;          // [QB]
  float* t_scale = sumq + IVF_QB;          // [TR]
  float* t_off = t_scale + TR;             // [TR]
  int* t_ids = reinterpret_cast<int*>(t_off + TR);   // [TR]
  int* qidx = t_ids + TR;                  // [QB]: query of each slot
  int* qpos = qidx + IVF_QB;               // [QB]: its probe position
  float* ls = reinterpret_cast<float*>(qpos + IVF_QB);   // [QB][k]
  int* li = reinterpret_cast<int*>(ls + IVF_QB * k);     // [QB][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x, c = blockIdx.y, q0 = blockIdx.z * IVF_QB;
  const int slices = gridDim.x;

  if (warp == 0) {
    const int q = q0 + lane;
    int pos = -1;
    if (q < B)
      for (int p = 0; p < nprobe; ++p)
        if (probes[static_cast<int64_t>(q) * nprobe + p] == c) pos = p;
    const unsigned m = __ballot_sync(FULL_MASK, pos >= 0);
    if (pos >= 0) {
      const int at = __popc(m & ((1u << lane) - 1u));
      qidx[at] = q;
      qpos[at] = pos;
    }
    if (lane == 0) s_qn = __popc(m);
  }
  __syncthreads();
  const int qn = s_qn;
  if (qn == 0) return;

  for (int e = tid; e < IVF_QB * k; e += IVF_THREADS) {
    ls[e] = TOPK_NEG;
    li[e] = INT_MAX;
  }
  const int64_t base = static_cast<int64_t>(c) * cap;
  const int64_t r0 = static_cast<int64_t>(slice) * rows_per_slice;
  int64_t r1 = r0 + rows_per_slice;
  const int64_t occ = bucket_occ[c];
  if (r1 > occ) r1 = occ;
  if (r0 < r1) {
    for (int q = warp; q < IVF_QB; q += IVF_WARPS)
      for (int d = lane; d < D; d += 32)
        qs[q * DP + d] =
            q < qn ? queries[static_cast<int64_t>(qidx[q]) * D + d] : 0.f;
    __syncthreads();
    if (kInt8)
      for (int q = warp; q < qn; q += IVF_WARPS) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s = __fadd_rn(s, qs[q * DP + d]);
        s = warp_sum(s);
        if (lane == 0) sumq[q] = s;
      }
    // queries warp + 8a, a < na, are the ones this warp scores
    const int na = warp < qn ? (qn - warp + IVF_WARPS - 1) / IVF_WARPS : 0;
    const int D4 = D / 4;
    for (int64_t t0 = r0; t0 < r1; t0 += TR) {
      const int rows = r1 - t0 < TR ? static_cast<int>(r1 - t0) : TR;
      if (kInt8) {
        const int8_t* src = static_cast<const int8_t*>(packed);
        int8_t* bq = reinterpret_cast<int8_t*>(bs);
        const int D16 = D / 16, SB = ivf_code_stride(D);
        for (int e = tid; e < TR * D16; e += IVF_THREADS) {
          const int r = e / D16, cc = e - r * D16;
          int8_t* dst = bq + r * SB + 16 * cc;
          if (r < rows)
            __pipeline_memcpy_async(dst, src + (base + t0 + r) * D + 16 * cc,
                                    16);
          else
            *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
        }
      } else {
        const float* src = static_cast<const float*>(packed);
        for (int e = tid; e < TR * D4; e += IVF_THREADS) {
          const int r = e / D4, cc = e - r * D4;
          float* dst = bs + r * DP + 4 * cc;
          if (r < rows)
            __pipeline_memcpy_async(dst, src + (base + t0 + r) * D + 4 * cc,
                                    16);
          else
            *reinterpret_cast<float4*>(dst) =
                make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      __pipeline_commit();
      for (int r = tid; r < TR; r += IVF_THREADS) {
        t_ids[r] = r < rows ? packed_ids[base + t0 + r] : -1;
        if (kInt8 && r < rows) {
          t_scale[r] = packed_scale[base + t0 + r];
          t_off[r] = packed_offset[base + t0 + r];
        }
      }
      __pipeline_wait_prior(0);
      __syncthreads();

      if (na > 0) {
        float acc[4][RB];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < RB; ++b) acc[a][b] = 0.f;
        const float4* q4[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          q4[a] = reinterpret_cast<const float4*>(qs + (warp + 8 * a) * DP);
        if (kInt8) {
          const int4* c16[RB];
#pragma unroll
          for (int b = 0; b < RB; ++b)
            c16[b] = reinterpret_cast<const int4*>(
                reinterpret_cast<const int8_t*>(bs) +
                (lane + 32 * b) * ivf_code_stride(D));
          for (int cc = 0; cc < D / 16; ++cc) {
            int4 cv[RB];
#pragma unroll
            for (int b = 0; b < RB; ++b) cv[b] = c16[b][cc];
            float4 bv[RB];
#pragma unroll
            for (int b = 0; b < RB; ++b) bv[b] = ivf_codes_to_float4(cv[b].x);
            ivf_fma4(acc, q4, 4 * cc, na, bv);
#pragma unroll
            for (int b = 0; b < RB; ++b) bv[b] = ivf_codes_to_float4(cv[b].y);
            ivf_fma4(acc, q4, 4 * cc + 1, na, bv);
#pragma unroll
            for (int b = 0; b < RB; ++b) bv[b] = ivf_codes_to_float4(cv[b].z);
            ivf_fma4(acc, q4, 4 * cc + 2, na, bv);
#pragma unroll
            for (int b = 0; b < RB; ++b) bv[b] = ivf_codes_to_float4(cv[b].w);
            ivf_fma4(acc, q4, 4 * cc + 3, na, bv);
          }
        } else {
          const float4* b4[RB];
#pragma unroll
          for (int b = 0; b < RB; ++b)
            b4[b] = reinterpret_cast<const float4*>(bs + (lane + 32 * b) * DP);
          for (int cc = 0; cc < D4; ++cc) {
            float4 bv[RB];
#pragma unroll
            for (int b = 0; b < RB; ++b) bv[b] = b4[b][cc];
            ivf_fma4(acc, q4, cc, na, bv);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (a < na) {
            const int q = warp + 8 * a;
#pragma unroll
            for (int b = 0; b < RB; ++b) {
              const int r = lane + 32 * b;
              float s = acc[a][b];
              if (kInt8 && r < rows)
                s = __fadd_rn(__fmul_rn(s, t_scale[r]),
                              __fmul_rn(sumq[q], t_off[r]));
              sc[q * TR + r] = s;
            }
          }
        }
      }
      __syncthreads();

      for (int q = warp; q < qn; q += IVF_WARPS)
        for (int c0 = 0; c0 < TR; c0 += 32) {
          const int r = c0 + lane;
          const int id = t_ids[r];
          list_offer(ls + q * k, li + q * k, k, sc[q * TR + r], id,
                     r < rows && id >= 0, lane);
        }
      // the next tile's copies overwrite bs and t_ids only after every
      // warp's offers are done
      __syncthreads();
    }
  } else {
    __syncthreads();
  }

  for (int q = warp; q < qn; q += IVF_WARPS) {
    const int64_t o =
        ((static_cast<int64_t>(qidx[q]) * nprobe + qpos[q]) * slices +
         slice) * k;
    for (int j = lane; j < k; j += 32) {
      part_s[o + j] = ls[q * k + j];
      part_i[o + j] = li[q * k + j];
    }
  }
}

template <int TR, bool kInt8>
cudaError_t ivf_launch_partial(dim3 grid, const void* packed,
                               const float* packed_scale,
                               const float* packed_offset,
                               const int* packed_ids, const int* bucket_occ,
                               const float* queries, const int* probes,
                               int B, int nprobe, int D, int k,
                               long long cap, long long rows_per_slice,
                               float* part_s, int* part_i,
                               cudaStream_t stream) {
  const size_t smem = ivf_partial_smem_bytes(D, k, TR, kInt8);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_partial_topk<TR, kInt8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ivf_partial_topk<TR, kInt8><<<grid, IVF_THREADS, smem, stream>>>(
      packed, packed_scale, packed_offset, packed_ids, bucket_occ, queries,
      probes, B, nprobe, D, k, cap, rows_per_slice, part_s, part_i);
  return cudaGetLastError();
}

// Both launches of one stage-2 search. part_s / part_i: (B, nprobe,
// slices, k) scratch; out_s / out_i: (B, groups, k); groups divides
// nprobe.
template <bool kInt8>
cudaError_t ivf_stage2_run(const void* packed, const float* packed_scale,
                           const float* packed_offset, const int* packed_ids,
                           const int* bucket_occ, int C, long long cap,
                           const float* queries, const int* probes, int B,
                           int nprobe, int D, int k, int tile_rows,
                           long long rows_per_slice, int slices,
                           float* part_s, int* part_i, float* out_s,
                           int64_t* out_i, int groups,
                           cudaStream_t stream) {
  if (k < 1 || k > TOPK_KMAX || rows_per_slice % tile_rows || groups < 1 ||
      nprobe % groups)
    return cudaErrorInvalidValue;
  const dim3 grid(slices, C, (B + IVF_QB - 1) / IVF_QB);
  cudaError_t err;
  switch (tile_rows) {
    case 32:
      err = ivf_launch_partial<32, kInt8>(
          grid, packed, packed_scale, packed_offset, packed_ids, bucket_occ,
          queries, probes, B, nprobe, D, k, cap, rows_per_slice, part_s,
          part_i, stream);
      break;
    case 64:
      err = ivf_launch_partial<64, kInt8>(
          grid, packed, packed_scale, packed_offset, packed_ids, bucket_occ,
          queries, probes, B, nprobe, D, k, cap, rows_per_slice, part_s,
          part_i, stream);
      break;
    case 128:
      err = ivf_launch_partial<128, kInt8>(
          grid, packed, packed_scale, packed_offset, packed_ids, bucket_occ,
          queries, probes, B, nprobe, D, k, cap, rows_per_slice, part_s,
          part_i, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const size_t smem = (sizeof(float) + sizeof(int)) * IVF_WARPS * k;
  merge_topk_lists<<<B * groups, IVF_THREADS, smem, stream>>>(
      part_s, part_i, nprobe / groups * slices, k, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace
