// Helpers shared by the port's kernels. Each kernel source is built into a
// shared library of its own with a plain C interface; every launch function
// returns cudaGetLastError() as an int, and <name>_error_string turns that
// code into text for the Python wrapper that raises on it.
#pragma once

#include <cfloat>
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

#define REPRO_ERROR_STRING(name)                                    \
  extern "C" const char* name##_error_string(int code) {            \
    return cudaGetErrorString(static_cast<cudaError_t>(code));      \
  }

// Sum over the warp, returned to every lane. A down-sweep then a broadcast
// of lane 0, so that all lanes hold the same bits (a butterfly would give
// each lane its own summation order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(FULL_MASK, v, off));
  return __shfl_sync(FULL_MASK, v, 0);
}

// Sums of N values a lane over the lanes that differ only in lane bits
// LO .. TOP, scattered over those lanes (the backward kernels' sums over
// rows, columns, channels or a step's quads): each level halves the
// values a lane holds, the lane with the level's bit set keeping the upper
// half; once a lane holds one value the remaining levels add the partner's
// copy. On return v[0 .. max(N LO / (2 TOP), 1) - 1] hold the sums of
// values idx .. of the group, in a fixed order; `writer` is false on every
// lane but one of those that hold the same sums (IEEE addition commutes,
// so the copies agree bit for bit).
template <int N, int TOP, int O, int LO>
__device__ __forceinline__ void reduce_scatter_level(float (&v)[N], int lane,
                                                     int& idx, bool& writer) {
  constexpr int n = N * O / TOP;  // values a lane holds entering the level
  if constexpr (n >= 2) {
    constexpr int half = n / 2;
    const bool up = lane & O;
#pragma unroll
    for (int x = 0; x < half; ++x) {
      const float mine = up ? v[half + x] : v[x];
      const float other = up ? v[x] : v[half + x];
      v[x] = mine + __shfl_xor_sync(FULL_MASK, other, O);
    }
    if (up) idx += half;
  } else {
    v[0] += __shfl_xor_sync(FULL_MASK, v[0], O);
    if (lane & O) writer = false;
  }
  if constexpr (O > LO) reduce_scatter_level<N, TOP, O / 2, LO>(v, lane, idx,
                                                                writer);
}

template <int N, int TOP, int LO>
__device__ __forceinline__ void lane_reduce_scatter(float (&v)[N], int& idx,
                                                    bool& writer) {
  idx = 0;
  writer = true;
  reduce_scatter_level<N, TOP, TOP, LO>(v, threadIdx.x & 31, idx, writer);
}

// A value of the model dtype as fp32
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Max and min over the warp, returned to every lane (exact in any order).
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// The clip of knowledge_bank.pending_delta for one row, given the sum of
// the squared entries of its averaged gradient and its clamped count:
//   scale = min(1, zmax * max(rms, 1e-12) / max(norm, 1e-12)).
// Every operation is rounded on its own (no fused multiply-add), as the
// PyTorch and JAX references compute it.
__device__ __forceinline__ float clip_scale(float norm, float sqnorm_sum,
                                            float cnt, float zmax) {
  const float rms = __fsqrt_rn(__fdiv_rn(sqnorm_sum, cnt));
  const float cap = __fmul_rn(zmax, fmaxf(rms, 1e-12f));
  return fminf(1.f, __fdiv_rn(cap, fmaxf(norm, 1e-12f)));
}

// One row's update, table + (-lr * avg) * scale, rounded step by step.
__device__ __forceinline__ float apply_delta(float t, float avg, float neg_lr,
                                             float scale) {
  return __fadd_rn(t, __fmul_rn(__fmul_rn(neg_lr, avg), scale));
}

// ---------------------------------------------------------------------------
// Running top-k lists in shared memory, shared by the search kernels
// (nn_search.cu, ivf_stage2.cuh). A list holds k (score, id) entries sorted
// by (score descending, id ascending), the order of the Pallas kernels'
// _merge_topk (src/repro/kernels/nn_search.py:50): a strict total order on
// distinct ids, so the result does not depend on the order in which
// candidates arrive, and equal scores go to the lowest id. A list starts
// filled with (TOPK_NEG, INT_MAX), the Pallas kernels' padding.
// ---------------------------------------------------------------------------

constexpr int TOPK_KMAX = 128;     // largest k the lists support
constexpr float TOPK_NEG = -1e30f;

namespace {

__device__ __forceinline__ bool topk_better(float s1, int i1, float s2,
                                            int i2) {
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
                                p < k && topk_better(ls[p], li[p], s, id)));
  }
  float rs[TOPK_KMAX / 32];
  int ri[TOPK_KMAX / 32];
#pragma unroll
  for (int t = 0; t < TOPK_KMAX / 32; ++t) {
    const int p = t * 32 + lane;
    if (p >= pos && p < k - 1) {
      rs[t] = ls[p];
      ri[t] = li[p];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < TOPK_KMAX / 32; ++t) {
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
  bool want = valid && topk_better(s, id, ls[k - 1], li[k - 1]);
  unsigned m = __ballot_sync(FULL_MASK, want);
  while (m) {
    const int src = __ffs(m) - 1;
    const float cs = __shfl_sync(FULL_MASK, s, src);
    const int ci = __shfl_sync(FULL_MASK, id, src);
    list_insert(ls, li, k, cs, ci, lane);
    want = want && lane > src && topk_better(s, id, ls[k - 1], li[k - 1]);
    m = __ballot_sync(FULL_MASK, want);
  }
}

// One block per query: merge the query's `lists` partial lists of k
// entries each (part_s/part_i at [query][list][k]) into its k best. Each
// warp merges a share into a list of its own, then warp 0 merges the
// warps' lists. Dynamic shared memory: (4 + 4) * warps * k bytes.
__global__ void merge_topk_lists(const float* __restrict__ part_s,
                                 const int* __restrict__ part_i, int lists,
                                 int k, float* __restrict__ out_s,
                                 int64_t* __restrict__ out_i) {
  extern __shared__ __align__(16) float merge_smem[];
  const int warps = blockDim.x >> 5;
  float* ls = merge_smem;                                     // [warps][k]
  int* li = reinterpret_cast<int*>(merge_smem + warps * k);   // [warps][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < warps * k; e += blockDim.x) {
    ls[e] = TOPK_NEG;
    li[e] = INT_MAX;
  }
  __syncthreads();
  const int64_t n = static_cast<int64_t>(lists) * k;
  const float* ps = part_s + blockIdx.x * n;
  const int* pi = part_i + blockIdx.x * n;
  for (int64_t c0 = warp * 32; c0 < n; c0 += blockDim.x) {
    const int64_t c = c0 + lane;
    const bool ok = c < n;
    list_offer(ls + warp * k, li + warp * k, k, ok ? ps[c] : TOPK_NEG,
               ok ? pi[c] : INT_MAX, ok, lane);
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < warps; ++w)
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int c = c0 + lane;
      const bool ok = c < k;
      list_offer(ls, li, k, ok ? ls[w * k + c] : TOPK_NEG,
                 ok ? li[w * k + c] : INT_MAX, ok, lane);
    }
  for (int j = lane; j < k; j += 32) {
    out_s[static_cast<int64_t>(blockIdx.x) * k + j] = ls[j];
    out_i[static_cast<int64_t>(blockIdx.x) * k + j] = li[j];
  }
}

}  // namespace
