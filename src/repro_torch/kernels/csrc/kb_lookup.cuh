// The one pass behind both fused Knowledge Bank lookups: fp32 rows
// (kb_fused_lookup.cu) and int8 codes with a scale and an offset per row
// (kb_fused_lookup_q.cu). For each requested row: apply its clipped
// pending lazy gradient, write it back (re-quantized, for int8 rows that
// had one), zero its three gradient caches, bump its version where it had
// pending gradients, and return it in every output slot that asked for it.
//
// What bounds it: latency. A serving lookup moves tens of KB (a table or
// code row, a grad_sum row and a few counters per distinct id), which
// HBM's 3.35 TB/s moves in ~10 ns; what a call costs is one launch and the
// chain of dependent memory accesses inside it. So the design counts round
// trips, not bytes:
//   - one launch per call, one warp per output slot. The warp of a row's
//     FIRST occurrence in ids owns it: it computes the row once, writes the
//     bank, its own slot AND every later slot with the same id, then zeroes
//     the caches. Every other warp of that id writes nothing, so no two
//     warps write one slot or one row and the result does not depend on
//     block order. Ids outside [0, N) (the Pallas kernel's -1 padding)
//     read zeros and change nothing;
//   - as soon as a warp knows its id it issues every load the row needs at
//     once (the row, its grad_sum row, grad_cnt, grad_sqnorm and, for int8,
//     scale and offset), before it knows whether it owns the row: a warp
//     that does not drops them. Meanwhile the block stages the batch's ids
//     in shared memory (where they fit), and the dedupe scans read them
//     there. About two round trips to memory: the ids, then the row;
//   - the version bump is one fire-and-forget add by the owner's lane 0
//     (the caller's eager bump queued ~10 kernels and a host sync around
//     each lookup);
//   - 16-byte accesses (a float4 of table, grad_sum and output, four codes)
//     where D % 4 == 0 and the base addresses allow it, 4 bytes otherwise.
// Each lane keeps the entries it loaded in its own slots of a per-warp
// shared tile (the averaged gradient and the row's current value), so no
// barrier is needed after the ids' one.
//
// Arithmetic: every float operation is rounded on its own (no FMA
// contraction) and divisions and the square root are IEEE, so each row
// repeats the plain version's arithmetic step by step; only the sum of
// squares runs in another order. int8 rows are coded again as
// offset = (hi + lo) / 2, scale = (hi - lo) / 254 (1 where that is not
// > 0), code = clip(rint((v - offset) / scale), -127, 127), rint rounding
// half to even as jnp.round does.
#pragma once

#include "common.cuh"

namespace kb_lookup {

constexpr int PREFETCH = 4;  // column groups a lane loads before the scan

// W consecutive fp32 columns, held in registers.
template <int W>
struct Cols {
  float x[W];
};

template <int W>
__device__ __forceinline__ Cols<W> load_cols(const float* p) {
  Cols<W> c;
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    c.x[0] = v.x;
    c.x[1] = v.y;
    c.x[2] = v.z;
    c.x[3] = v.w;
  } else {
    c.x[0] = *p;
  }
  return c;
}

template <int W>
__device__ __forceinline__ void store_cols(float* p, const Cols<W>& c) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(c.x[0], c.x[1], c.x[2],
                                                c.x[3]);
  else
    *p = c.x[0];
}

template <int W>
__device__ __forceinline__ void store_zeros(float* p) {
  Cols<W> z;
#pragma unroll
  for (int w = 0; w < W; ++w) z.x[w] = 0.f;
  store_cols<W>(p, z);
}

__device__ __forceinline__ float dequant(int8_t c, float scale, float off) {
  return __fadd_rn(__fmul_rn(static_cast<float>(c), scale), off);
}

// A row as the bank stores it: W fp32 values, or W int8 codes.
template <bool kInt8, int W>
struct Raw {
  float x[W];
};
template <int W>
struct Raw<true, W> {
  int8_t x[W];
};

template <bool kInt8, int W>
__device__ __forceinline__ Raw<kInt8, W> load_raw(const void* row, int col) {
  Raw<kInt8, W> r;
  if constexpr (kInt8) {
    const int8_t* p = static_cast<const int8_t*>(row) + col;
    if constexpr (W == 4) {
      const char4 v = *reinterpret_cast<const char4*>(p);
      r.x[0] = v.x;
      r.x[1] = v.y;
      r.x[2] = v.z;
      r.x[3] = v.w;
    } else {
      r.x[0] = *p;
    }
  } else {
    const Cols<W> c = load_cols<W>(static_cast<const float*>(row) + col);
#pragma unroll
    for (int w = 0; w < W; ++w) r.x[w] = c.x[w];
  }
  return r;
}

// The leaves one lookup reads and writes. Unused pointers are null: codes,
// qscale and qoffset for fp32 rows, table for int8 rows, and version where
// the caller bumps it itself.
struct Bank {
  float* table;         // (N, D) f32
  int8_t* codes;        // (N, D) int8
  float* qscale;        // (N,)
  float* qoffset;       // (N,)
  float* grad_sum;      // (N, D)
  float* grad_cnt;      // (N,)
  float* grad_sqnorm;   // (N,)
  int* version;         // (N,) int32, or null
};

// The prefetched batch of a lane: PREFETCH column groups of W columns, the
// group g = lane + 32 * (t0 + u) covering columns [g W, g W + W).
template <bool kInt8, int W>
struct Batch {
  Raw<kInt8, W> row[PREFETCH];
  Cols<W> grad[PREFETCH];
};

template <bool kInt8, int W>
__device__ __forceinline__ void load_batch(Batch<kInt8, W>& b,
                                           const void* row, const float* gs,
                                           int t0, int groups, int lane) {
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u) {
    const int g = lane + 32 * (t0 + u);
    if (g < groups) {
      b.row[u] = load_raw<kInt8, W>(row, g * W);
      b.grad[u] = load_cols<W>(gs + g * W);
    }
  }
}

// Dynamic shared memory: [warps][2][D] f32 (each warp's averaged gradient
// and row values), then, where stage_ids, the batch's B ids.
template <bool kInt8, int W>
__global__ void fused_lookup(Bank bank, const int64_t* __restrict__ ids,
                             int B, int64_t N, int D, float lazy_lr,
                             float zmax, int stage_ids,
                             float* __restrict__ vals) {
  extern __shared__ __align__(16) float lookup_smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_avg = lookup_smem + static_cast<size_t>(warp) * 2 * D;
  float* s_row = s_avg + D;
  int64_t* s_ids = reinterpret_cast<int64_t*>(
      lookup_smem + static_cast<size_t>(warps) * 2 * D);
  const int groups = D / W;

  const int j = blockIdx.x * warps + warp;
  const bool live = j < B;
  const int64_t id = live ? ids[j] : -1;
  const bool valid = live && id >= 0 && id < N;

  // 1. every load the row needs, at once (dropped below unless this warp
  // owns the row)
  const void* row = nullptr;
  const float* gs = bank.grad_sum + (valid ? id : 0) * D;
  float cnt = 0.f, sqnorm = 0.f, scale = 1.f, off = 0.f;
  Batch<kInt8, W> pre;
  if (valid) {
    if constexpr (kInt8)
      row = bank.codes + id * D;
    else
      row = bank.table + id * D;
    cnt = bank.grad_cnt[id];
    sqnorm = bank.grad_sqnorm[id];
    if constexpr (kInt8) {
      scale = bank.qscale[id];
      off = bank.qoffset[id];
    }
    load_batch<kInt8, W>(pre, row, gs, 0, groups, lane);
  }

  // 2. the batch's ids, staged once per block while those loads fly
  if (stage_ids) {
    for (int t = threadIdx.x; t < B; t += blockDim.x) s_ids[t] = ids[t];
    __syncthreads();
  }
  const int64_t* scan = stage_ids ? s_ids : ids;
  if (!live) return;
  float* out = vals + static_cast<int64_t>(j) * D;
  if (!valid) {
    for (int g = lane; g < groups; g += 32) store_zeros<W>(out + g * W);
    return;
  }

  // 3. the first occurrence owns the row
  bool seen = false;
  for (int i = lane; i < j; i += 32) seen |= scan[i] == id;
  if (__any_sync(FULL_MASK, seen)) return;

  // 4. each lane's row values and averaged gradient into its own slots
  const bool pending = cnt > 0.f;
  const float c = fmaxf(cnt, 1.f);
  float ss = 0.f;
  for (int t0 = 0; t0 * 32 < groups; t0 += PREFETCH) {
    if (t0 > 0) load_batch<kInt8, W>(pre, row, gs, t0, groups, lane);
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int g = lane + 32 * (t0 + u);
      if (g >= groups) continue;
      Cols<W> v, a;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if constexpr (kInt8)
          v.x[w] = dequant(pre.row[u].x[w], scale, off);
        else
          v.x[w] = pre.row[u].x[w];
        a.x[w] = __fdiv_rn(pre.grad[u].x[w], c);
        ss = __fadd_rn(ss, __fmul_rn(a.x[w], a.x[w]));
      }
      store_cols<W>(s_row + g * W, v);
      store_cols<W>(s_avg + g * W, a);
    }
  }

  // 5. the updated row: into the bank, the owner's slot and s_row
  float* gs_w = bank.grad_sum + id * D;
  if (pending) {
    const float clip = clip_scale(__fsqrt_rn(warp_sum(ss)), sqnorm, c, zmax);
    if constexpr (!kInt8) {
      float* trow = bank.table + id * D;
      for (int g = lane; g < groups; g += 32) {
        const Cols<W> r = load_cols<W>(s_row + g * W);
        const Cols<W> a = load_cols<W>(s_avg + g * W);
        Cols<W> v;
#pragma unroll
        for (int w = 0; w < W; ++w)
          v.x[w] = apply_delta(r.x[w], a.x[w], -lazy_lr, clip);
        store_cols<W>(trow + g * W, v);
        store_cols<W>(out + g * W, v);
        store_cols<W>(s_row + g * W, v);
        store_zeros<W>(gs_w + g * W);
      }
    } else {
      float hi = -FLT_MAX, lo = FLT_MAX;
      for (int g = lane; g < groups; g += 32) {
        const Cols<W> r = load_cols<W>(s_row + g * W);
        const Cols<W> a = load_cols<W>(s_avg + g * W);
        Cols<W> x;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          x.x[w] = apply_delta(r.x[w], a.x[w], -lazy_lr, clip);
          hi = fmaxf(hi, x.x[w]);
          lo = fminf(lo, x.x[w]);
        }
        store_cols<W>(s_row + g * W, x);
      }
      hi = warp_max(hi);
      lo = warp_min(lo);
      off = __fmul_rn(0.5f, __fadd_rn(hi, lo));
      scale = __fdiv_rn(__fsub_rn(hi, lo), 254.f);
      if (!(scale > 0.f)) scale = 1.f;
      int8_t* crow = bank.codes + id * D;
      for (int g = lane; g < groups; g += 32) {
        const Cols<W> x = load_cols<W>(s_row + g * W);
        int8_t code[W];
        Cols<W> v;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float q = rintf(__fdiv_rn(__fsub_rn(x.x[w], off), scale));
          code[w] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
          v.x[w] = dequant(code[w], scale, off);
        }
        if constexpr (W == 4)
          *reinterpret_cast<char4*>(crow + g * W) =
              make_char4(code[0], code[1], code[2], code[3]);
        else
          crow[g * W] = code[0];
        store_cols<W>(out + g * W, v);
        store_cols<W>(s_row + g * W, v);
        store_zeros<W>(gs_w + g * W);
      }
      if (lane == 0) {
        bank.qscale[id] = scale;
        bank.qoffset[id] = off;
      }
    }
  } else {
    for (int g = lane; g < groups; g += 32) {
      store_cols<W>(out + g * W, load_cols<W>(s_row + g * W));
      store_zeros<W>(gs_w + g * W);
    }
  }

  // 6. the caches cleared and the version bumped: +1 where the row had
  // pending gradients, once per row however many slots ask for it
  if (lane == 0) {
    if (bank.version != nullptr && pending) atomicAdd(bank.version + id, 1);
    bank.grad_cnt[id] = 0.f;
    bank.grad_sqnorm[id] = 0.f;
  }

  // 7. every later slot with this id gets the same row
  for (int i0 = j + 1; i0 < B; i0 += 32) {
    const int i = i0 + lane;
    unsigned m = __ballot_sync(FULL_MASK, i < B && scan[i] == id);
    while (m) {
      float* dst = vals + static_cast<int64_t>(i0 + __ffs(m) - 1) * D;
      m &= m - 1;
      for (int g = lane; g < groups; g += 32)
        store_cols<W>(dst + g * W, load_cols<W>(s_row + g * W));
    }
  }
}

// Launch the pass: one warp per output slot, rows_per_block warps a block;
// 16-byte accesses where D % 4 == 0 and every row base is aligned for them.
template <bool kInt8>
cudaError_t launch_fused_lookup(const Bank& bank, const int64_t* ids, int B,
                                long long N, int D, float lazy_lr,
                                float zmax, int rows_per_block,
                                int stage_ids, float* vals,
                                cudaStream_t stream) {
  const auto aligned = [](const void* p, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  const bool vec = D % 4 == 0 && aligned(bank.grad_sum, 16) &&
                   aligned(vals, 16) &&
                   (kInt8 ? aligned(bank.codes, 4) : aligned(bank.table, 16));
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  const int threads = rows_per_block * 32;
  const size_t smem = sizeof(float) * 2 * rows_per_block * D +
                      (stage_ids ? sizeof(int64_t) * B : 0);
  auto kernel = vec ? fused_lookup<kInt8, 4> : fused_lookup<kInt8, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(bank, ids, B, N, D, lazy_lr,
                                            zmax, stage_ids, vals);
  return cudaGetLastError();
}

}  // namespace kb_lookup
