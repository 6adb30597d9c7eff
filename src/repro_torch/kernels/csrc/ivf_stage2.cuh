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
// What bounds it on the H100. A batch must read each bucket that any of
// its queries probes once: the occupied rows and their ids (and, in int8,
// the rows' scales and offsets). At the serve shapes (32 queries, 8 probes
// of 64 buckets over 1,939,743 rows of width 128: ~61 buckets probed, ~4
// queries a bucket) that is ~0.95 GB of fp32 rows (0.28 ms at 3.35 TB/s)
// or ~0.26 GB of int8 rows (0.08 ms), and 2 * D operations per (query,
// probed row), ~2 GFLOP (0.03 ms at the fp32 rate). fp32 is bound by
// bytes. int8 reads a quarter of the bytes for the same FMAs, so the work
// per byte sets its pace: the FMAs and code conversions, reading queries
// and rows from shared memory (128 bytes a clock an SM, broadcast or not,
// against 128 FMAs, so a float read must feed several FMAs), and keeping
// the top-k lists (a serial warp insert each, and block barriers).
//
// Design, three launches:
//   1. ivf_plan_items, one block: counts the queries of each (query tile
//      of 32, bucket) pair, weighs each probed pair by its rows times the
//      query chunks (below) it takes, and cuts the pairs into items of
//      whole tiles of about equal weight, the smallest size that keeps all
//      items within one wave of the resident blocks. A bucket probed by
//      5-8 queries costs twice a row of one probed by 4, so a plan by rows
//      alone left the longest block at twice the mean.
//   2. ivf_partial_topk, persistent: two blocks an SM take items from a
//      counter. For its item a block finds the tile's queries that probe
//      the bucket (the last probe position, if one lists it twice), loads
//      them transposed, [d][32] (where 32 queries of width D fit beside
//      two stages; at a wider D the streamed instance, kSQ, loads instead
//      the tile's 32 queries' DC dims of each stage by a second TMA box
//      beside the rows, [32][DC], 2 KB fp32 or 4 KB int8, and a warp reads
//      its chunk's 4 queries there by their row in the tile, one float4
//      of 4 dims each: the same FMAs in the same order, and no shared
//      memory that grows with D), and streams the item's rows through a
//      ring of 2-4 stages of 32 KB: thread 0 issues TMA loads of a 2-d
//      tensor map over the packed rows, stages - 1 ahead, on full
//      mbarriers, and refills a stage once every warp has released it on
//      its empty mbarrier. A stage is a tile of rows x DC dims in the rows'
//      own format (fp32: 16 dims, 64 bytes a row, 64-byte swizzle; int8:
//      32 dims, 32 bytes a row, 32-byte swizzle: the 8 rows a quarter-warp
//      reads sit in 8 distinct 16-byte bank groups); the tile's ids (and
//      scales and offsets) come by 1-d bulk copies with its last stage, so
//      no global load sits in the loop. Every warp scores a box of 32 RB
//      rows (RB = 2 fp32, 4 int8) for a chunk of 4 queries: a lane holds
//      4 x RB sums in registers and reads per dim one float4 of the
//      chunk's queries and its rows' values. A bucket with at most 4 of the
//      tile's queries gives all 8 warps one chunk and a tile of 8 boxes;
//      with more, the warps split into ceil(qn / 4) groups (rounded up to a
//      power of two) over tiles of fewer boxes, so every qn from 1 to 32
//      runs in one pass over the rows. int8 codes are converted to floats
//      (I2F, exact for -128 .. 127) in registers once per block and query
//      chunk, not once per query. Each (query, row) sum runs in D order
//      with fp32 FMAs, so a pair's score does not depend on the plan and a
//      repeated run is bit-identical; int8 rows score
//      scale * (q . c) + sum(q) * offset, each product and the sum rounded
//      on their own. After a tile's last stage each (score, id) meets its
//      query's bar in registers, in the lists' own order: the list's k-th,
//      or the (query, shard) bound shared across items in global memory
//      (every full list's k-th as one 64-bit key, the score's ordered bits
//      over the inverted id, raised by a 64-bit atomic max; a bound a tile
//      old is still one), whichever is better. Only a pair that beats it
//      can enter the final top-k, so a tie on the score passes only with a
//      lower id: a zero query, which a padded batch holds, scores every
//      row 0 and lets through only ids below its k-th's. What passes goes
//      into a per-query buffer of 32 in shared memory, which the query's
//      owner warp merges into the query's list: sorted across the warp,
//      then each entry moved once to its rank (ivf_list_merge);
//      candidates that found a full buffer try again in another round. The
//      block writes its k best per query to the slot (query, probe
//      position, slice).
//   3. ivf_merge: one block per (query, group) merges the slots that an
//      item wrote: probe positions holding a bucket in [0, C) that the
//      query does not list again later, and the slices the plan made of
//      it. Nothing else is read, so the partial buffers need no padding.
//      Each warp merges a share of the lists into its own, reading a list
//      only while its entries can still enter; warp 0 then merges the 8.
// Groups (the sharded index): a query's probes may come in `groups` equal
// runs, one per shard, holding GLOBAL bucket ids (the caller adds each
// shard's offset). Steps 1 and 2 are unchanged but for one shared bound
// per (query, shard); step 3 runs one block per (query, group) over the
// group's probe positions, so each (query, group) gets its own top-k, as
// the Pallas kernel restarts its running top-k at each shard's first
// chunk. One group is the single index.
// Lists are ordered by (score descending, id ascending) and padded with
// (-1e30, INT_MAX), exactly the Pallas _merge_topk's order and padding,
// so a query with fewer than k candidates returns the same padding, and
// the result does not depend on the order in which candidates arrive.
//
// Measured on the H100 (PERF.md §6), each in an A/B of one call: one
// block an SM with 4 stages took 1.4-1.6x the time of two with 2; fp32
// stages of 8 dims (16 KB, twice the stages) 1.5x; per-warp lists without
// block barriers 3.7x in int8 (candidates x7.4); specialising the FMAs on
// a chunk's real queries 1.2x; the empty barriers, in place of a block
// barrier a stage, left the time as it was. I2F took 0.98x of an exact
// integer-pipe conversion (c ^ 0x80 into the low byte of 2^23 by PRMT,
// less 2^23 + 128 by FADD). A filter on the score alone (s >= the k-th)
// took a padded batch of B 8 or 16 with 4 zero queries 2.4-5.5x as long as
// the filter in the lists' order (every row of the buckets they probe was a
// candidate); a bound from the first tile's 8-row group maxima, since
// removed, halved the candidates on real queries for 3-6% of the time. The
// optional profile (ivf_stage2_cycles) puts int8's warp time in the FMAs,
// the candidate rounds' filter and barriers, and the data waits.
#pragma once

#include <cuda_pipeline.h>

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int IVF_QB = 32;          // queries per block
constexpr int IVF_THREADS = 256;    // 8 warps
constexpr int IVF_WARPS = IVF_THREADS / 32;
constexpr int IVF_QA = 4;           // queries per register tile
constexpr int IVF_CAND = 32;        // candidate slots per query and round
constexpr int IVF_MAX_STAGES = 4;
#define IVF_NEG_INF __int_as_float(0xff800000)

// Slots of the optional profile (ivf_stage2_cycles): cycles summed over
// every warp of the blocks that have rows to score, read on lane 0's clock
// (setting up the queries and lists, waiting for a stage, the FMAs, a
// tile's scores, the candidate rounds' filter and barriers, the list
// inserts, releasing a stage, writing the lists), then counts (candidate
// rounds, candidates buffered, working blocks, stages consumed).
// The last four: the first start and last end of the partial pass's and
// the merge's blocks on the global timer (ns), the two launches' windows.
enum IvfProfSlot {
  IVF_P_SETUP, IVF_P_DATA, IVF_P_FMA, IVF_P_SCORE, IVF_P_FILTER, IVF_P_OFFER,
  IVF_P_SYNC, IVF_P_WRITE, IVF_P_TIMED, IVF_P_ROUNDS = IVF_P_TIMED,
  IVF_P_CANDIDATES,
  IVF_P_BLOCKS, IVF_P_STAGES, IVF_P_PARTIAL_T0, IVF_P_PARTIAL_T1,
  IVF_P_MERGE_T0, IVF_P_MERGE_T1, IVF_P_SLOTS
};

__device__ __forceinline__ unsigned long long ivf_now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Merge the warp's candidates, one a lane (only those with `valid`; no NaN
// score, no id INT_MAX), into the sorted list ls/li of k entries: the k
// best of both, in (score descending, id ascending) order. The candidates
// are sorted across the lanes (bitonic); each then counts the list entries
// ahead of it by a binary search in shared memory, and each list entry the
// candidates ahead of it by a search over the lanes, so every entry moves
// once to its rank. A call costs about two inserts of list_offer
// (common.cuh), however many candidates enter.
__device__ void ivf_list_merge(float* ls, int* li, int k, float s, int id,
                               bool valid, int lane) {
  if (!valid) {
    s = IVF_NEG_INF;          // behind every list entry, padding included
    id = INT_MAX;
  }
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float os = __shfl_xor_sync(FULL_MASK, s, stride);
      const int oi = __shfl_xor_sync(FULL_MASK, id, stride);
      const bool first = ((lane & size) == 0) == ((lane & stride) == 0);
      if (first ? topk_better(os, oi, s, id) : topk_better(s, id, os, oi)) {
        s = os;
        id = oi;
      }
    }
  int ahead = 0;              // list entries ahead of this candidate
  for (int step = TOPK_KMAX; step > 0; step >>= 1)
    if (ahead + step <= k &&
        topk_better(ls[ahead + step - 1], li[ahead + step - 1], s, id))
      ahead += step;
  float ks[TOPK_KMAX / 32];
  int ki[TOPK_KMAX / 32], kpos[TOPK_KMAX / 32];
#pragma unroll
  for (int t = 0; t < TOPK_KMAX / 32; ++t) {
    const int j = lane + 32 * t;
    ks[t] = j < k ? ls[j] : IVF_NEG_INF;
    ki[t] = j < k ? li[j] : INT_MAX;
    int n = 0;                // candidates ahead of list entry j
#pragma unroll
    for (int step = 32; step > 0; step >>= 1) {
      const int at = n + step - 1 < 31 ? n + step - 1 : 31;
      const float cs = __shfl_sync(FULL_MASK, s, at);
      const int cid = __shfl_sync(FULL_MASK, id, at);
      if (n + step <= 32 && topk_better(cs, cid, ks[t], ki[t])) n += step;
    }
    kpos[t] = j + n;
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < TOPK_KMAX / 32; ++t)
    if (lane + 32 * t < k && kpos[t] < k) {
      ls[kpos[t]] = ks[t];
      li[kpos[t]] = ki[t];
    }
  if (lane + ahead < k) {
    ls[lane + ahead] = s;
    li[lane + ahead] = id;
  }
  __syncwarp();
}

// A stage: TRMAX rows x DC dims, ROWB bytes a row (32 int8 codes, 16 fp32
// dims); a warp's box: BOXR rows.
template <bool kInt8>
struct IvfGeom {
  static constexpr int RB = kInt8 ? 4 : 2;        // rows per lane
  static constexpr int DC = kInt8 ? 32 : 16;      // dims per stage
  static constexpr int ROWB = kInt8 ? 32 : 64;
  static constexpr int BOXR = 32 * RB;
  static constexpr int BOXB = BOXR * ROWB;        // 4 KB
  static constexpr int TRMAX = IVF_WARPS * BOXR;  // 1024 int8, 512 fp32
  static constexpr int STAGE = TRMAX * ROWB;      // 32 KB
  static constexpr int QS = IVF_QB * DC * 4;      // streamed queries' slice
  static constexpr int SIDEB = kInt8 ? 12 : 4;    // id (+ scale, offset)
};

// tiles' side buffers (ids, scales, offsets) the block keeps at once: a
// tile's arrive with its last stage and are read before that stage is
// given back, so ceil(stages / chunks) tiles can hold them
__host__ __device__ constexpr int ivf_side_slots(int D, int DC, int stages) {
  return (stages + (D + DC - 1) / DC - 1) / ((D + DC - 1) / DC);
}

// bytes of dynamic shared memory (the wrapper's smem_bytes mirrors this):
// room to align the ring, the ring (with the queries' slices, streamed),
// the side buffers, the transposed queries (resident), their sums, the
// candidate counts and buffers, and the lists
template <bool kInt8>
size_t ivf_smem_bytes(int D, int k, int stages, bool streamed) {
  using G = IvfGeom<kInt8>;
  return 1024 +
         static_cast<size_t>(stages) * (G::STAGE + (streamed ? G::QS : 0)) +
         static_cast<size_t>(ivf_side_slots(D, G::DC, stages)) * G::TRMAX *
             G::SIDEB +
         (streamed ? 0 : static_cast<size_t>(D) * IVF_QB * 4) +
         2 * IVF_QB * 4 + 8 * IVF_QB * IVF_CAND +
         8 * static_cast<size_t>(IVF_QB) * k;
}

// The chunk's 4 queries at one dim: component e of the streamed float4s,
// or the float4 at `at` of the transposed queries qt.
template <bool kSQ>
__device__ __forceinline__ void ivf_chunk_queries(float (&qa)[IVF_QA],
                                                  const float4* qs,
                                                  const float* qt, int at,
                                                  int e) {
  if constexpr (kSQ) {
#pragma unroll
    for (int a = 0; a < IVF_QA; ++a)
      qa[a] = e == 0 ? qs[a].x : e == 1 ? qs[a].y : e == 2 ? qs[a].z
                                                           : qs[a].w;
  } else {
    const float4 q = *reinterpret_cast<const float4*>(qt + at);
    qa[0] = q.x;
    qa[1] = q.y;
    qa[2] = q.z;
    qa[3] = q.w;
  }
}

// acc[a][j] += query a of chunk qc . row j of this lane, over the DC dims
// from d0 of one stage: rows lane + 32 j of the warp's box, 16-byte chunk
// c of a row stored at chunk c ^ swizzle (the row bits that the 32- or
// 64-byte swizzle mixes in). int8: each code converted to a float (I2F,
// exact) once for the chunk's 4 queries. Streamed (kSQ): qt is the
// stage's [32][DC] query slice and col the chunk's 4 queries' rows in it;
// each query's 4 dims come as one float4, and the FMAs run in the same
// order.
template <bool kInt8, bool kSQ>
__device__ __forceinline__ void ivf_stage_fma(
    float (&acc)[IVF_QA][IvfGeom<kInt8>::RB], const uint8_t* box,
    const float* qt, const int (&col)[IVF_QA], int qc, int d0, int D,
    int lane) {
  using G = IvfGeom<kInt8>;
  constexpr int RB = G::RB;
  if constexpr (kInt8) {
    const int swz = (lane >> 2) & 1;     // address bit 7: row bit 2
#pragma unroll
    for (int h = 0; h < 2; ++h) {        // 16 codes a lane reads at once
      const int d16 = d0 + 16 * h;
      if (d16 < D) {
        int4 w[RB];
#pragma unroll
        for (int j = 0; j < RB; ++j)
          w[j] = *reinterpret_cast<const int4*>(
              box + (lane + 32 * j) * G::ROWB + ((h ^ swz) << 4));
#pragma unroll
        for (int wd = 0; wd < 4; ++wd) {
          float4 qs[kSQ ? IVF_QA : 1];   // streamed: query a's 4 dims
          if constexpr (kSQ) {
#pragma unroll
            for (int a = 0; a < IVF_QA; ++a)
              qs[a] = *reinterpret_cast<const float4*>(
                  qt + col[a] * G::DC + 16 * h + 4 * wd);
          }
          float f[RB][4];
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            const int word = wd == 0 ? w[j].x : wd == 1 ? w[j].y
                           : wd == 2 ? w[j].z : w[j].w;
            const char4 c = *reinterpret_cast<const char4*>(&word);
            f[j][0] = c.x;
            f[j][1] = c.y;
            f[j][2] = c.z;
            f[j][3] = c.w;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float qa[IVF_QA];
            ivf_chunk_queries<kSQ>(
                qa, qs, qt, (d16 + 4 * wd + e) * IVF_QB + IVF_QA * qc, e);
#pragma unroll
            for (int a = 0; a < IVF_QA; ++a)
#pragma unroll
              for (int j = 0; j < RB; ++j)
                acc[a][j] = fmaf(qa[a], f[j][e], acc[a][j]);
          }
        }
      }
    }
  } else {
    const int swz = (lane >> 1) & 3;     // address bits 7-8: row bits 1-2
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      const int d4 = d0 + 4 * c4;
      if (d4 < D) {
        float4 x[RB];
#pragma unroll
        for (int j = 0; j < RB; ++j)
          x[j] = *reinterpret_cast<const float4*>(
              box + (lane + 32 * j) * G::ROWB + ((c4 ^ swz) << 4));
        float4 qs[kSQ ? IVF_QA : 1];     // streamed: query a's 4 dims
        if constexpr (kSQ) {
#pragma unroll
          for (int a = 0; a < IVF_QA; ++a)
            qs[a] = *reinterpret_cast<const float4*>(qt + col[a] * G::DC +
                                                     4 * c4);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float qa[IVF_QA];
          ivf_chunk_queries<kSQ>(qa, qs, qt, (d4 + e) * IVF_QB + IVF_QA * qc,
                                 e);
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            const float v = e == 0 ? x[j].x : e == 1 ? x[j].y
                          : e == 2 ? x[j].z : x[j].w;
#pragma unroll
            for (int a = 0; a < IVF_QA; ++a)
              acc[a][j] = fmaf(qa[a], v, acc[a][j]);
          }
        }
      }
    }
  }
}

// Query chunks a bucket's qn queries of one tile take, rounded up to a
// power of two: the warps split into that many groups, each over its own
// box of fewer rows, so a row costs that many times the work of a row of a
// bucket with at most 4 queries.
__host__ __device__ constexpr int ivf_groups(int qn) {
  return qn <= IVF_QA ? 1 : qn <= 2 * IVF_QA ? 2 : qn <= 4 * IVF_QA ? 4 : 8;
}

// Slices of a bucket of `occ` rows whose weighted rows are `wr`, for items
// of about `unit` weighted rows: whole tiles a slice, ceil(occ / P) of P.
// (Plain float and 32-bit arithmetic: a plan only has to be the same in
// both of its passes, not exact.)
__device__ __forceinline__ int ivf_slices(int occ, float wr, float unit,
                                          int tile, int* rows) {
  const float f = ceilf(wr / unit);
  int ns = f < static_cast<float>(occ) ? static_cast<int>(f) : occ;
  if (ns < 1) ns = 1;
  int P = (occ + ns - 1) / ns;
  P = (P + tile - 1) / tile * tile;
  *rows = P;
  return (occ + P - 1) / P;
}

// (score, id) as one key that orders as the lists do: the score's bits
// made to order as unsigned ints (-0 taken as +0, as topk_better does)
// over INT_MAX - id, so an equal score with a lower id is the larger key.
// For a non-NaN score and 0 <= id <= INT_MAX.
__device__ __forceinline__ unsigned long long ivf_key(float s, int id) {
  const unsigned u = __float_as_uint(s + 0.f);
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) |
         static_cast<unsigned>(INT_MAX - id);
}

// the (score, id) of an ivf_key
__device__ __forceinline__ void ivf_unkey(unsigned long long key, float* s,
                                          int* id) {
  const unsigned o = static_cast<unsigned>(key >> 32);
  *s = __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
  *id = INT_MAX - static_cast<int>(static_cast<unsigned>(key));
}

constexpr int IVF_PLAN_UNITS = 17;   // item sizes the plan tries

// The plan, one block: the queries of each (query tile z, bucket c) (a
// query listing a bucket twice counts once), and the items the partial
// pass walks. A probed, occupied pair's weight is its rows times
// ivf_groups(qn), what a block spends on it; the pair is cut into slices
// of P rows (whole tiles) of about `unit` weighted rows each, with unit
// the smallest of W / resident x (1, 9/8, ..., 3) (W: all pairs' weight)
// that keeps the items within the `resident` blocks, so every block takes
// one item of about the same work; where none does, one item a pair.
// Writes nsl[z * C + c] (0 for a pair with no item), the items (z, c,
// slice, P), counters[0] (their number) and counters[1] (0: the partial
// pass's next item), and sets the B * groups shared bounds to the key of
// an empty list's k-th, the padding (TOPK_NEG, INT_MAX).
// qcount: qtiles * C ints of scratch.
__global__ void __launch_bounds__(1024)
    ivf_plan_items(const int* __restrict__ probes,
                   const int* __restrict__ bucket_occ, int B, int nprobe,
                   int C, int64_t cap, int groups, int resident, int tile,
                   int* __restrict__ qcount, int* __restrict__ nsl,
                   int4* __restrict__ items, int* __restrict__ counters,
                   unsigned long long* __restrict__ bound) {
  __shared__ unsigned long long s_w;
  __shared__ int s_n[IVF_PLAN_UNITS], s_items;
  const int tid = threadIdx.x;
  const int pairs = (B + IVF_QB - 1) / IVF_QB * C;
  for (int e = tid; e < pairs; e += blockDim.x) qcount[e] = 0;
  for (int e = tid; e < B * groups; e += blockDim.x)
    bound[e] = ivf_key(TOPK_NEG, INT_MAX);
  if (tid < IVF_PLAN_UNITS) s_n[tid] = 0;
  if (tid == 0) {
    s_w = 0;
    s_items = 0;
  }
  __syncthreads();
  for (int64_t e = tid; e < static_cast<int64_t>(B) * nprobe;
       e += blockDim.x) {
    const int b = static_cast<int>(e / nprobe);
    const int p = static_cast<int>(e % nprobe);
    const int c = probes[e];
    if (c < 0 || c >= C) continue;
    bool later = false;
    for (int p2 = p + 1; p2 < nprobe && !later; ++p2)
      later = probes[static_cast<int64_t>(b) * nprobe + p2] == c;
    if (!later) atomicAdd(&qcount[(b / IVF_QB) * C + c], 1);
  }
  __syncthreads();
  auto weight = [&](int e, int* occ) {   // 0: no item
    const int64_t o = bucket_occ[e % C];
    *occ = static_cast<int>(o < cap ? o : cap);
    return qcount[e] > 0 && *occ > 0
               ? static_cast<long long>(*occ) * ivf_groups(qcount[e])
               : 0ll;
  };
  unsigned long long w = 0;
  for (int e = tid; e < pairs; e += blockDim.x) {
    int occ;
    w += static_cast<unsigned long long>(weight(e, &occ));
  }
  atomicAdd(&s_w, w);
  __syncthreads();
  const float base = static_cast<float>(s_w) / resident;
  for (int e = tid; e < pairs * IVF_PLAN_UNITS; e += blockDim.x) {
    int occ, P;
    const int u = e % IVF_PLAN_UNITS;
    const float wr = static_cast<float>(weight(e / IVF_PLAN_UNITS, &occ));
    if (wr > 0.f)
      atomicAdd(&s_n[u], ivf_slices(occ, wr, base * (8 + u) / 8, tile, &P));
  }
  __syncthreads();
  float unit = __int_as_float(0x7f800000);   // +inf: one item a pair
  for (int u = IVF_PLAN_UNITS - 1; u >= 0; --u)
    if (s_n[u] <= resident) unit = base * (8 + u) / 8;
  for (int e = tid; e < pairs; e += blockDim.x) {
    int occ, P;
    const float wr = static_cast<float>(weight(e, &occ));
    if (wr == 0.f) {
      nsl[e] = 0;
      continue;
    }
    const int ns = ivf_slices(occ, wr, unit, tile, &P);
    nsl[e] = ns;
    const int at = atomicAdd(&s_items, ns);
    for (int sl = 0; sl < ns; ++sl)
      items[at + sl] = make_int4(e / C, e % C, sl, P);
  }
  __syncthreads();
  if (tid == 0) {
    counters[0] = s_items;
    counters[1] = 0;
  }
}

// The partial pass: persistent blocks take the plan's items, one at a time,
// from counters[1]; an item (z, c, slice, P) is rows [slice P, slice P + P)
// of bucket c, up to its occupancy, for the queries of tile z that probe c.
// bound[query * groups + group]: the key (ivf_key) of the best k-th of
// any list of that (query, group) so far, which no (score, id) of a lower
// key can beat in the final top-k; each tile's filter starts from it, and
// each full list raises it.
template <bool kInt8, bool kProf, bool kSQ>
__global__ void __launch_bounds__(IVF_THREADS, 2)
    ivf_partial_topk(const __grid_constant__ CUtensorMap tm_rows,
                     const __grid_constant__ CUtensorMap tm_q,
                     const float* __restrict__ packed_scale,
                     const float* __restrict__ packed_offset,
                     const int* __restrict__ packed_ids,
                     const int* __restrict__ bucket_occ,
                     const float* __restrict__ queries,
                     const int* __restrict__ probes, int B, int nprobe,
                     int D, int k, int stages, int64_t cap, int slices,
                     int groups, const int4* __restrict__ items,
                     int* __restrict__ counters,
                     unsigned long long* __restrict__ bound,
                     float* __restrict__ part_s,
                     int* __restrict__ part_i,
                     unsigned long long* __restrict__ prof) {
  using G = IvfGeom<kInt8>;
  constexpr int RB = G::RB;
  constexpr int STAGEB = G::STAGE + (kSQ ? G::QS : 0);   // a stage's bytes
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[IVF_MAX_STAGES], empty[IVF_MAX_STAGES];
  __shared__ int qidx[IVF_QB], qpos[IVF_QB];   // query, probe position
  __shared__ int qbound[IVF_QB];               // its entry of bound
  __shared__ int s_qn, s_item;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (kProf && tid == 0) atomicMin(&prof[IVF_P_PARTIAL_T0], ivf_now_ns());
  const int chunks = (D + G::DC - 1) / G::DC;
  const int sides = ivf_side_slots(D, G::DC, stages);
  const int n_items = counters[0];

  // the ring starts on a 1024-byte boundary, a multiple of both swizzles'
  // periods
  uint8_t* const ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  int* const side_id = reinterpret_cast<int*>(ring + stages * STAGEB);
  float* const side_sc = reinterpret_cast<float*>(side_id + sides * G::TRMAX);
  float* const side_of = side_sc + (kInt8 ? sides * G::TRMAX : 0);
  float* const qt = side_of + (kInt8 ? sides * G::TRMAX : 0);   // [D][QB]
  float* const sumq = qt + (kSQ ? 0 : static_cast<size_t>(D) * IVF_QB);
  int* const cnt = reinterpret_cast<int*>(sumq + IVF_QB);       // [QB]
  float* const cs = reinterpret_cast<float*>(cnt + IVF_QB);  // [QB][CAND]
  int* const ci = reinterpret_cast<int*>(cs + IVF_QB * IVF_CAND);
  float* const ls = reinterpret_cast<float*>(ci + IVF_QB * IVF_CAND);
  int* const li = reinterpret_cast<int*>(ls + IVF_QB * k);      // [QB][k]

  long long cyc[IVF_P_TIMED] = {}, t_last = kProf ? clock64() : 0;
  int n_cand = 0, n_loads = 0;
  auto mark = [&](int slot) {   // charge the cycles since the last mark
    if constexpr (kProf) {
      const long long now = clock64();
      cyc[slot] += now - t_last;
      t_last = now;
    }
  };
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], IVF_WARPS);
    }
    mbar_fence_init();
  }
  int64_t done = 0;           // loads of earlier items: the ring's phase

  for (;;) {
    if (tid == 0) s_item = atomicAdd(&counters[1], 1);
    __syncthreads();
    const int it = s_item;
    if (it >= n_items) break;
    const int4 item = items[it];
    const int q0 = item.x * IVF_QB, c = item.y, slice = item.z;
    int64_t occ = bucket_occ[c];
    if (occ > cap) occ = cap;
    const int64_t r0 = static_cast<int64_t>(slice) * item.w;
    const int64_t r1 = r0 + item.w < occ ? r0 + item.w : occ;

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
        qbound[at] = q * groups + pos / (nprobe / groups);
      }
      if (lane == 0) s_qn = __popc(m);
    }
    __syncthreads();
    const int qn = s_qn;      // >= 1: the plan made an item of (z, c)

    // query chunks of QA; each group of `boxes` warps takes one, a box of
    // a tile each
    const int groups = ivf_groups(qn);
    const int boxes = IVF_WARPS / groups;
    const int TR = boxes * G::BOXR;
    const int tiles = static_cast<int>((r1 - r0 + TR - 1) / TR);
    const int loads = tiles * chunks;
    const int64_t base = static_cast<int64_t>(c) * cap;

    // rows of tile t this item needs, and the boxes that hold them
    auto tile_rows = [&](int t) {
      const int64_t left = r1 - (r0 + static_cast<int64_t>(t) * TR);
      return left < TR ? static_cast<int>(left) : TR;
    };
    auto issue = [&](int L) {   // stage L % chunks of tile L / chunks
      const int st = (done + L) % stages, t = L / chunks, ch = L % chunks;
      uint8_t* const stage = ring + st * STAGEB;
      // the slot's last load has been used by every warp
      if (done + L >= stages)
        mbar_wait(&empty[st],
                  static_cast<int>(((done + L - stages) / stages) & 1));
      const int rows = tile_rows(t);
      const int nbox = (rows + G::BOXR - 1) / G::BOXR;
      const int64_t row0 = base + r0 + static_cast<int64_t>(t) * TR;
      const bool last = ch == chunks - 1;
      const int nside = (rows + 3) & ~3;   // cap % 4 == 0: inside the bucket
      uint64_t* bar = &full[st];
      mbar_expect_tx(bar, nbox * G::BOXB + (last ? nside * G::SIDEB : 0) +
                              (kSQ ? G::QS : 0));
      for (int b = 0; b < nbox; ++b)
        tma_load_2d(stage + b * G::BOXB, &tm_rows, bar, ch * G::DC,
                    static_cast<int>(row0) + b * G::BOXR);
      if constexpr (kSQ)      // the tile's 32 queries, [32][DC]
        tma_load_2d(stage + G::STAGE, &tm_q, bar, ch * G::DC, q0);
      if (last) {
        const int sd = (t % sides) * G::TRMAX;
        bulk_load_1d(side_id + sd, packed_ids + row0, nside * 4, bar);
        if constexpr (kInt8) {
          bulk_load_1d(side_sc + sd, packed_scale + row0, nside * 4, bar);
          bulk_load_1d(side_of + sd, packed_offset + row0, nside * 4, bar);
        }
      }
    };

    if (tid == 0)
      for (int L = 0; L < stages && L < loads; ++L) issue(L);
    // the queries, transposed, by asynchronous 4-byte copies all in flight
    // at once; thread (q, g) copies dims g, g + 8, ... of slot q
    const int sq = tid % IVF_QB, sg = tid / IVF_QB;
    const float* qrow =
        queries + static_cast<int64_t>(sq < qn ? qidx[sq] : 0) * D;
    if constexpr (!kSQ) {
      for (int d = sg; d < D; d += IVF_WARPS) {
        if (sq < qn)
          __pipeline_memcpy_async(qt + d * IVF_QB + sq, qrow + d, 4);
        else
          qt[d * IVF_QB + sq] = 0.f;
      }
    }
    __pipeline_commit();
    for (int e = tid; e < IVF_QB * k; e += IVF_THREADS) {
      ls[e] = TOPK_NEG;
      li[e] = INT_MAX;
    }
    if (tid < IVF_QB) cnt[tid] = 0;
    __pipeline_wait_prior(0);
    if (kInt8) {
      // sum(q): each thread its dims in order, then the 8 partial sums in
      // order (cs, empty until the first candidates, holds them)
      float part = 0.f;   // streamed: read where the queries lie
      for (int d = sg; d < D; d += IVF_WARPS)
        part = __fadd_rn(part, kSQ ? (sq < qn ? qrow[d] : 0.f)
                                   : qt[d * IVF_QB + sq]);
      cs[sg * IVF_QB + sq] = part;
      __syncthreads();
      if (tid < IVF_QB) {
        float sum = 0.f;
        for (int g = 0; g < IVF_WARPS; ++g)
          sum = __fadd_rn(sum, cs[g * IVF_QB + tid]);
        sumq[tid] = sum;
      }
    }
    __syncthreads();
    mark(IVF_P_SETUP);

    const int qc = warp / boxes, box = warp % boxes;
    const bool active = qc * IVF_QA < qn;
    int col[IVF_QA];          // streamed: the chunk's queries in the tile
#pragma unroll
    for (int a = 0; a < IVF_QA; ++a)
      col[a] = kSQ && IVF_QA * qc + a < qn ? qidx[IVF_QA * qc + a] - q0 : 0;
    // each of this warp's queries' bar so far, (score, id): the better of
    // its list's k-th and its shared bound as last read (both only ever
    // rise, so the better of the old bar and either one's new value is
    // the bar); and lane a's read of query a's shared bound, on its way
    float thr_s[IVF_QA];
    int thr_i[IVF_QA];
    const unsigned long long pad = ivf_key(TOPK_NEG, INT_MAX);
    unsigned long long pending = pad;
#pragma unroll
    for (int a = 0; a < IVF_QA; ++a) {
      thr_s[a] = TOPK_NEG;
      thr_i[a] = INT_MAX;
    }
    float acc[IVF_QA][RB];
#pragma unroll
    for (int a = 0; a < IVF_QA; ++a)
#pragma unroll
      for (int j = 0; j < RB; ++j) acc[a][j] = 0.f;

    for (int L = 0; L < loads; ++L) {
      const int st = (done + L) % stages, t = L / chunks, ch = L % chunks;
      mbar_wait(&full[st], static_cast<int>(((done + L) / stages) & 1));
      mark(IVF_P_DATA);
      const int rows = tile_rows(t);
      const bool mine = active && box * G::BOXR < rows;
      if (mine)
        ivf_stage_fma<kInt8, kSQ>(
            acc, ring + st * STAGEB + box * G::BOXB,
            kSQ ? reinterpret_cast<const float*>(ring + st * STAGEB +
                                                 G::STAGE)
                : qt,
            col, qc, ch * G::DC, D, lane);
      mark(IVF_P_FMA);
      if (ch == chunks - 1) {
        // the tile is scored: what passes the query's threshold goes to
        // the lists, in rounds while a query's buffer overflows
        const int sd = (t % sides) * G::TRMAX;
        float s[IVF_QA][RB];
        int id[RB];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          const int r = box * G::BOXR + lane + 32 * j;
          id[j] = mine && r < rows ? side_id[sd + r] : -1;
          float sc = 0.f, of = 0.f;
          if (kInt8 && id[j] >= 0) {
            sc = side_sc[sd + r];
            of = side_of[sd + r];
          }
#pragma unroll
          for (int a = 0; a < IVF_QA; ++a)
            s[a][j] = kInt8 ? __fadd_rn(__fmul_rn(acc[a][j], sc),
                                        __fmul_rn(sumq[IVF_QA * qc + a], of))
                            : acc[a][j];
        }
        // the shared bounds read at the last tile's end (an older bound is
        // still one), then this tile's read, which has a tile's time to
        // arrive; lane a < QA reads query a's for the warp
#pragma unroll
        for (int a = 0; a < IVF_QA; ++a) {
          float bs;
          int bi;
          ivf_unkey(__shfl_sync(FULL_MASK, pending, a), &bs, &bi);
          if (topk_better(bs, bi, thr_s[a], thr_i[a])) {
            thr_s[a] = bs;
            thr_i[a] = bi;
          }
        }
        pending = pad;
        if (mine && lane < IVF_QA && IVF_QA * qc + lane < qn)
          pending = *reinterpret_cast<volatile unsigned long long*>(
              bound + qbound[IVF_QA * qc + lane]);
        mark(IVF_P_SCORE);
        uint32_t sent = 0;    // bit a * RB + j: s[a][j] is in a buffer
        for (;;) {
          bool now = false, over = false;
#pragma unroll
          for (int a = 0; a < IVF_QA; ++a)
#pragma unroll
            for (int j = 0; j < RB; ++j) {
              const int q = IVF_QA * qc + a;
              const uint32_t bit = 1u << (a * RB + j);
              if (!(sent & bit) && q < qn && id[j] >= 0 &&
                  s[a][j] >= thr_s[a]) {
                // a tie with the bar goes on only with a lower id
                if (s[a][j] == thr_s[a] && id[j] >= thr_i[a]) continue;
                const int pos = atomicAdd(&cnt[q], 1);
                if (pos < IVF_CAND) {
                  cs[q * IVF_CAND + pos] = s[a][j];
                  ci[q * IVF_CAND + pos] = id[j];
                  sent |= bit;
                  now = true;
                  ++n_cand;
                } else {
                  over = true;
                }
              }
            }
          if (!__syncthreads_or(now)) break;
          if (kProf && tid == 0) atomicAdd(&prof[IVF_P_ROUNDS], 1ull);
          mark(IVF_P_FILTER);
          for (int q = warp; q < qn; q += IVF_WARPS) {
            const int n = cnt[q] < IVF_CAND ? cnt[q] : IVF_CAND;
            const float cv = lane < n ? cs[q * IVF_CAND + lane] : TOPK_NEG;
            const int cid = lane < n ? ci[q * IVF_CAND + lane] : INT_MAX;
            if (n > 0)
              ivf_list_merge(ls + q * k, li + q * k, k, cv, cid, lane < n,
                             lane);
            __syncwarp();
            if (lane == 0) {
              cnt[q] = 0;
              if (li[q * k + k - 1] != INT_MAX)   // a full list
                atomicMax(bound + qbound[q],
                          ivf_key(ls[q * k + k - 1], li[q * k + k - 1]));
            }
          }
          mark(IVF_P_OFFER);
          const int again = __syncthreads_or(over);
#pragma unroll
          for (int a = 0; a < IVF_QA; ++a) {
            const int e = (IVF_QA * qc + a) * k + k - 1;
            if (topk_better(ls[e], li[e], thr_s[a], thr_i[a])) {
              thr_s[a] = ls[e];
              thr_i[a] = li[e];
            }
          }
          if (!again) break;
        }
#pragma unroll
        for (int a = 0; a < IVF_QA; ++a)
#pragma unroll
          for (int j = 0; j < RB; ++j) acc[a][j] = 0.f;
        mark(IVF_P_FILTER);
      }
      // this warp is done with stage st; the producer refills the slot
      // once every warp is
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (tid == 0 && L + stages < loads) issue(L + stages);
      __syncwarp();
      mark(IVF_P_SYNC);
    }
    done += loads;
    n_loads += loads;

    for (int q = warp; q < qn; q += IVF_WARPS) {
      const int64_t o =
          ((static_cast<int64_t>(qidx[q]) * nprobe + qpos[q]) * slices +
           slice) * k;
      for (int j = lane; j < k; j += 32) {
        part_s[o + j] = ls[q * k + j];
        part_i[o + j] = li[q * k + j];
      }
    }
    if (kProf && tid == 0) atomicAdd(&prof[IVF_P_BLOCKS], 1ull);
    mark(IVF_P_WRITE);
    __syncthreads();          // the next item reuses the slots and lists
  }
  if constexpr (kProf) {
    n_cand = __reduce_add_sync(FULL_MASK, n_cand);
    if (lane == 0) {
      for (int p = 0; p < IVF_P_TIMED; ++p)
        atomicAdd(&prof[p], static_cast<unsigned long long>(cyc[p]));
      atomicAdd(&prof[IVF_P_CANDIDATES],
                static_cast<unsigned long long>(n_cand));
    }
    if (tid == 0) {
      atomicAdd(&prof[IVF_P_STAGES], static_cast<unsigned long long>(n_loads));
      atomicMax(&prof[IVF_P_PARTIAL_T1], ivf_now_ns());
    }
  }
}

// Merge a sorted list of k entries (the best first) into the warp's list,
// 32 at a time, stopping at the first 32 whose best cannot enter; padding
// entries (id INT_MAX) are not candidates.
__device__ __forceinline__ void ivf_merge_list(float* ls, int* li, int k,
                                               const float* ps,
                                               const int* pi, int lane) {
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int e = c0 + lane;
    const bool ok = e < k;
    const float s = ok ? ps[e] : TOPK_NEG;
    const int id = ok ? pi[e] : INT_MAX;
    if (!topk_better(__shfl_sync(FULL_MASK, s, 0),
                     __shfl_sync(FULL_MASK, id, 0), ls[k - 1], li[k - 1]))
      break;
    ivf_list_merge(ls, li, k, s, id, ok && id != INT_MAX, lane);
  }
}

// One block per (query, group): merge the lists the partial pass wrote for
// the group's probe positions into out (B, groups, k). Dynamic shared
// memory: (4 + 4) * warps * k bytes.
__global__ void __launch_bounds__(IVF_THREADS)
    ivf_merge(const float* __restrict__ part_s,
              const int* __restrict__ part_i, const int* __restrict__ probes,
              const int* __restrict__ nsl, int C, int nprobe,
              int groups, int slices, int k, float* __restrict__ out_s,
              int64_t* __restrict__ out_i,
              unsigned long long* __restrict__ prof) {
  extern __shared__ __align__(16) float merge_smem[];
  if (prof && threadIdx.x == 0)
    atomicMin(&prof[IVF_P_MERGE_T0], ivf_now_ns());
  float* ls = merge_smem;                                          // [8][k]
  int* li = reinterpret_cast<int*>(merge_smem + IVF_WARPS * k);    // [8][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x / groups, g = blockIdx.x % groups;
  const int per = nprobe / groups;
  for (int e = tid; e < IVF_WARPS * k; e += IVF_THREADS) {
    ls[e] = TOPK_NEG;
    li[e] = INT_MAX;
  }
  __syncthreads();
  const int* pr = probes + static_cast<int64_t>(q) * nprobe;
  float* wls = ls + warp * k;
  int* wli = li + warp * k;
  int n = 0;                  // lists met so far; warp n % 8 merges each
  for (int p = g * per; p < (g + 1) * per; ++p) {
    const int c = pr[p];
    if (c < 0 || c >= C) continue;
    bool again = false;       // the partial pass wrote the last position
    for (int p2 = p + 1 + lane; p2 < nprobe; p2 += 32) again |= pr[p2] == c;
    if (__any_sync(FULL_MASK, again)) continue;
    const int ns = nsl[(q / IVF_QB) * C + c];
    for (int s = 0; s < ns; ++s, ++n) {
      if (n % IVF_WARPS != warp) continue;
      const int64_t o =
          ((static_cast<int64_t>(q) * nprobe + p) * slices + s) * k;
      ivf_merge_list(wls, wli, k, part_s + o, part_i + o, lane);
    }
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < IVF_WARPS; ++w)
    ivf_merge_list(ls, li, k, ls + w * k, li + w * k, lane);
  for (int j = lane; j < k; j += 32) {
    out_s[static_cast<int64_t>(blockIdx.x) * k + j] = ls[j];
    out_i[static_cast<int64_t>(blockIdx.x) * k + j] = li[j];
  }
  if (prof && lane == 0) atomicMax(&prof[IVF_P_MERGE_T1], ivf_now_ns());
}

// The packed rows as a tensor map of one warp's box (BOXR rows x DC dims)
template <bool kInt8>
cudaError_t ivf_rows_map(CUtensorMap* map, const void* packed,
                         long long rows, int D) {
  using G = IvfGeom<kInt8>;
  return kInt8 ? matrix_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, rows,
                            D, 1, G::DC, G::BOXR, CU_TENSOR_MAP_SWIZZLE_32B)
               : matrix_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, packed,
                            rows, D, 4, G::DC, G::BOXR,
                            CU_TENSOR_MAP_SWIZZLE_64B);
}

// The ring the partial pass runs with at this D and k, and how many of its
// blocks fit an SM: of 2-4 stages, the one with the most bytes in flight
// an SM (blocks x stages), ties to the fewer stages. The partial pass
// runs per_sm x SMs persistent blocks. kSQ: the streamed instance.
template <bool kInt8, bool kSQ>
cudaError_t ivf_plan_form(int D, int k, int* stages, int* per_sm, int* sms) {
  if (k < 1 || k > TOPK_KMAX || D < 1) return cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, ivf_partial_topk<kInt8, false, kSQ>);
  if (err != cudaSuccess) return err;
  int best = 0;
  for (int st = 2; st <= IVF_MAX_STAGES; ++st) {
    const size_t smem = ivf_smem_bytes<kInt8>(D, k, st, kSQ);
    if (smem + attr.sharedSizeBytes > static_cast<size_t>(optin)) break;
    err = cudaFuncSetAttribute(ivf_partial_topk<kInt8, false, kSQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, ivf_partial_topk<kInt8, false, kSQ>, IVF_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (n * st > best) {
      best = n * st;
      *stages = st;
      *per_sm = n;
    }
  }
  return best > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// ivf_plan_form for the instance the wrapper chose: streamed != 0 where
// 32 queries of width D and two stages do not fit (its smem_bytes).
template <bool kInt8>
cudaError_t ivf_plan(int D, int k, int streamed, int* stages, int* per_sm,
                     int* sms) {
  return streamed ? ivf_plan_form<kInt8, true>(D, k, stages, per_sm, sms)
                  : ivf_plan_form<kInt8, false>(D, k, stages, per_sm, sms);
}

// Ints of the scratch the plan needs: the queries and slices of each
// (query tile, bucket), the counters, up to max(resident, pairs) items of
// four ints (16-byte aligned; resident + pairs kept), and the shared
// bounds of the B * groups (query, group) lists, 64-bit keys.
__host__ __device__ constexpr int64_t ivf_items_at(int64_t pairs) {
  return (2 * pairs + 2 + 3) / 4 * 4;
}
__host__ __device__ constexpr int64_t ivf_scratch_ints(int64_t pairs,
                                                       int64_t resident,
                                                       int64_t bounds) {
  return ivf_items_at(pairs) + 4 * (resident + pairs) + 2 * bounds;
}

// The three launches of one stage-2 search: the plan, the partial pass on
// `resident` persistent blocks, the merge. part_s / part_i: (B, nprobe,
// slices, k) scratch, slices = ceil(cap / TRMAX), written only where an
// item has rows (the merge reads nothing else); scratch:
// ivf_scratch_ints(ceil(B / 32) * C, resident, B * groups) ints; streamed:
// the instance that streams the queries (ivf_plan's); out_s /
// out_i: (B, groups, k); groups divides nprobe; cap % 4 == 0. With prof
// (IVF_P_SLOTS counters), the partial pass runs its profiled
// instantiation and both timed launches record their windows.
template <bool kInt8>
cudaError_t ivf_stage2_run(const void* packed, const float* packed_scale,
                           const float* packed_offset, const int* packed_ids,
                           const int* bucket_occ, int C, long long cap,
                           const float* queries, const int* probes, int B,
                           int nprobe, int D, int k, int stages, int streamed,
                           int resident, int slices, int* scratch,
                           float* part_s,
                           int* part_i, float* out_s, int64_t* out_i,
                           int groups, unsigned long long* prof,
                           cudaStream_t stream) {
  using G = IvfGeom<kInt8>;
  if (k < 1 || k > TOPK_KMAX || stages < 2 || stages > IVF_MAX_STAGES ||
      resident < 1 || cap % 4 || slices < (cap + G::TRMAX - 1) / G::TRMAX ||
      groups < 1 || nprobe % groups)
    return cudaErrorInvalidValue;
  const int pairs = (B + IVF_QB - 1) / IVF_QB * C;
  int* const qcount = scratch;
  int* const nsl = scratch + pairs;
  int* const counters = scratch + 2 * pairs;
  int4* const items = reinterpret_cast<int4*>(scratch + ivf_items_at(pairs));
  auto* const bound = reinterpret_cast<unsigned long long*>(
      scratch + ivf_items_at(pairs) + 4 * (resident + pairs));
  ivf_plan_items<<<1, 1024, 0, stream>>>(probes, bucket_occ, B, nprobe, C,
                                         cap, groups, resident, G::TRMAX,
                                         qcount, nsl, items, counters,
                                         bound);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap map, qmap = {};
  err = ivf_rows_map<kInt8>(&map, packed, C * cap, D);
  if (err != cudaSuccess) return err;
  if (streamed) {   // (32 queries x DC dims) boxes of the fp32 queries
    err = matrix_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, queries, B, D,
                     4, G::DC, IVF_QB, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = ivf_smem_bytes<kInt8>(D, k, stages, streamed != 0);
  auto kernel = streamed ? (prof ? ivf_partial_topk<kInt8, true, true>
                                 : ivf_partial_topk<kInt8, false, true>)
                         : (prof ? ivf_partial_topk<kInt8, true, false>
                                 : ivf_partial_topk<kInt8, false, false>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<resident, IVF_THREADS, smem, stream>>>(
      map, qmap, packed_scale, packed_offset, packed_ids, bucket_occ, queries,
      probes, B, nprobe, D, k, stages, cap, slices, groups, items, counters,
      bound, part_s, part_i, prof);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ivf_merge<<<B * groups, IVF_THREADS,
              (sizeof(float) + sizeof(int)) * IVF_WARPS * k, stream>>>(
      part_s, part_i, probes, nsl, C, nprobe, groups, slices, k, out_s,
      out_i, prof);
  return cudaGetLastError();
}

}  // namespace
