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
// near, so the bank's stream and the FMAs must overlap, and the FMAs must
// not wait on shared memory: no TF32, no bf16, no library GEMM (TF32 would
// move scores by ~1e-3 and flip the ids of near ties). Shared memory
// delivers 128 bytes a clock to an SM's lanes, broadcast or not, against
// 128 FMAs a clock: a float read from it must feed 4 FMAs.
//
// Design, two launches:
//   1. nn_partial_topk: grid (slices, query tiles of 32), 8 warps. Lane
//      (qg, rg) of a warp scores queries 8qg .. 8qg + 7 against 8 rows of
//      the warp's 64 (rows rg, rg + 8, ...): 64 sums in registers, and for
//      each d 8 query and 8 row floats read for 64 FMAs. The block walks
//      its slice of the bank in tiles of TR rows (512 at D 128), each cut
//      into chunks of 16 dims; one thread keeps a ring of NS stages (up to
//      4) full with TMA loads of (TR rows x 16 dims) boxes of a 2-d tensor
//      map over the bank (64-byte swizzle, so the 8 rows a quarter-warp
//      reads sit in 8 distinct bank groups; rows and dims past the bank
//      read as zeros), NS - 1 chunks ahead of the compute. The block's 32
//      queries ride the ring too: each stage also holds their 16 dims of
//      the chunk, [32][16], by a second TMA box of a map over the queries
//      (2 KB; queries past B read as zeros), and a lane reads each of its
//      8 queries as one float4 of 4 dims, so that shared memory does not
//      grow with D and any D % 4 == 0 runs. (Queries held whole in shared
//      memory, transposed, [d][32], took 128 bytes a dim, and past
//      ~1.3-1.6k dims no longer fit beside two stages; at D 128 they were
//      2% slower than the ring's, with the same scores.) Each (query, row)
//      sum runs in D order, so a
//      pair's score does not depend on N or on the slice plan. After a
//      tile's last chunk the scores meet a filter in registers: a score
//      goes on only if it is at least its query's current k-th (a
//      register, refreshed after each insert round) and, if equal, its id
//      is below the k-th's (read from the list), so that (score, id)
//      beats the k-th in the lists' order (a zero query, as a padded
//      batch holds, ties every row at 0 and lets through only ids below
//      its k-th's), into a per-query
//      candidate buffer of 64 in shared memory; once the lists are warm
//      almost none pass, and a tile with none skips the inserts. The
//      owner warp of each query offers its candidates to the query's
//      running top-k list (list_offer, common.cuh); candidates that found
//      a full buffer try again in another round, against the new k-th. A
//      block writes its k best per query.
//   2. merge_topk_lists (common.cuh): one block per query merges the
//      slices' lists, each warp into a list of its own, then warp 0 merges
//      the eight.
// Lists are ordered by (score descending, id ascending), a strict total
// order on distinct ids, so the result does not depend on the order in
// which candidates arrive or on the merge's, and equal scores go to the
// lowest id as in _merge_topk. A list starts filled with (-1e30,
// INT_MAX), the Pallas kernel's padding.
//
// What sets the pace on the H100: the FMA loop, at about a third of the
// fp32 peak at the serve shapes; loading the next step ahead of the
// FMAs, no block barrier between chunks, and the other loop order each
// left the time where it was. Scores from the tensor cores (3xTF32,
// m16n8k8) took 0.78x the time but moved them by up to 8.4e-5, past the
// ids the plain version decides; tf32 scores as a filter, with exact FMA
// rescoring of what passes, kept the ids but took 1.7x the time. Neither
// is used (PERF.md §6). The tie rule above took 2% more time on 32 real
// queries and halved that of a padded batch (B 8 or 16, 4 zero queries),
// which a score-only filter let through on every row.
#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int QB = 32;         // queries per block of pass 1
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int QL = 8;          // queries per lane
constexpr int DC = 16;         // dims per chunk: 64-byte rows in a stage
constexpr int CAND = 64;       // candidate slots per query and round
constexpr int BOX_ROWS = 256;  // TMA's largest box side
constexpr int MAX_STAGES = 4;
constexpr int KMAX = TOPK_KMAX;
constexpr float NEG = TOPK_NEG;

constexpr int QSLICE = QB * DC * 4;   // a stage's query slice: 2 KB

// bytes of dynamic shared memory: the ring (bank rows and query slices),
// the candidate buffers and counts, the lists, and room to align the ring
// (the wrapper's tile_plan mirrors this)
size_t partial_smem_bytes(int k, int tile_rows, int stages) {
  return 1024 + static_cast<size_t>(stages) * (tile_rows * DC * 4 + QSLICE) +
         8 * QB * CAND + 4 * QB + 8 * QB * k;
}

template <int RPL>
__global__ void __launch_bounds__(THREADS, 1)
    nn_partial_topk(const __grid_constant__ CUtensorMap tm_bank,
                    const __grid_constant__ CUtensorMap tm_q, int B,
                    int64_t N, int D, int k, int stages,
                    int64_t rows_per_slice, float* __restrict__ part_s,
                    int* __restrict__ part_i) {
  constexpr int TR = 64 * RPL;                 // rows per tile
  constexpr int BANKB = TR * DC * 4;           // a stage's bank rows
  constexpr int STAGE = BANKB + QSLICE;        // bytes per stage
  constexpr int BOX = TR < BOX_ROWS ? TR : BOX_ROWS;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[MAX_STAGES];
  // the ring starts on a 1024-byte boundary, a multiple of the swizzle's
  // 512-byte period
  uint8_t* const ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  float* const cs = reinterpret_cast<float*>(ring + stages * STAGE);  // [QB][CAND]
  int* const ci = reinterpret_cast<int*>(cs + QB * CAND);   // [QB][CAND]
  int* const cnt = ci + QB * CAND;                          // [QB]
  float* const ls = reinterpret_cast<float*>(cnt + QB);     // [QB][k]
  int* const li = reinterpret_cast<int*>(ls + QB * k);      // [QB][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = lane >> 3, rg = lane & 7;
  const int q0 = blockIdx.y * QB;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_slice;
  const int64_t r1 = r0 + rows_per_slice < N ? r0 + rows_per_slice : N;
  const int chunks = (D + DC - 1) / DC;
  const int tiles = static_cast<int>((r1 - r0 + TR - 1) / TR);
  const int loads = tiles * chunks;
  auto issue = [&](int L) {   // chunk L % chunks of tile L / chunks
    const int st = L % stages;
    uint64_t* bar = &full[st];
    mbar_expect_tx(bar, STAGE);
    const int64_t row = r0 + static_cast<int64_t>(L / chunks) * TR;
#pragma unroll
    for (int bx = 0; bx < TR / BOX; ++bx)
      tma_load_2d(ring + st * STAGE + bx * BOX * DC * 4, &tm_bank, bar,
                  (L % chunks) * DC, static_cast<int>(row) + bx * BOX);
    // the block's queries, [32][16], beside them
    tma_load_2d(ring + st * STAGE + BANKB, &tm_q, bar, (L % chunks) * DC, q0);
  };

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
    for (int L = 0; L < stages && L < loads; ++L) issue(L);
  }
  for (int e = tid; e < QB * k; e += THREADS) {
    ls[e] = NEG;
    li[e] = INT_MAX;
  }
  if (tid < QB) cnt[tid] = 0;
  float thr[QL];                // each of this lane's queries' k-th so far
#pragma unroll
  for (int a = 0; a < QL; ++a) thr[a] = NEG;
  __syncthreads();

  // this lane's rows of a tile: warp * 8 RPL + rg + 8j; in a stage a row
  // is 64 bytes, its 16-byte chunk c stored at chunk c ^ ((row >> 1) & 3)
  const int swz = (rg >> 1) & 3;
  const int row_base = warp * 8 * RPL + rg;
  float acc[QL][RPL];
#pragma unroll
  for (int a = 0; a < QL; ++a)
#pragma unroll
    for (int j = 0; j < RPL; ++j) acc[a][j] = 0.f;

  for (int L = 0; L < loads; ++L) {
    const int st = L % stages, ch = L % chunks;
    mbar_wait(&full[st], (L / stages) & 1);
    const uint8_t* stage = ring + st * STAGE;
    const int d0 = ch * DC;
#pragma unroll
    for (int c = 0; c < DC / 4; ++c) {
      if (d0 + 4 * c < D) {
        float4 x[RPL];
#pragma unroll
        for (int j = 0; j < RPL; ++j)
          x[j] = *reinterpret_cast<const float4*>(
              stage + (row_base + 8 * j) * 64 + ((c ^ swz) << 4));
        float4 qs[QL];            // query a's 4 dims of chunk c
#pragma unroll
        for (int a = 0; a < QL; ++a)
          qs[a] = *reinterpret_cast<const float4*>(
              stage + BANKB + ((QL * qg + a) * DC + 4 * c) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float q[QL];
#pragma unroll
          for (int a = 0; a < QL; ++a)
            q[a] = e == 0 ? qs[a].x : e == 1 ? qs[a].y
                 : e == 2 ? qs[a].z : qs[a].w;
#pragma unroll
          for (int j = 0; j < RPL; ++j) {
            const float v = e == 0 ? x[j].x : e == 1 ? x[j].y
                          : e == 2 ? x[j].z : x[j].w;
#pragma unroll
            for (int a = 0; a < QL; ++a) acc[a][j] = fmaf(q[a], v, acc[a][j]);
          }
        }
      }
    }
    __syncthreads();            // every warp is done with stage st
    if (tid == 0 && L + stages < loads) issue(L + stages);
    if (ch != chunks - 1) continue;

    // the tile is scored: its candidates go to the lists, in rounds while
    // a query's buffer overflows
    const int64_t t0 = r0 + static_cast<int64_t>(L / chunks) * TR;
    const int rows = r1 - t0 < TR ? static_cast<int>(r1 - t0) : TR;
    uint64_t sent = 0;          // bit a * RPL + j: acc[a][j] is in a buffer
    for (;;) {
      bool now = false, over = false;
#pragma unroll
      for (int a = 0; a < QL; ++a)
#pragma unroll
        for (int j = 0; j < RPL; ++j) {
          const int q = QL * qg + a, row = row_base + 8 * j;
          const uint64_t bit = 1ull << (a * RPL + j);
          if (!(sent & bit) && q0 + q < B && row < rows &&
              acc[a][j] >= thr[a]) {
            // a tie with the k-th goes on only with a lower id: thr[a] is
            // the list's last score until the next round's inserts
            if (acc[a][j] == thr[a] &&
                static_cast<int>(t0 + row) >= li[(QL * qg + a) * k + k - 1])
              continue;
            const int pos = atomicAdd(&cnt[q], 1);
            if (pos < CAND) {
              cs[q * CAND + pos] = acc[a][j];
              ci[q * CAND + pos] = static_cast<int>(t0 + row);
              sent |= bit;
              now = true;
            } else {
              over = true;
            }
          }
        }
      if (!__syncthreads_or(now)) break;
      for (int qq = warp; qq < QB; qq += WARPS) {
        const int n = cnt[qq] < CAND ? cnt[qq] : CAND;
        for (int c0 = 0; c0 < n; c0 += 32) {
          const int c = c0 + lane;
          const bool ok = c < n;
          list_offer(ls + qq * k, li + qq * k, k,
                     ok ? cs[qq * CAND + c] : NEG,
                     ok ? ci[qq * CAND + c] : INT_MAX, ok, lane);
        }
        __syncwarp();
        if (lane == 0) cnt[qq] = 0;
      }
      const int again = __syncthreads_or(over);
#pragma unroll
      for (int a = 0; a < QL; ++a) thr[a] = ls[(QL * qg + a) * k + k - 1];
      if (!again) break;
    }
#pragma unroll
    for (int a = 0; a < QL; ++a)
#pragma unroll
      for (int j = 0; j < RPL; ++j) acc[a][j] = 0.f;
  }

  const int64_t slices = gridDim.x;
  for (int qq = warp; qq < QB && q0 + qq < B; qq += WARPS)
    for (int j = lane; j < k; j += 32) {
      const int64_t o = ((q0 + qq) * slices + blockIdx.x) * k + j;
      part_s[o] = ls[qq * k + j];
      part_i[o] = li[qq * k + j];
    }
}

// The (D, N) fp32 bank as a tensor map of (box rows x 16 dims) boxes with
// the 64-byte swizzle; rows and dims past the bank read as zeros.
cudaError_t bank_map(CUtensorMap* map, const float* bank, long long N, int D,
                     int box_rows) {
  return matrix_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, bank, N, D, 4, DC,
                    box_rows, CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int RPL>
cudaError_t plan_partial(long long N, int k, int stages, int* slices,
                         long long* rows_per_slice) {
  constexpr int TR = 64 * RPL;
  const size_t smem = partial_smem_bytes(k, TR, stages);
  cudaError_t err = cudaFuncSetAttribute(
      nn_partial_topk<RPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, nn_partial_topk<RPL>, THREADS, smem);
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

template <int RPL>
cudaError_t launch_partial(const float* queries, const float* bank, int B,
                           long long N, int D, int k, int stages,
                           long long rows_per_slice, int slices,
                           float* part_s, int* part_i, cudaStream_t stream) {
  constexpr int TR = 64 * RPL;
  CUtensorMap map, qmap;
  cudaError_t err = bank_map(&map, bank, N, D, TR < BOX_ROWS ? TR : BOX_ROWS);
  if (err != cudaSuccess) return err;
  // the queries as (32 queries x 16 dims) boxes, unswizzled
  err = matrix_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, queries, B, D, 4,
                   DC, QB, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  const size_t smem = partial_smem_bytes(k, TR, stages);
  err = cudaFuncSetAttribute(
      nn_partial_topk<RPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(slices, (B + QB - 1) / QB);
  nn_partial_topk<RPL><<<grid, THREADS, smem, stream>>>(
      map, qmap, B, N, D, k, stages, rows_per_slice, part_s, part_i);
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING(nn_search)

// How pass 1 cuts the bank: the number of slices (blocks per query tile)
// and the rows of each; the caller sizes the partial lists from them.
extern "C" int nn_search_plan(long long N, int k, int tile_rows, int stages,
                              int* slices, long long* rows_per_slice) {
  if (stages < 2 || stages > MAX_STAGES) return cudaErrorInvalidValue;
  switch (tile_rows) {
    case 64: return plan_partial<1>(N, k, stages, slices, rows_per_slice);
    case 128: return plan_partial<2>(N, k, stages, slices, rows_per_slice);
    case 256: return plan_partial<4>(N, k, stages, slices, rows_per_slice);
    case 512: return plan_partial<8>(N, k, stages, slices, rows_per_slice);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int nn_search_launch(const float* queries, const float* bank,
                                int B, long long N, int D, int k,
                                int tile_rows, int stages,
                                long long rows_per_slice, int slices,
                                float* part_s, int* part_i, float* out_s,
                                int64_t* out_i, cudaStream_t stream) {
  if (k < 1 || k > KMAX || D % 4 || stages < 2 || stages > MAX_STAGES)
    return cudaErrorInvalidValue;
  cudaError_t err;
  switch (tile_rows) {
    case 64:
      err = launch_partial<1>(queries, bank, B, N, D, k, stages,
                              rows_per_slice, slices, part_s, part_i, stream);
      break;
    case 128:
      err = launch_partial<2>(queries, bank, B, N, D, k, stages,
                              rows_per_slice, slices, part_s, part_i, stream);
      break;
    case 256:
      err = launch_partial<4>(queries, bank, B, N, D, k, stages,
                              rows_per_slice, slices, part_s, part_i, stream);
      break;
    case 512:
      err = launch_partial<8>(queries, bank, B, N, D, k, stages,
                              rows_per_slice, slices, part_s, part_i, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const size_t smem = (sizeof(float) + sizeof(int)) * WARPS * k;
  merge_topk_lists<<<B, THREADS, smem, stream>>>(part_s, part_i, slices, k,
                                                 out_s, out_i);
  return cudaGetLastError();
}
