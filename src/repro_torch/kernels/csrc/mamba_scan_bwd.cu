// The backward of mamba_scan.cu, in the JAX layout: delta (B, S, di), B and
// C (B, S, ds), A (di, ds) fp32, x (B, S, di) fp32 or bf16, the forward's
// chunk-start states ckpt (B, ceil(S / TC), di, ds) fp32, and the gradients
// of y (B, S, di) and of h_fin (B, di, ds), fp32 -> ddelta, dx (B, S, di),
// dB, dC (B, S, ds) and dA (di, ds), fp32. ds in {4, 8, 16, 32}; di a
// multiple of 8 (the wrapper pads and cuts).
//
// Replaces: none. The Pallas kernel (src/repro/kernels/mamba_scan.py:55) has
// no backward: the JAX trainer differentiates the checkpointed lax.scan of
// models/ssm.py:126-137. This kernel gives the port's autograd.Function its
// backward.
//
// What it computes: with a_t = exp(delta_t A) and Gh the gradient of h_t
// (starting at the gradient of h_fin), for t = S-1 .. 0 and each channel c:
//   Gh += dy_t[c] C_t,
//   dC_t += dy_t[c] h_t[c],  dB_t += Gh delta_t[c] x_t[c]  (sums over c),
//   dx_t[c] = delta_t[c] (Gh . B_t),
//   ddelta_t[c] = x_t[c] (Gh . B_t) + sum_s Gh[s] h_{t-1}[s] a_t[s] A[c][s],
//   dA[c] += Gh h_{t-1} a_t delta_t[c]  (a sum over b and t),
//   Gh <- a_t Gh.
// h_{t-1} and a_t are recomputed forward from the chunk's checkpoint with
// the forward's own formula (exp2 of delta (A log2 e) by ex2.approx, the
// same fused multiply-adds), so they equal the forward's bit for bit; never
// by dividing by a_t, which can be ~0. The products Gh h_{t-1} a_t are
// taken as (a_t Gh) h_{t-1}, the next step's Gh times the state.
//
// What bounds it: at the jamba layer's shape (B 4, S 2048, di 16384, ds 16)
// the bytes bind on paper: 2.96 GB of delta, x (bf16), dy, ddelta, dx and
// the checkpoints, 0.88 ms at 3.35 TB/s; the function's one exp a state
// element and step (2.15 G) takes 0.44 ms with the MUFU and FMA pipes
// balanced. This kernel issues ~13 FP32 instructions a state element and
// step (3 for the recompute, 8 for the step back, the rest for the two-level
// recompute below) and 1.75 exps, all on the MUFU (16 a clock an SM):
// ~1.1 ms of MUFU and ~1 ms of FP32 issue at 1.7 GHz. The sums of dC and
// dB across channels cost ~7 more instructions a state element and step
// (a lane's 8 terms a step over its warp's 8 channels: shuffles, the
// selects of the reduce-scatter, adds). So the issue bounds it, not the
// bytes: 3.26 ms on an H100 SXM at 700 W (tools/kernel_ab.py; the first
// version, 7.46). A 544-thread block gets 96 registers a thread, all of
// which the ds 16 instance uses, and its warps issue at ~2/3 of the rate
// their instructions would allow (mamba_scan_bwd_cycles: the walk ~75% of
// a consumer warp's cycles, the first level ~13%); 64 channels a block, two
// blocks an SM, took 3.243 ms against 3.261 and doubles dB and dC's
// partials, so a block keeps 128.
//
// Design: a lane holds 4 states of a channel (ds / 4 lanes a channel, 128
// channels a block; 32 at ds 32) and their Gh, A, A log2 e and dA in
// registers for the whole sequence, and walks the chunks from the last. A
// chunk's states are recomputed in two levels, so that none goes to local
// memory: first those before steps 0, 4, 8 and 12 (16 registers), then,
// for each 4-step sub-chunk from the last, its states and a_t (36 more),
// and the sub-chunk is walked back with no exp of its own: 1.75 exps a
// state element and step (the first version took 2). Per step, a lane's
// terms of dC and dB (its 4 states) are summed over the warp's channels by
// a reduce-scatter of shuffles into the warp's slot in shared memory; once
// a chunk, after a barrier of the consumer warps, the block adds its warps'
// sums in a fixed order and writes one partial per block and step (128
// channels: 4x fewer than the first version's per-warp partials). Gh . B
// and the ddelta sum over the channel's lanes are a reduce-scatter over the
// sub-chunk's 4 steps, after which a lane writes ddelta and dx of one step.
// Staging is off the consumers: a producer warp issues TMA loads of a
// chunk's delta, x, dy, B, C and the block's slice of its checkpoint into a
// ring of NS stages on mbarriers. A second launch sums the blocks' partials
// into dB and dC and the batches' into dA, each in a fixed order. No
// atomics: repeated runs agree bit for bit.
#include "common.cuh"
#include "mamba_scan.cuh"
#include "tma.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int NS = 3;              // stages of the ring
constexpr int SUB = 4;             // steps of a sub-chunk
constexpr int NSUB = TC / SUB;
constexpr int SL = 4;              // states a lane

template <typename T, int DS>
struct Cfg {
  static constexpr int LC = DS / SL;                  // lanes a channel
  static constexpr int NCH = DS == 32 ? 32 : 128;     // channels a block
  static constexpr int CONS = NCH * LC;               // consumer threads
  static constexpr int NW = CONS / 32;                // consumer warps
  static constexpr int THREADS = CONS + 32;           // + the producer warp
  static constexpr int MINB = DS == 4 ? 3 : 1;
  // a stage: delta, x, dy (TC, NCH); B, C (TC, DS); the checkpoint slice
  static constexpr int DELTA = TC * NCH * 4;
  static constexpr int X = TC * NCH * static_cast<int>(sizeof(T));
  static constexpr int BC = TC * DS * 4;
  static constexpr int CK = NCH * DS * 4;
  static constexpr int X_OFF = DELTA, DY_OFF = X_OFF + X;
  static constexpr int B_OFF = DY_OFF + DELTA, C_OFF = B_OFF + BC;
  static constexpr int CK_OFF = C_OFF + BC;
  static constexpr int STAGE = (CK_OFF + CK + 127) / 128 * 128;
  // the warps' sums of dC and dB, [2][TC][NW][2 DS]
  static constexpr int PART_OFF = NS * STAGE;
  static constexpr int PART = TC * NW * 2 * DS * 4;
  static constexpr int BAR_OFF = PART_OFF + 2 * PART;
  static constexpr int BYTES = BAR_OFF + 2 * NS * 8 + 128;  // + alignment
  static constexpr uint32_t TX = 2 * DELTA + X + 2 * BC + CK;
};

// Profile slots (mamba_scan.py's BWD_PROFILE_SLOTS): clock64 cycles
// summed over the consumer warps (lane 0 of each) and over the producer
// threads, then the number of each.
enum {
  P_CONSUMER_WAIT, P_CONSUMER_LEVEL1, P_CONSUMER_WALK, P_CONSUMER_SYNC,
  P_CONSUMER_SUM, P_PRODUCER_WAIT_EMPTY, P_PRODUCER_ISSUE, P_CONSUMER_WARPS,
  P_PRODUCER_THREADS, P_SLOTS
};

// the consumer warps' barrier (barrier 1; __syncthreads is barrier 0)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

template <typename T, int DS, bool kProf>
__global__ void __launch_bounds__(Cfg<T, DS>::THREADS, Cfg<T, DS>::MINB)
scan_bwd(const __grid_constant__ CUtensorMap tm_delta,
         const __grid_constant__ CUtensorMap tm_x,
         const __grid_constant__ CUtensorMap tm_dy,
         const __grid_constant__ CUtensorMap tm_b,
         const __grid_constant__ CUtensorMap tm_c,
         const __grid_constant__ CUtensorMap tm_ck,
         const float* __restrict__ A, const float* __restrict__ dh_fin,
         float* __restrict__ ddelta, float* __restrict__ dx,
         float* __restrict__ da_part, float* __restrict__ bc_part, int S,
         int di, unsigned long long* __restrict__ prof) {
  using M = Cfg<T, DS>;
  constexpr int LC = M::LC, NCH = M::NCH, NW = M::NW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + M::BAR_OFF);
  uint64_t* const empty = full + NS;
  auto at = [&](int st, int off) {
    return reinterpret_cast<float*>(sm + st * M::STAGE + off);
  };
  auto sx = [&](int st) {
    return reinterpret_cast<const T*>(sm + st * M::STAGE + M::X_OFF);
  };
  auto part = [&](int p) {
    return reinterpret_cast<float*>(sm + M::PART_OFF + p * M::PART);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, blk = blockIdx.x, c0 = blk * NCH;
  const int n_chunks = (S + TC - 1) / TC;
  // with kProf, lap(p) adds the cycles since the last lap to slot p
  long long cyc[P_CONSUMER_WARPS] = {}, t_last = kProf ? clock64() : 0;
  auto lap = [&](int p) {
    if constexpr (kProf) {
      const long long now = clock64();
      cyc[p] += now - t_last;
      t_last = now;
    }
  };
  auto flush = [&](int first, int last, int count_slot) {
    if constexpr (kProf) {
      for (int p = first; p <= last; ++p)
        atomicAdd(&prof[p], static_cast<unsigned long long>(cyc[p]));
      atomicAdd(&prof[count_slot], 1ull);
    }
  };

  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NW) {
    // ---- producer warp: one lane issues every load ----
    if (lane == 0)
      for (int kk = 0; kk < n_chunks; ++kk) {
        const int st = kk % NS, c = n_chunks - 1 - kk;
        if (kk >= NS) mbar_wait(&empty[st], (kk / NS - 1) & 1);
        lap(P_PRODUCER_WAIT_EMPTY);
        mbar_expect_tx(&full[st], M::TX);
        tma_load_3d(at(st, 0), &tm_delta, &full[st], c0, c * TC, b);
        tma_load_3d(at(st, M::X_OFF), &tm_x, &full[st], c0, c * TC, b);
        tma_load_3d(at(st, M::DY_OFF), &tm_dy, &full[st], c0, c * TC, b);
        tma_load_3d(at(st, M::B_OFF), &tm_b, &full[st], 0, c * TC, b);
        tma_load_3d(at(st, M::C_OFF), &tm_c, &full[st], 0, c * TC, b);
        tma_load_3d(at(st, M::CK_OFF), &tm_ck, &full[st], 0, c0,
                    b * n_chunks + c);
        lap(P_PRODUCER_ISSUE);
      }
    if (lane == 0)
      flush(P_PRODUCER_WAIT_EMPTY, P_PRODUCER_ISSUE, P_PRODUCER_THREADS);
    return;
  }

  // ---- consumer lanes: channel c0 + ch, states 4 sg .. 4 sg + 3 ----
  const int ch = tid / LC, sg = tid % LC, s0 = SL * sg;
  const int i = c0 + ch;
  const bool live = i < di;
  const int ic = live ? i : di - 1;        // a ragged block's spare lanes
  float a2[SL], Af[SL], G[SL], dA[SL];
#pragma unroll
  for (int s = 0; s < SL; ++s) {
    Af[s] = A[static_cast<int64_t>(ic) * DS + s0 + s];
    a2[s] = Af[s] * LOG2E;
    G[s] = live ? dh_fin[(static_cast<int64_t>(b) * di + i) * DS + s0 + s]
                : 0.f;
    dA[s] = 0.f;
  }
  const int nblk = gridDim.x;

  for (int kk = 0; kk < n_chunks; ++kk) {
    const int st = kk % NS, p = kk & 1, c = n_chunks - 1 - kk;
    const int t0 = c * TC, n = min(TC, S - t0);
    const float* sdelta = at(st, 0);
    const T* xs = sx(st);
    const float* sdy = at(st, M::DY_OFF);
    const float* sb = at(st, M::B_OFF);
    const float* scm = at(st, M::C_OFF);
    float* const pw = part(p);
    mbar_wait(&full[st], (kk / NS) & 1);
    lap(P_CONSUMER_WAIT);
    // h <- exp2(delta_t A log2 e) h + (delta_t x_t) B_t, the forward's
    // arithmetic (mamba_scan.cu); a[] gets the decays
    auto advance = [&](float (&h)[SL], float (&a)[SL], int tt) {
      const float dt = sdelta[tt * NCH + ch];
      const float dxv = dt * to_f(xs[tt * NCH + ch]);
      const float4 b4 = *reinterpret_cast<const float4*>(sb + tt * DS + s0);
      const float bv[SL] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int s = 0; s < SL; ++s) {
        a[s] = exp2_mufu(dt * a2[s]);
        h[s] = fmaf(a[s], h[s], dxv * bv[s]);
      }
    };
    // the states before steps 0, 4, 8 and 12 of the chunk
    float sc[NSUB][SL];
    {
      const float4 c4 = *reinterpret_cast<const float4*>(
          at(st, M::CK_OFF) + ch * DS + s0);
      sc[0][0] = c4.x; sc[0][1] = c4.y; sc[0][2] = c4.z; sc[0][3] = c4.w;
      float h[SL] = {c4.x, c4.y, c4.z, c4.w}, a[SL];
#pragma unroll
      for (int tt = 0; tt < TC - SUB; ++tt) {
        advance(h, a, tt);
        if ((tt + 1) % SUB == 0)
#pragma unroll
          for (int s = 0; s < SL; ++s) sc[(tt + 1) / SUB][s] = h[s];
      }
    }
    lap(P_CONSUMER_LEVEL1);
#pragma unroll
    for (int m = NSUB - 1; m >= 0; --m) {
      // hs[e]: the state before step SUB m + e (hs[SUB]: after the last);
      // as[e]: that step's decays
      float hs[SUB + 1][SL], as[SUB][SL];
#pragma unroll
      for (int s = 0; s < SL; ++s) hs[0][s] = sc[m][s];
#pragma unroll
      for (int e = 0; e < SUB; ++e) {
#pragma unroll
        for (int s = 0; s < SL; ++s) hs[e + 1][s] = hs[e][s];
        advance(hs[e + 1], as[e], SUB * m + e);
      }
      float P[2 * SUB];          // [e][Gh . B, the ddelta sum] of the lane
#pragma unroll
      for (int e = SUB - 1; e >= 0; --e) {
        const int tt = SUB * m + e;
        const float dt = sdelta[tt * NCH + ch];
        const float dxv = dt * to_f(xs[tt * NCH + ch]);
        const float dyt = sdy[tt * NCH + ch];
        const float4 b4 = *reinterpret_cast<const float4*>(sb + tt * DS + s0);
        const float4 c4 = *reinterpret_cast<const float4*>(scm + tt * DS +
                                                           s0);
        const float bv[SL] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[SL] = {c4.x, c4.y, c4.z, c4.w};
        float red[2 * SL], gb = 0.f, dd = 0.f;    // red: dC then dB terms
#pragma unroll
        for (int s = 0; s < SL; ++s) {
          const float g = fmaf(dyt, cv[s], G[s]);
          red[s] = dyt * hs[e + 1][s];
          red[SL + s] = g * dxv;
          gb = s ? fmaf(g, bv[s], gb) : g * bv[s];
          const float gn = as[e][s] * g;          // the next step's Gh
          const float gha = gn * hs[e][s];
          dd = s ? fmaf(gha, Af[s], dd) : gha * Af[s];
          if (tt < n) {          // a ragged chunk's steps past S: Gh stays
            dA[s] = fmaf(gha, dt, dA[s]);
            G[s] = gn;
          }
        }
        P[2 * e] = gb;
        P[2 * e + 1] = dd;
        // dC and dB of step tt over the warp's channels (lane bits LC ..
        // 16), into the warp's slot
        int idx;
        bool writer;
        lane_reduce_scatter<2 * SL, 16, LC>(red, idx, writer);
        if (writer) {
          constexpr int NV = 2 * SL * LC / 32 > 0 ? 2 * SL * LC / 32 : 1;
#pragma unroll
          for (int f = 0; f < NV; ++f) {
            const int v = idx + f;               // (dC or dB, state s0 + ..)
            pw[(tt * NW + warp) * 2 * DS + (v / SL) * DS + s0 + v % SL] =
                red[f];
          }
        }
      }
      // Gh . B and the ddelta sum over the channel's LC lanes: a
      // reduce-scatter over the sub-chunk's steps while a lane holds two
      // or more, then sums of the last step's pair
      int idx = 0;
      bool writer = true;
      if constexpr (LC == 2) lane_reduce_scatter<2 * SUB, 1, 1>(P, idx, writer);
      if constexpr (LC >= 4)
        lane_reduce_scatter<2 * SUB, LC / 2, LC / 4>(P, idx, writer);
      if constexpr (LC == 8) {   // the last level: both sums of the pair
        P[0] += __shfl_xor_sync(FULL_MASK, P[0], 1);
        P[1] += __shfl_xor_sync(FULL_MASK, P[1], 1);
        writer = !(lane & 1);
      }
      if (writer) {
        constexpr int HOLD = LC >= 4 ? 1 : SUB / LC;   // steps a lane holds
#pragma unroll
        for (int f = 0; f < HOLD; ++f) {
          const int tt = SUB * m + idx / 2 + f;
          if (live && tt < n) {
            const float dt = sdelta[tt * NCH + ch];
            const float xv = to_f(xs[tt * NCH + ch]);
            const int64_t o = (static_cast<int64_t>(b) * S + t0 + tt) * di + i;
            ddelta[o] = fmaf(xv, P[2 * f], P[2 * f + 1]);
            dx[o] = dt * P[2 * f];
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);      // the stage is read
    lap(P_CONSUMER_WALK);
    consumers_sync(M::CONS);
    lap(P_CONSUMER_SYNC);
    // the block's dC, dB of the chunk's steps: its warps' sums in order
    for (int it = tid; it < TC * 2 * DS; it += M::CONS) {
      const int tt = it / (2 * DS), v = it % (2 * DS);
      if (tt >= n) continue;
      float acc = pw[(tt * NW) * 2 * DS + v];
#pragma unroll
      for (int wq = 1; wq < NW; ++wq) acc += pw[(tt * NW + wq) * 2 * DS + v];
      bc_part[((static_cast<int64_t>(b) * nblk + blk) * S + t0 + tt) * 2 *
                  DS + v] = acc;
    }
    lap(P_CONSUMER_SUM);
  }
  if (lane == 0) flush(P_CONSUMER_WAIT, P_CONSUMER_SUM, P_CONSUMER_WARPS);
  if (live)
#pragma unroll
    for (int s = 0; s < SL; ++s)
      da_part[(static_cast<int64_t>(b) * di + i) * DS + s0 + s] = dA[s];
}

// dC, dB (B, S, ds) from the blocks' partials, in order of the block; then
// dA (di, ds) from the batches', in order of b
template <int DS>
__global__ void bc_sum(const float* __restrict__ bc_part,
                       float* __restrict__ dbm, float* __restrict__ dcm,
                       int B, int S, int nblk) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * S * 2 * DS) return;
  const int v = static_cast<int>(idx % (2 * DS));
  const int64_t bt = idx / (2 * DS);              // b * S + t
  const int64_t b = bt / S, t = bt % S;
  float acc = 0.f;
  for (int k = 0; k < nblk; ++k)
    acc += bc_part[((b * nblk + k) * S + t) * 2 * DS + v];
  if (v < DS)
    dcm[bt * DS + v] = acc;
  else
    dbm[bt * DS + v - DS] = acc;
}

__global__ void da_sum(const float* __restrict__ da_part,
                       float* __restrict__ dA, int B, int64_t n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += da_part[b * n + idx];
  dA[idx] = acc;
}

template <typename T, int DS>
int launch_typed(const float* delta, const float* bm, const float* cm,
                 const void* x, const float* A, const float* ckpt,
                 const float* dy, const float* dh_fin, float* ddelta,
                 float* dbm, float* dcm, float* dx, float* dA,
                 float* da_part, float* bc_part, int B, int S, int di,
                 unsigned long long* prof, cudaStream_t stream) {
  using M = Cfg<T, DS>;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapDataType TX = sizeof(T) == 4
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int n_chunks = (S + TC - 1) / TC;
  const long long wide[3] = {di, S, B}, narrow[3] = {DS, S, B};
  const long long ck[3] = {DS, di, static_cast<long long>(B) * n_chunks};
  const int wide_box[3] = {M::NCH, TC, 1}, narrow_box[3] = {DS, TC, 1};
  const int ck_box[3] = {DS, M::NCH, 1};
  CUtensorMap md, mx, mdy, mb, mc, mck;
  cudaError_t err;
  if ((err = contiguous_map(&md, F32, delta, 3, wide, 4, wide_box)) !=
          cudaSuccess ||
      (err = contiguous_map(&mx, TX, x, 3, wide, sizeof(T), wide_box)) !=
          cudaSuccess ||
      (err = contiguous_map(&mdy, F32, dy, 3, wide, 4, wide_box)) !=
          cudaSuccess ||
      (err = contiguous_map(&mb, F32, bm, 3, narrow, 4, narrow_box)) !=
          cudaSuccess ||
      (err = contiguous_map(&mc, F32, cm, 3, narrow, 4, narrow_box)) !=
          cudaSuccess ||
      (err = contiguous_map(&mck, F32, ckpt, 3, ck, 4, ck_box)) !=
          cudaSuccess)
    return err;
  constexpr int smem = M::BYTES;
  auto kernel = prof ? scan_bwd<T, DS, true> : scan_bwd<T, DS, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((di + M::NCH - 1) / M::NCH, B);
  kernel<<<grid, M::THREADS, smem, stream>>>(md, mx, mdy, mb, mc, mck, A,
                                             dh_fin, ddelta, dx, da_part,
                                             bc_part, S, di, prof);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t nbc = static_cast<int64_t>(B) * S * 2 * DS;
  bc_sum<DS><<<static_cast<unsigned>((nbc + 255) / 256), 256, 0, stream>>>(
      bc_part, dbm, dcm, B, S, static_cast<int>(grid.x));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t na = static_cast<int64_t>(di) * DS;
  da_sum<<<static_cast<unsigned>((na + 255) / 256), 256, 0, stream>>>(
      da_part, dA, B, na);
  return cudaGetLastError();
}

template <int DS>
int launch_ds(int bf16, const float* delta, const float* bm, const float* cm,
              const void* x, const float* A, const float* ckpt,
              const float* dy, const float* dh_fin, float* ddelta, float* dbm,
              float* dcm, float* dx, float* dA, float* da_part,
              float* bc_part, int B, int S, int di,
              unsigned long long* prof, cudaStream_t stream) {
  if (bf16)
    return launch_typed<__nv_bfloat16, DS>(delta, bm, cm, x, A, ckpt, dy,
                                           dh_fin, ddelta, dbm, dcm, dx, dA,
                                           da_part, bc_part, B, S, di, prof,
                                           stream);
  return launch_typed<float, DS>(delta, bm, cm, x, A, ckpt, dy, dh_fin,
                                 ddelta, dbm, dcm, dx, dA, da_part, bc_part,
                                 B, S, di, prof, stream);
}

}  // namespace

REPRO_ERROR_STRING(mamba_scan_bwd)

// da_part: (B, di, ds) and bc_part: (B, ceil(di / channels), S, 2 ds) fp32
// scratch for the partial sums, channels = 32 at ds 32, else 128; prof:
// null, or P_SLOTS zeroed counters that a profiled launch adds to
extern "C" int mamba_scan_bwd_launch(
    const float* delta, const float* bm, const float* cm, const void* x,
    const float* A, const float* ckpt, const float* dy, const float* dh_fin,
    float* ddelta, float* dbm, float* dcm, float* dx, float* dA,
    float* da_part, float* bc_part, int B, int S, int di, int ds, int bf16,
    unsigned long long* prof, cudaStream_t stream) {
  if (B <= 0 || S <= 0 || di <= 0 || di % 8 || B > 65535)
    return cudaErrorInvalidValue;
  switch (ds) {
    case 4:
      return launch_ds<4>(bf16, delta, bm, cm, x, A, ckpt, dy, dh_fin,
                          ddelta, dbm, dcm, dx, dA, da_part, bc_part, B, S,
                          di, prof, stream);
    case 8:
      return launch_ds<8>(bf16, delta, bm, cm, x, A, ckpt, dy, dh_fin,
                          ddelta, dbm, dcm, dx, dA, da_part, bc_part, B, S,
                          di, prof, stream);
    case 16:
      return launch_ds<16>(bf16, delta, bm, cm, x, A, ckpt, dy, dh_fin,
                           ddelta, dbm, dcm, dx, dA, da_part, bc_part, B, S,
                           di, prof, stream);
    case 32:
      return launch_ds<32>(bf16, delta, bm, cm, x, A, ckpt, dy, dh_fin,
                           ddelta, dbm, dcm, dx, dA, da_part, bc_part, B, S,
                           di, prof, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
