// The backward of rwkv_wkv.cu, in the JAX layout: r, k, v (B, S, H, d) in
// the model dtype (fp32 or bf16), w (B, S, H, d) and u (H, d) fp32, the
// forward's chunk-start states ckpt (B, H, ceil(S / TC), d, d) fp32, and the
// gradients of y (B, S, H, d) and of S_fin (B, H, d, d), fp32 -> dr, dk, dv,
// dw (B, S, H, d) and du (H, d), fp32. d in {16, 32, 64}.
//
// Replaces: none. The Pallas kernel (src/repro/kernels/rwkv_wkv.py:54) has
// no backward: the JAX trainer differentiates the checkpointed lax.scan of
// models/ssm.py:253-264. This kernel gives the port's autograd.Function its
// backward.
//
// What it computes: with S_t the state after step t and G the gradient of
// S_t (G starts at the gradient of S_fin), for t = S-1 .. 0:
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i][j] + u[i] k_t[i] (dy_t . v_t),
//   dk_t[i] = r_t[i] u[i] (dy_t . v_t) + sum_j G[i][j] v_t[j],
//   dv_t[j] = dy_t[j] c_t + sum_i G[i][j] k_t[i], c_t = sum_i r_t u k_t,
//   dw_t[i] = sum_j G[i][j] S_{t-1}[i][j],
//   du[i]  += r_t[i] k_t[i] (dy_t . v_t),
//   G[i][j] <- w_t[i] G[i][j] + r_t[i] dy_t[j].
// S_{t-1} is recomputed forward from the chunk's checkpoint with the
// forward's own fused multiply-adds (so it equals the forward's state bit
// for bit), never by dividing by w_t, which can be ~0. Both recurrences
// are elementwise in (i, j); only the gradients sum over i or j.
//
// What bounds it: the bytes (r, k, v, w, dy, the checkpoints read, four
// gradients written) take 0.46 ms at the rwkv6-7b prefill (B 4, S 2048, H
// 64, d 64), 0.031 ms at its training shape (B 8, S 64). The function needs
// 8 FP32 instructions a state element and step (the recompute's product
// and FMA, three FMAs for the row sums, a product for dv's column sum, G's
// product and FMA), 2.1 G element-steps at the prefill: ~0.6 ms of the FP32
// pipes at 1.7 GHz. This design issues ~70 instructions a warp and step
// for a lane's 4 elements: the two-level recompute below adds half a step
// of the forward's update, and the sums across lanes ~23 (shuffles, the
// selects of their reduce-scatters, adds). So the schedulers' issue bounds
// it, not the bytes: 2.87 ms at the prefill and 0.20 at the training shape
// on an H100 SXM at 700 W (tools/kernel_ab.py; the first version, with its
// states in local memory, 6.21 and 0.41). Of a consumer warp's cycles
// (rwkv_wkv_bwd_cycles) the walk back takes ~63%, waiting for a stage
// ~14%, the chunk's sums ~11%, the cluster barrier ~6%, the first level
// ~6%. The waits are the warps' skew, not the loads: three TMA stages
// beside two buffers of widened inputs left them as they were (3.03 ms).
// Tried and dropped too: the sums on the producer warp (3.06-3.14 ms: one
// warp cannot add a chunk in time), two producer warps or the stage
// released before the barrier (2.860 ms, no gain).
//
// Design: a head's (d, d) elements are cut into d / 16 slices of 16
// columns, one block each, the blocks of a head one thread-block cluster
// (4 at d 64: B H 4 blocks, 2,048 at the training shape). A block holds
// its slice for all d rows in 8-row consumer warps, a lane one row and 4
// columns of G in registers for the whole sequence. A chunk's states are
// recomputed from the checkpoint in two levels, so that none goes to local
// memory: first the states before steps 0, 4, 8 and 12 (16 registers),
// then, for each 4-step sub-chunk from the last, its 4 states (12 more),
// and the sub-chunk is walked back. The sums run once per sub-chunk or
// pair of steps, never through a barrier: dr, dk and dw's partials over a
// lane's 4 columns as a reduce-scatter of shuffles over the row's 4 lanes
// and the sub-chunk's 4 steps (each lane keeps one step's three sums),
// dv's over the warp's 8 rows as a reduce-scatter over two steps' 4
// columns; each lane writes its sums to shared memory. Once a chunk, after
// a cluster barrier, each block adds, in a fixed order, dv over its warps
// and dr, dk, dw for its 16 rows over the cluster's slices, read from the
// other blocks' shared memory (no global partials, no float atomics), and
// stores them; a block waits on that barrier only once the next chunk's
// first-level states are in registers, so the blocks' skew is partly
// hidden. Staging is off the consumers: a producer warp issues TMA loads of
// a chunk's r, k, v, w, dy and the slice of its checkpoint into a ring of
// NS stages on mbarriers, widens bf16 r, k and v to fp32 and sums dy_t .
// v_t and c_t for each step (a reduce-scatter over the quads of a step).
// du's terms are added by the thread that stores a row's gradients, over
// the sequence, then over those threads in a fixed order, then over b by a
// second launch. Repeated runs agree bit for bit.
#include "common.cuh"
#include "rwkv_wkv.cuh"
#include "tma.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int SW = 16;             // columns of a slice (a block)
constexpr int NS = 2;              // stages of the ring
constexpr int SUB = 4;             // steps of a sub-chunk
constexpr int NSUB = TC / SUB;

template <int D>
struct Cfg {
  static constexpr int CW = D / 8;             // consumer warps, 8 rows each
  static constexpr int CONS = 32 * CW;         // consumer threads
  static constexpr int THREADS = CONS + 32;    // + the producer warp
  static constexpr int NSL = D / SW;           // slices (blocks) a head
  static constexpr int QP = D / 4;             // quads of a step
  static constexpr int NQ = TC * QP / 32;      // steps a producer lane sums
};

template <typename T, int D>
struct Smem {
  static constexpr bool WIDEN = sizeof(T) != 4;          // bf16 r, k, v
  static constexpr int TILE = TC * D * 4;                // an fp32 tile
  static constexpr int RAW = WIDEN ? TC * D * 2 : 0;     // a bf16 tile
  static constexpr int CK = D * SW * 4;                  // a checkpoint slice
  // a stage: fp32 r, k, v, w, dy; the checkpoint's slice; raw r, k, v;
  // dy_t . v_t and c_t of each step
  static constexpr int CK_OFF = 5 * TILE;
  static constexpr int RAW_OFF = CK_OFF + CK;
  static constexpr int SC_OFF = RAW_OFF + 3 * RAW;
  static constexpr int STAGE = (SC_OFF + 2 * TC * 4 + 127) / 128 * 128;
  // the chunk's row sums over the slice, [2][3][TC][RS], read by the cluster
  static constexpr int RS = D + 8;             // row stride: no bank conflict
  static constexpr int ROW_OFF = NS * STAGE;
  static constexpr int ROWBUF = 3 * TC * RS * 4;
  // dv's sums over each warp's rows, [2][TC][DVS]
  static constexpr int DVS = Cfg<D>::CW * SW + 16;
  static constexpr int DV_OFF = ROW_OFF + 2 * ROWBUF;
  static constexpr int DVBUF = TC * DVS * 4;
  static constexpr int BAR_OFF = DV_OFF + 2 * DVBUF;
  static constexpr int BYTES = BAR_OFF + 3 * NS * 8 + 128;  // + alignment
  static constexpr uint32_t TX = TC * D * (3 * sizeof(T) + 8) + CK;
};

// Profile slots (rwkv_wkv.py's BWD_PROFILE_SLOTS): clock64 cycles summed
// over the consumer warps (lane 0 of each) and over the producer warps,
// then the number of each.
enum {
  P_CONSUMER_WAIT, P_CONSUMER_LEVEL1, P_CONSUMER_CLUSTER, P_CONSUMER_SUM,
  P_CONSUMER_WALK, P_PRODUCER_WAIT_LOADED, P_PRODUCER_PREPARE,
  P_PRODUCER_CLUSTER, P_PRODUCER_REFILL, P_CONSUMER_WARPS, P_PRODUCER_WARPS,
  P_SLOTS
};

// the whole cluster's threads, every block's shared memory written before
// the barrier visible after it (each thread alternates arrive and wait)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// a float of block `rank`'s shared memory, at the place of `local` in ours
__device__ __forceinline__ float ld_cluster(const float* local, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(local)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
  return v;
}

// the consumer warps' barrier (barrier 1; __syncthreads is barrier 0)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// four bf16 (8 bytes) as fp32
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

template <typename T, int D, bool kProf>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 2)
wkv_bwd(const __grid_constant__ CUtensorMap tm_r,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const __grid_constant__ CUtensorMap tm_w,
        const __grid_constant__ CUtensorMap tm_dy,
        const __grid_constant__ CUtensorMap tm_ck,
        const float* __restrict__ u, const float* __restrict__ ds_fin,
        float* __restrict__ dr, float* __restrict__ dk,
        float* __restrict__ dv, float* __restrict__ dw,
        float* __restrict__ du_part, int S, int H,
        unsigned long long* __restrict__ prof) {
  using C = Cfg<D>;
  using M = Smem<T, D>;
  constexpr int CW = C::CW, NSL = C::NSL, QP = C::QP, NQ = C::NQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* const loaded = reinterpret_cast<uint64_t*>(sm + M::BAR_OFF);
  uint64_t* const full = loaded + NS;
  uint64_t* const empty = full + NS;
  // fp32 r, k, v, w, dy (which 0 .. 4) of a stage
  auto tile = [&](int st, int which) {
    return reinterpret_cast<float*>(sm + st * M::STAGE + which * M::TILE);
  };
  auto raw = [&](int st, int which) {     // bf16 r, k, v as loaded
    return reinterpret_cast<T*>(sm + st * M::STAGE + M::RAW_OFF +
                                which * M::RAW);
  };
  auto ckt = [&](int st) {                // (d, SW): rows of the slice
    return reinterpret_cast<float*>(sm + st * M::STAGE + M::CK_OFF);
  };
  auto dyv_of = [&](int st) {             // [TC] dy_t . v_t, then [TC] c_t
    return reinterpret_cast<float*>(sm + st * M::STAGE + M::SC_OFF);
  };
  auto rowbuf = [&](int p) {              // [3][TC][RS]: dr, dk, dw
    return reinterpret_cast<float*>(sm + M::ROW_OFF + p * M::ROWBUF);
  };
  auto dvbuf = [&](int p) {               // [TC][DVS]: a warp's SW columns
    return reinterpret_cast<float*>(sm + M::DV_OFF + p * M::DVBUF);
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x % NSL;         // the slice: the cluster rank
  const int bh = blockIdx.x / NSL, b = bh / H, h = bh % H;
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
      if (lane == 0) {
        for (int p = first; p <= last; ++p)
          atomicAdd(&prof[p], static_cast<unsigned long long>(cyc[p]));
        atomicAdd(&prof[count_slot], 1ull);
      }
    }
  };

  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(&loaded[st], 1);
      mbar_init(&full[st], 32);
      mbar_init(&empty[st], CW);
    }
    mbar_fence_init();
  }
  cluster_arrive();
  cluster_wait();

  if (warp == CW) {
    // ---- producer warp ----
    auto issue = [&](int kk) {  // the kk-th chunk walked into stage kk % NS
      const int st = kk % NS, c = n_chunks - 1 - kk;
      mbar_expect_tx(&loaded[st], M::TX);
      void* dst[3];
#pragma unroll
      for (int x = 0; x < 3; ++x)
        dst[x] = M::WIDEN ? static_cast<void*>(raw(st, x))
                          : static_cast<void*>(tile(st, x));
      tma_load_3d(dst[0], &tm_r, &loaded[st], h * D, c * TC, b);
      tma_load_3d(dst[1], &tm_k, &loaded[st], h * D, c * TC, b);
      tma_load_3d(dst[2], &tm_v, &loaded[st], h * D, c * TC, b);
      tma_load_3d(tile(st, 3), &tm_w, &loaded[st], h * D, c * TC, b);
      tma_load_3d(tile(st, 4), &tm_dy, &loaded[st], h * D, c * TC, b);
      tma_load_2d(ckt(st), &tm_ck, &loaded[st], q * SW,
                  (bh * n_chunks + c) * D);
    };
    if (lane == 0)
      for (int kk = 0; kk < NS && kk < n_chunks; ++kk) issue(kk);
    __syncwarp();
    // lane l sums columns i4 .. i4 + 3 of the steps l / QP + (32 / QP) m
    const int i4 = 4 * (lane % QP), g0 = lane / QP;
    const float4 u4 = *reinterpret_cast<const float4*>(u + h * D + i4);
    for (int kk = 0; kk < n_chunks; ++kk) {
      const int st = kk % NS;
      mbar_wait(&loaded[st], (kk / NS) & 1);
      lap(P_PRODUCER_WAIT_LOADED);
      float part[2 * NQ];                        // [m][dy . v, r u k]
#pragma unroll
      for (int m = 0; m < NQ; ++m) {
        const int e = (g0 + (32 / QP) * m) * D + i4;
        float4 r4, k4, v4;
        if constexpr (M::WIDEN) {
          r4 = widen4(raw(st, 0) + e);
          k4 = widen4(raw(st, 1) + e);
          v4 = widen4(raw(st, 2) + e);
          *reinterpret_cast<float4*>(tile(st, 0) + e) = r4;
          *reinterpret_cast<float4*>(tile(st, 1) + e) = k4;
          *reinterpret_cast<float4*>(tile(st, 2) + e) = v4;
        } else {
          r4 = *reinterpret_cast<const float4*>(tile(st, 0) + e);
          k4 = *reinterpret_cast<const float4*>(tile(st, 1) + e);
          v4 = *reinterpret_cast<const float4*>(tile(st, 2) + e);
        }
        const float4 d4 = *reinterpret_cast<const float4*>(tile(st, 4) + e);
        float a = d4.x * v4.x;
        a = fmaf(d4.y, v4.y, a);
        a = fmaf(d4.z, v4.z, a);
        part[2 * m] = fmaf(d4.w, v4.w, a);
        float cc = r4.x * u4.x * k4.x;
        cc = fmaf(r4.y * u4.y, k4.y, cc);
        cc = fmaf(r4.z * u4.z, k4.z, cc);
        part[2 * m + 1] = fmaf(r4.w * u4.w, k4.w, cc);
      }
      // over the QP lanes of a step: one sum a lane, [m][which] = idx
      int idx;
      bool writer;
      lane_reduce_scatter<2 * NQ, QP / 2, 1>(part, idx, writer);
      dyv_of(st)[(idx & 1) * TC + g0 + (32 / QP) * (idx >> 1)] = part[0];
      __syncwarp();
      mbar_arrive(&full[st]);
      lap(P_PRODUCER_PREPARE);
      // the cluster barrier of chunk kk - 1, one arrival a chunk
      if (kk >= 1) cluster_wait();
      cluster_arrive();
      lap(P_PRODUCER_CLUSTER);
      // refill the stage of chunk kk - 1 once the consumers release it
      if (kk >= 1 && kk - 1 + NS < n_chunks) {
        mbar_wait(&empty[(kk - 1) % NS], ((kk - 1) / NS) & 1);
        if (lane == 0) issue(kk - 1 + NS);
        __syncwarp();
      }
      lap(P_PRODUCER_REFILL);
    }
    flush(P_PRODUCER_WAIT_LOADED, P_PRODUCER_REFILL, P_PRODUCER_WARPS);
    cluster_wait();               // the last chunk's
    cluster_arrive();             // the teardown's: no block leaves while
    cluster_wait();               // another reads its shared memory
    return;
  }

  // ---- consumer warps: row i, columns q SW + lc .. + 3 ----
  const int i = 8 * warp + (lane >> 2), lc = 4 * (lane & 3);
  const int col = q * SW + lc;
  float G[4];
  {
    const float4 g4 = *reinterpret_cast<const float4*>(
        ds_fin + (static_cast<int64_t>(bh) * D + i) * D + col);
    G[0] = g4.x; G[1] = g4.y; G[2] = g4.z; G[3] = g4.w;
  }
  // s <- s w_t[i] + k_t[i] v_t[j], the forward's FMA (rwkv_wkv.cu)
  auto advance = [&](float (&s)[4], const float* fk, const float* fv,
                     const float* fw, int tt) {
    const float wi = fw[tt * D + i], ki = fk[tt * D + i];
    const float4 v4 = *reinterpret_cast<const float4*>(fv + tt * D + col);
    s[0] = fmaf(s[0], wi, ki * v4.x);
    s[1] = fmaf(s[1], wi, ki * v4.y);
    s[2] = fmaf(s[2], wi, ki * v4.z);
    s[3] = fmaf(s[3], wi, ki * v4.w);
  };
  // the sum stage: each thread stores the gradients of row q SW + lr (and
  // dv of column q SW + lr) at steps tid / SW + (CONS / SW) j of a chunk,
  // and adds du's terms of that row at those steps over the sequence
  const int lr = tid % SW, row = q * SW + lr;
  const float ur = u[h * D + row];
  float du_acc = 0.f;
  auto sum_chunk = [&](int kk) {
    const int st = kk % NS, t0 = (n_chunks - 1 - kk) * TC;
    const int n = min(TC, S - t0);
    const float* fr = tile(st, 0);
    const float* fk = tile(st, 1);
    const float* fdy = tile(st, 4);
    const float* dyv = dyv_of(st);
    const float* cts = dyv + TC;
    const float* rb = rowbuf(kk & 1);
    const float* db = dvbuf(kk & 1);
    for (int tt = tid / SW; tt < n; tt += C::CONS / SW) {
      // dr, dk, dw over the cluster's slices in rank order
      float a[3];
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const float* src = rb + (x * TC + tt) * M::RS + row;
        a[x] = ld_cluster(src, 0);
#pragma unroll
        for (int rk = 1; rk < NSL; ++rk) a[x] += ld_cluster(src, rk);
      }
      const float rr = fr[tt * D + row], kr = fk[tt * D + row];
      const int64_t off = ((static_cast<int64_t>(b) * S + t0 + tt) * H + h) *
                          D;
      dr[off + row] = fmaf(ur * kr, dyv[tt], a[0]);
      dk[off + row] = fmaf(rr * ur, dyv[tt], a[1]);
      dw[off + row] = a[2];
      du_acc = fmaf(rr * kr, dyv[tt], du_acc);
      // dv of the slice's column lr over the block's warps in order
      float sum = db[tt * M::DVS + lr];
#pragma unroll
      for (int wq = 1; wq < CW; ++wq) sum += db[tt * M::DVS + wq * SW + lr];
      dv[off + row] = fmaf(fdy[tt * D + row], cts[tt], sum);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);    // the stage is read
  };

  // Chunk kk's sums are added after its cluster barrier, which is waited
  // on once the next chunk's first-level states are in registers: the
  // walk of chunk kk + 1 writes buffers (kk + 1) & 1, whose last readers
  // (chunk kk - 1's sums) all arrived at that barrier before.
  float sc[NSUB][4];             // the states before steps 0, 4, 8 and 12
  for (int kk = 0; kk < n_chunks; ++kk) {
    const int st = kk % NS, c = n_chunks - 1 - kk;
    const int n = min(TC, S - c * TC);
    const float* fr = tile(st, 0);
    const float* fk = tile(st, 1);
    const float* fv = tile(st, 2);
    const float* fw = tile(st, 3);
    const float* fdy = tile(st, 4);
    float* const rb = rowbuf(kk & 1);
    float* const db = dvbuf(kk & 1);
    mbar_wait(&full[st], (kk / NS) & 1);
    lap(P_CONSUMER_WAIT);
    {
      const float4 c4 = *reinterpret_cast<const float4*>(ckt(st) + i * SW +
                                                         lc);
      sc[0][0] = c4.x; sc[0][1] = c4.y; sc[0][2] = c4.z; sc[0][3] = c4.w;
      float s[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int tt = 0; tt < TC - SUB; ++tt) {
        advance(s, fk, fv, fw, tt);
        if ((tt + 1) % SUB == 0)
#pragma unroll
          for (int x = 0; x < 4; ++x) sc[(tt + 1) / SUB][x] = s[x];
      }
    }
    lap(P_CONSUMER_LEVEL1);
    if (kk >= 1) {
      cluster_wait();            // chunk kk - 1's sums are in every block
      lap(P_CONSUMER_CLUSTER);
      sum_chunk(kk - 1);
      lap(P_CONSUMER_SUM);
    }
#pragma unroll
    for (int m = NSUB - 1; m >= 0; --m) {
      float sp[SUB][4];          // the states before the sub-chunk's steps
#pragma unroll
      for (int x = 0; x < 4; ++x) sp[0][x] = sc[m][x];
#pragma unroll
      for (int e = 1; e < SUB; ++e) {
#pragma unroll
        for (int x = 0; x < 4; ++x) sp[e][x] = sp[e - 1][x];
        advance(sp[e], fk, fv, fw, SUB * m + e - 1);
      }
      float P[3 * SUB];          // [e][dr, dk, dw] over the lane's columns
      float V[8];                // [step of the pair][column]: dv's terms
#pragma unroll
      for (int e = SUB - 1; e >= 0; --e) {
        const int tt = SUB * m + e;
        const float ri = fr[tt * D + i], ki = fk[tt * D + i];
        const float wi = fw[tt * D + i];
        const float4 v4 = *reinterpret_cast<const float4*>(fv + tt * D + col);
        const float4 d4 = *reinterpret_cast<const float4*>(fdy + tt * D +
                                                           col);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
        const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
        float pr = dd[0] * sp[e][0], pk = G[0] * vv[0], pw = G[0] * sp[e][0];
#pragma unroll
        for (int x = 1; x < 4; ++x) {
          pr = fmaf(dd[x], sp[e][x], pr);
          pk = fmaf(G[x], vv[x], pk);
          pw = fmaf(G[x], sp[e][x], pw);
        }
        P[3 * e] = pr;
        P[3 * e + 1] = pk;
        P[3 * e + 2] = pw;
#pragma unroll
        for (int x = 0; x < 4; ++x) V[(e & 1) * 4 + x] = G[x] * ki;
        if (tt < n)              // a ragged chunk's steps past S: G stays
#pragma unroll
          for (int x = 0; x < 4; ++x) G[x] = fmaf(wi, G[x], ri * dd[x]);
        if ((e & 1) == 0) {
          // steps tt, tt + 1 over the warp's 8 rows: V[0] is column
          // lc + (idx & 3) of step tt + (idx >> 2)
          int idx;
          bool writer;
          lane_reduce_scatter<8, 16, 4>(V, idx, writer);
          db[(tt + (idx >> 2)) * M::DVS + warp * SW + lc + (idx & 3)] = V[0];
        }
      }
      // the sub-chunk's row sums over the row's 4 lanes: lane lc / 4 keeps
      // step SUB m + lc / 4
      int idx;
      bool writer;
      lane_reduce_scatter<3 * SUB, 2, 1>(P, idx, writer);
      const int tt = SUB * m + idx / 3;
#pragma unroll
      for (int x = 0; x < 3; ++x) rb[(x * TC + tt) * M::RS + i] = P[x];
    }
    lap(P_CONSUMER_WALK);
    cluster_arrive();
  }
  cluster_wait();
  lap(P_CONSUMER_CLUSTER);
  sum_chunk(n_chunks - 1);
  // du of the block's rows: the threads' sums in order of the thread (in
  // the dv buffer the last chunk left free)
  float* const dut = dvbuf(n_chunks & 1);
  dut[tid] = du_acc;
  consumers_sync(C::CONS);
  if (tid < SW) {
    float acc = dut[tid];
    for (int m = 1; m < C::CONS / SW; ++m) acc += dut[tid + SW * m];
    du_part[bh * D + row] = acc;
  }
  lap(P_CONSUMER_SUM);
  flush(P_CONSUMER_WAIT, P_CONSUMER_WALK, P_CONSUMER_WARPS);
  cluster_arrive();                // the teardown's
  cluster_wait();
}

// du[h][i] = sum over b of du_part[b][h][i], in order of b
__global__ void du_sum(const float* __restrict__ du_part,
                       float* __restrict__ du, int B, int HD) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= HD) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += du_part[static_cast<int64_t>(b) * HD +
                                             idx];
  du[idx] = acc;
}

// a (B, S, H d) tensor of `type` as a map of (d, TC, 1) boxes
cudaError_t head_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, int elem_bytes, int B, int S, int H,
                     int D) {
  const long long dims[3] = {static_cast<long long>(H) * D, S, B};
  const int box[3] = {D, TC, 1};
  return contiguous_map(map, type, base, 3, dims, elem_bytes, box);
}

template <typename T, int D>
int launch_typed(const void* r, const void* k, const void* v, const float* w,
                 const float* u, const float* ckpt, const float* dy,
                 const float* ds_fin, float* dr, float* dk, float* dv,
                 float* dw, float* du, float* du_part, int B, int S, int H,
                 unsigned long long* prof, cudaStream_t stream) {
  constexpr CUtensorMapDataType TT = sizeof(T) == 4
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr int ES = static_cast<int>(sizeof(T));
  const int n_chunks = (S + TC - 1) / TC;
  // the checkpoints as (B H n_chunks d) rows of d, in (SW, d) boxes
  const long long ck_dims[2] = {D, static_cast<long long>(B) * H * n_chunks *
                                       D};
  const int ck_box[2] = {SW, D};
  CUtensorMap mr, mk, mv, mw, mdy, mck;
  cudaError_t err;
  if ((err = head_map(&mr, TT, r, ES, B, S, H, D)) != cudaSuccess ||
      (err = head_map(&mk, TT, k, ES, B, S, H, D)) != cudaSuccess ||
      (err = head_map(&mv, TT, v, ES, B, S, H, D)) != cudaSuccess ||
      (err = head_map(&mw, F32, w, 4, B, S, H, D)) != cudaSuccess ||
      (err = head_map(&mdy, F32, dy, 4, B, S, H, D)) != cudaSuccess ||
      (err = contiguous_map(&mck, F32, ckpt, 2, ck_dims, 4, ck_box)) !=
          cudaSuccess)
    return err;
  constexpr int smem = Smem<T, D>::BYTES;
  auto kernel = prof ? wkv_bwd<T, D, true> : wkv_bwd<T, D, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * H * Cfg<D>::NSL);
  cfg.blockDim = dim3(Cfg<D>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Cfg<D>::NSL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, mr, mk, mv, mw, mdy, mck, u, ds_fin,
                           dr, dk, dv, dw, du_part, S, H, prof);
  if (err != cudaSuccess) return err;
  du_sum<<<(H * D + 127) / 128, 128, 0, stream>>>(du_part, du, B, H * D);
  return cudaGetLastError();
}

template <int D>
int launch_d(int bf16, const void* r, const void* k, const void* v,
             const float* w, const float* u, const float* ckpt,
             const float* dy, const float* ds_fin, float* dr, float* dk,
             float* dv, float* dw, float* du, float* du_part, int B, int S,
             int H, unsigned long long* prof, cudaStream_t stream) {
  if (bf16)
    return launch_typed<__nv_bfloat16, D>(r, k, v, w, u, ckpt, dy, ds_fin,
                                          dr, dk, dv, dw, du, du_part, B, S,
                                          H, prof, stream);
  return launch_typed<float, D>(r, k, v, w, u, ckpt, dy, ds_fin, dr, dk, dv,
                                dw, du, du_part, B, S, H, prof, stream);
}

}  // namespace

REPRO_ERROR_STRING(rwkv_wkv_bwd)

// du_part: (B, H, d) fp32 scratch for the per-batch sums of du; prof:
// null, or P_SLOTS zeroed counters that a profiled launch adds to
extern "C" int rwkv_wkv_bwd_launch(
    const void* r, const void* k, const void* v, const float* w,
    const float* u, const float* ckpt, const float* dy, const float* ds_fin,
    float* dr, float* dk, float* dv, float* dw, float* du, float* du_part,
    int B, int S, int H, int d, int bf16, unsigned long long* prof,
    cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch_d<16>(bf16, r, k, v, w, u, ckpt, dy, ds_fin, dr, dk, dv,
                          dw, du, du_part, B, S, H, prof, stream);
    case 32:
      return launch_d<32>(bf16, r, k, v, w, u, ckpt, dy, ds_fin, dr, dk, dv,
                          dw, du, du_part, B, S, H, prof, stream);
    case 64:
      return launch_d<64>(bf16, r, k, v, w, u, ckpt, dy, ds_fin, dr, dk, dv,
                          dw, du, du_part, B, S, H, prof, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
