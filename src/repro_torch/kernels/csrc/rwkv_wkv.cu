// RWKV6 "Finch" WKV recurrence in the JAX layout: r, k, v and w
// (B, S, H, d), u (H, d); out y (B, S, H, d) and the state after the last
// step S_fin (B, H, d, d), both fp32. r, k and v are fp32 or bf16 (the
// model dtype), w and u fp32, d in {16, 32, 64}.
//
// Replaces: src/repro/kernels/rwkv_wkv.py:54, rwkv_wkv_pallas (the JAX
// model path's time scan, models/ssm.py:253-262, computes the same
// recurrence). The Pallas kernel keeps S_fin in scratch; here it is an
// output, since the decode cache starts from it.
//
// What it computes: with S_0 = 0, for t = 0 .. S-1,
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j]),
//   S[i][j] <- S[i][j] w_t[i] + k_t[i] v_t[j],
// in the equal form y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] c_t with
// c_t = sum_i r_t[i] u[i] k_t[i], so that each (i, j) costs one FMA for y
// and a multiply and an FMA for S: 5 flops, 3 instructions.
//
// What bounds it: at the rwkv6-7b prefill (B 4, S 2048, H 64, d 64, r/k/v
// bf16) it moves 474 MB (0.14 ms at 3.35 TB/s) and does 5 B H S d^2 =
// 10.7 GFLOP (0.16 ms at the fp32 peak). The 2048 steps of a head run in
// series, so only the FP32 pipe's issue can be shared out: 3 instructions
// per state element and step, 2 heads an SM, ~0.19 ms at 1.98 GHz. What
// else a step issues (shared loads of r, k, w and v, the sum of y over the
// rows, staging) comes on top of that.
//
// Design: one block per (b, h); its (d, d) state stays in fp32 registers
// of 4 consumer warps (at d 64) for the whole sequence, each warp holding
// 16 columns. A thread holds R = 8 rows of C = 4 columns (at d 32, 4 rows;
// at d 16, 4 rows of 2 columns), so each float4 of r, k and w it loads
// from shared memory feeds 12 FP32 instructions (at 8 rows of 2 columns:
// 6). The 8 row groups of a column lie in one warp, group g in lanes
// 4g .. 4g + 3; group g holds the float4s g, g + 8, ... of the rows, so
// one warp-wide LDS.128 reads 8 consecutive float4s (128 bytes, no bank
// conflict). The sum of y over the rows is a reduce-scatter over the
// groups in registers (4 shuffles a step, fixed order; the lanes of the
// upper half warp hold their 4 columns in the order 2, 3, 0, 1, so that
// its first level needs no selects: 2% of the kernel's time), after which
// one lane of each pair holds a whole y_t[j]; it adds v_t[j] c_t (v_t[j]
// from its own registers, not shared memory: 4% of the kernel's time) and
// writes y into the warp's (TC, 16) tile, which its lane 0 stores by TMA
// once per chunk: no partial sums in shared memory and no barrier between
// the consumer warps (stored to device memory each step instead, without
// the chunk's fence, y cost 0.509 ms against 0.419). A chunk's TC steps
// are one unrolled block of code, so the compiler lays a step's shuffles
// beside the next steps' products.
// Why 4 warps of 32 states a thread and not 2 of 64: every FP32
// instruction here reads two registers besides a reused one, and the
// profile (rwkv_wkv_cycles, PERF.md) shows a warp alone on its scheduler
// issuing ~0.5 instructions a clock, two warps ~0.7; the loads per FMA
// this costs are cheap beside that.
//
// Staging is off the consumer warps: two producer warps (so that each of
// the SM's four schedulers runs two consumer warps and one producer warp
// of the two blocks an SM holds) take a chunk's steps half each. The
// first issues TMA loads of each chunk's r, k, v (in their dtype) and w
// (fp32) into a ring of NS stages on mbarriers; both widen r, k and v to
// fp32 and sum c_t one chunk ahead (4 columns a lane, then one lane a step
// in a fixed order) and arrive on the stage's full barrier; the consumers
// wait on that barrier and release the stage on its empty barrier. A
// ragged last chunk is zero-filled by the tensor maps and its steps past S
// are neither run nor stored. S_fin goes out from registers at the end.
//
// For the backward (rwkv_wkv_bwd.cu), given a checkpoint buffer the
// consumers also store the state at the start of every chunk, before its
// steps, into ckpt (B, H, ceil(S / TC), d, d) fp32, as they store S_fin (a
// template instance of its own, so the serve path's code is unchanged).
#include "common.cuh"
#include "rwkv_wkv.cuh"
#include "tma.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int NS = 4;    // stages of the ring
constexpr int NP = 2;    // producer warps, TC / NP steps of a chunk each
constexpr int YC = 16;   // columns a consumer warp holds

template <int D>
struct Layout {
  static constexpr int G = D >= 32 ? 8 : 4;     // row groups in a warp
  static constexpr int C = YC * G / 32;          // state columns a thread
  static constexpr int R = D / G;                // state rows a thread
  static constexpr int CW = D / YC;              // consumer warps
  static constexpr int THREADS = 32 * (CW + NP);
};

template <typename T, int D>
struct Smem {
  static constexpr bool WIDEN = sizeof(T) != 4;          // bf16 r, k, v
  static constexpr int TILE = TC * D * 4;                // an fp32 tile
  static constexpr int RAW = WIDEN ? TC * D * 2 : 0;     // a bf16 tile
  static constexpr int QP = D / 4;                       // quads a step
  // a stage: fp32 r, k, v, w tiles, raw r, k, v, the chunk's c_t
  static constexpr int C_OFF = 4 * TILE + 3 * RAW;
  static constexpr int STAGE = (C_OFF + TC * 4 + 127) / 128 * 128;
  static constexpr int Y_OFF = NS * STAGE;   // y tiles [2][CW][TC][YC]
  static constexpr int PART_OFF = Y_OFF + 2 * TC * D * 4;  // [TC][QP + 1]
  static constexpr int BAR_OFF = (PART_OFF + TC * (QP + 1) * 4 + 7) / 8 * 8;
  static constexpr int BYTES = BAR_OFF + 3 * NS * 8 + 128;  // + alignment
  static constexpr uint32_t TX = TC * D * (3 * sizeof(T) + 4);
};

// Profile slots (rwkv_wkv.py's PROFILE_SLOTS): clock64 cycles summed over
// the consumer warps (lane 0 of each) and over the producer warps, then
// the number of each.
enum {
  P_CONSUMER_WAIT, P_CONSUMER_STEPS, P_CONSUMER_CHUNK_END,
  P_PRODUCER_WAIT_LOADED, P_PRODUCER_WIDEN, P_PRODUCER_C_SUM,
  P_PRODUCER_REFILL, P_CONSUMER_WARPS, P_PRODUCER_WARPS, P_SLOTS
};

// four bf16 (8 bytes) or fp32 (16 bytes) values as fp32
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}

template <typename T, int D, bool kProf, bool kCkpt>
__global__ void __launch_bounds__(Layout<D>::THREADS)
wkv_kernel(const __grid_constant__ CUtensorMap tm_r,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           const __grid_constant__ CUtensorMap tm_w,
           const __grid_constant__ CUtensorMap tm_y,
           const float* __restrict__ u, float* __restrict__ s_fin,
           float* __restrict__ ckpt, int S, int H,
           unsigned long long* __restrict__ prof) {
  using L = Layout<D>;
  using M = Smem<T, D>;
  constexpr int G = L::G, C = L::C, R = L::R, CW = L::CW, QP = M::QP;
  constexpr int TH = TC / NP;                     // steps a producer widens
  constexpr int NQ = TH * QP / 32;                // quads a producer lane
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* const loaded = reinterpret_cast<uint64_t*>(sm + M::BAR_OFF);
  uint64_t* const full = loaded + NS;
  uint64_t* const empty = full + NS;
  auto tile = [&](int st, int which) {   // fp32 r, k, v, w of a stage
    return reinterpret_cast<float*>(sm + st * M::STAGE + which * M::TILE);
  };
  auto raw = [&](int st, int which) {    // T r, k, v as loaded
    return reinterpret_cast<T*>(M::WIDEN ? sm + st * M::STAGE + 4 * M::TILE +
                                               which * M::RAW
                                         : sm + st * M::STAGE +
                                               which * M::TILE);
  };
  auto ct = [&](int st) {
    return reinterpret_cast<float*>(sm + st * M::STAGE + M::C_OFF);
  };
  float* const ybuf = reinterpret_cast<float*>(sm + M::Y_OFF);
  float* const part = reinterpret_cast<float*>(sm + M::PART_OFF);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
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
      mbar_init(&full[st], 32 * NP);
      mbar_init(&empty[st], 32 * CW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CW) {
    // ---- producer warps: warp p widens steps p TH .. p TH + TH - 1 ----
    const int p = warp - CW;
    auto issue = [&](int c) {   // chunk c into stage c % NS
      const int st = c % NS;
      mbar_expect_tx(&loaded[st], M::TX);
      tma_load_3d(raw(st, 0), &tm_r, &loaded[st], h * D, c * TC, b);
      tma_load_3d(raw(st, 1), &tm_k, &loaded[st], h * D, c * TC, b);
      tma_load_3d(raw(st, 2), &tm_v, &loaded[st], h * D, c * TC, b);
      tma_load_3d(tile(st, 3), &tm_w, &loaded[st], h * D, c * TC, b);
    };
    if (p == 0 && lane == 0)
      for (int c = 0; c < NS && c < n_chunks; ++c) issue(c);
    // lane l widens columns i .. i + 3 of the steps p TH + (l + 32 n) / QP
    const int i = 4 * (lane % QP);
    const float4 u4 = *reinterpret_cast<const float4*>(u + h * D + i);
    float* const pp = part + p * TH * (QP + 1);
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % NS;
      mbar_wait(&loaded[st], (c / NS) & 1);
      lap(P_PRODUCER_WAIT_LOADED);
      float4 r4[NQ], k4[NQ], v4[NQ];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {             // every load, then stores
        const int e = (p * TH + (lane + 32 * n) / QP) * D + i;
        r4[n] = widen4(raw(st, 0) + e);
        k4[n] = widen4(raw(st, 1) + e);
        if (M::WIDEN) v4[n] = widen4(raw(st, 2) + e);
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int q = lane + 32 * n, e = (p * TH + q / QP) * D + i;
        if (M::WIDEN) {
          *reinterpret_cast<float4*>(tile(st, 0) + e) = r4[n];
          *reinterpret_cast<float4*>(tile(st, 1) + e) = k4[n];
          *reinterpret_cast<float4*>(tile(st, 2) + e) = v4[n];
        }
        float cp = r4[n].x * u4.x * k4[n].x;
        cp = fmaf(r4[n].y * u4.y, k4[n].y, cp);
        cp = fmaf(r4[n].z * u4.z, k4[n].z, cp);
        pp[(q / QP) * (QP + 1) + q % QP] = fmaf(r4[n].w * u4.w, k4[n].w, cp);
      }
      __syncwarp();
      lap(P_PRODUCER_WIDEN);
      if (lane < TH) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < QP; ++j) acc += pp[lane * (QP + 1) + j];
        ct(st)[p * TH + lane] = acc;
      }
      __syncwarp();
      mbar_arrive(&full[st]);
      lap(P_PRODUCER_C_SUM);
      // the first refills the stage of chunk c - 1 once the consumers are
      // done with it (the other's next wait on `loaded` follows from that)
      if (p == 0 && c >= 1 && c - 1 + NS < n_chunks) {
        mbar_wait(&empty[(c - 1) % NS], ((c - 1) / NS) & 1);
        if (lane == 0) issue(c - 1 + NS);
      }
      lap(P_PRODUCER_REFILL);
    }
    flush(P_PRODUCER_WAIT_LOADED, P_PRODUCER_REFILL, P_PRODUCER_WARPS);
    return;
  }

  // ---- consumer warps: warp w holds columns 16 w .. 16 w + 15 ----
  constexpr int CG = 32 / G;                     // column groups a warp
  const int g = lane / CG;                       // row group
  const int col0 = (lane % CG) * C;              // in the warp's 16
  // after the reduce-scatter the lanes of group bits (4, 3) hold column
  // col0 + 2 bit4 + bit3 (C 4) or col0 + bit4 (C 2), written by one lane
  const bool hi4 = lane & 16, hi3 = lane & 8, hi2 = lane & 4;
  const int ycol = C == 4 ? col0 + 2 * hi4 + hi3 : col0 + hi4;
  const bool writer = C == 4 ? !hi2 : !hi3;
  const int hc = warp * YC;                      // the warp's first column
  // S[4 (G m + g) + e][hc + col0 + (x ^ 2 hi4)] (C 4; C 2: + x)
  float st_reg[R * C];
#pragma unroll
  for (int e = 0; e < R * C; ++e) st_reg[e] = 0.f;

  auto step = [&](const float* rt, const float* kt, const float* vt,
                  const float* wt, float c_t, float* yt) {
    float vv[C];
    if constexpr (C == 4) {
      // register x holds column col0 + (x ^ 2 hi4)
      const float2 va = *reinterpret_cast<const float2*>(vt + hc + col0 +
                                                          2 * hi4);
      const float2 vb = *reinterpret_cast<const float2*>(vt + hc + col0 +
                                                          2 - 2 * hi4);
      vv[0] = va.x; vv[1] = va.y; vv[2] = vb.x; vv[3] = vb.y;
    } else {
      const float2 v2 = *reinterpret_cast<const float2*>(vt + hc + col0);
      vv[0] = v2.x; vv[1] = v2.y;
    }
    float a[C];
#pragma unroll
    for (int x = 0; x < C; ++x) a[x] = 0.f;
#pragma unroll
    for (int m = 0; m < R / 4; ++m) {
      const int i4 = 4 * (G * m + g);
      const float4 r4 = *reinterpret_cast<const float4*>(rt + i4);
      const float4 k4 = *reinterpret_cast<const float4*>(kt + i4);
      const float4 w4 = *reinterpret_cast<const float4*>(wt + i4);
      const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int x = 0; x < C; ++x) {
          float& s = st_reg[(4 * m + e) * C + x];
          a[x] = fmaf(rr[e], s, a[x]);
          s = fmaf(s, ww[e], kk[e] * vv[x]);
        }
    }
    // reduce-scatter over the row groups: lane bit 4, bit 3, then bit 2
    float y;
    if constexpr (C == 4) {
      const float k0 = a[0] + __shfl_xor_sync(FULL_MASK, a[2], 16);
      const float k1 = a[1] + __shfl_xor_sync(FULL_MASK, a[3], 16);
      float kk = hi3 ? k1 : k0;
      kk += __shfl_xor_sync(FULL_MASK, hi3 ? k0 : k1, 8);
      y = kk + __shfl_xor_sync(FULL_MASK, kk, 4);
    } else {
      float k0 = hi4 ? a[1] : a[0];
      k0 += __shfl_xor_sync(FULL_MASK, hi4 ? a[0] : a[1], 16);
      y = k0 + __shfl_xor_sync(FULL_MASK, k0, 8);
    }
    // v_t[ycol] is one of the lane's own columns: vv[hi3] (C 4), vv[hi4]
    if (writer) yt[ycol] = fmaf(C == 4 ? (hi3 ? vv[1] : vv[0])
                                       : (hi4 ? vv[1] : vv[0]), c_t, y);
  };

  // the state in registers to (row, column) of a (D, D) block at `base`
  auto store_state = [&](float* base) {
    float* sf = base + hc + col0;
#pragma unroll
    for (int m = 0; m < R / 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 4 * (G * m + g) + e;
        const float* sv = st_reg + (4 * m + e) * C;
        if constexpr (C == 4) {
          *reinterpret_cast<float2*>(sf + row * D + 2 * hi4) =
              make_float2(sv[0], sv[1]);
          *reinterpret_cast<float2*>(sf + row * D + 2 - 2 * hi4) =
              make_float2(sv[2], sv[3]);
        }
        else
          *reinterpret_cast<float2*>(sf + row * D) = make_float2(sv[0], sv[1]);
      }
  };

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % NS, steps = min(TC, S - c * TC);
    if constexpr (kCkpt)
      store_state(ckpt + ((static_cast<int64_t>(b) * H + h) * n_chunks + c) *
                             D * D);
    const float* fr = tile(st, 0);
    const float* fk = tile(st, 1);
    const float* fv = tile(st, 2);
    const float* fw = tile(st, 3);
    const float* cs = ct(st);
    float* yt = ybuf + ((c & 1) * CW + warp) * TC * YC;
    mbar_wait(&full[st], (c / NS) & 1);
    lap(P_CONSUMER_WAIT);
    if (steps == TC) {
      // the whole chunk in one block of code, so that the compiler lays a
      // step's shuffles and y beside the next steps' products (unrolled
      // by 2 instead, the kernel took 0.585 ms against 0.429)
#pragma unroll
      for (int tt = 0; tt < TC; ++tt)
        step(fr + tt * D, fk + tt * D, fv + tt * D, fw + tt * D, cs[tt],
             yt + tt * YC);
    } else {                       // a ragged last chunk
#pragma unroll 1
      for (int tt = 0; tt < steps; ++tt)
        step(fr + tt * D, fk + tt * D, fv + tt * D, fw + tt * D, cs[tt],
             yt + tt * YC);
    }
    lap(P_CONSUMER_STEPS);
    mbar_arrive(&empty[st]);
    fence_proxy_async();           // this lane's y, seen by the TMA store
    __syncwarp();
    if (lane == 0) {
      tma_store_3d(&tm_y, yt, h * D + hc, c * TC, b);
      bulk_commit();
      // the store of chunk c - 1 has read the tile chunk c + 1 reuses
      bulk_wait_read<1>();
    }
    __syncwarp();
    lap(P_CONSUMER_CHUNK_END);
  }
  flush(P_CONSUMER_WAIT, P_CONSUMER_CHUNK_END, P_CONSUMER_WARPS);
  if (lane == 0) bulk_wait<0>();
  store_state(s_fin + (static_cast<int64_t>(b) * H + h) * D * D);
}

// a (B, S, H d) tensor of `type` as a map of (cols, TC, 1) boxes
cudaError_t head_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, int elem_bytes, int B, int S, int H,
                     int D, int cols) {
  const long long dims[3] = {static_cast<long long>(H) * D, S, B};
  const int box[3] = {cols, TC, 1};
  return contiguous_map(map, type, base, 3, dims, elem_bytes, box);
}

template <typename T, int D>
int launch_typed(const void* r, const void* k, const void* v, const float* w,
                 const float* u, float* y, float* s_fin, float* ckpt, int B,
                 int S, int H, unsigned long long* prof,
                 cudaStream_t stream) {
  constexpr CUtensorMapDataType TT = sizeof(T) == 4
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr int ES = static_cast<int>(sizeof(T));
  CUtensorMap mr, mk, mv, mw, my;
  cudaError_t err;
  if ((err = head_map(&mr, TT, r, ES, B, S, H, D, D)) != cudaSuccess ||
      (err = head_map(&mk, TT, k, ES, B, S, H, D, D)) != cudaSuccess ||
      (err = head_map(&mv, TT, v, ES, B, S, H, D, D)) != cudaSuccess ||
      (err = head_map(&mw, F32, w, 4, B, S, H, D, D)) != cudaSuccess ||
      (err = head_map(&my, F32, y, 4, B, S, H, D, YC)) != cudaSuccess)
    return err;
  constexpr int smem = Smem<T, D>::BYTES;
  auto kernel = prof   ? wkv_kernel<T, D, true, false>
                : ckpt ? wkv_kernel<T, D, false, true>
                       : wkv_kernel<T, D, false, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, Layout<D>::THREADS, smem, stream>>>(mr, mk, mv, mw, my, u,
                                                      s_fin, ckpt, S, H,
                                                      prof);
  return cudaGetLastError();
}

template <int D>
int launch_d(int bf16, const void* r, const void* k, const void* v,
             const float* w, const float* u, float* y, float* s_fin,
             float* ckpt, int B, int S, int H, unsigned long long* prof,
             cudaStream_t stream) {
  if (bf16)
    return launch_typed<__nv_bfloat16, D>(r, k, v, w, u, y, s_fin, ckpt, B,
                                          S, H, prof, stream);
  return launch_typed<float, D>(r, k, v, w, u, y, s_fin, ckpt, B, S, H,
                                prof, stream);
}

}  // namespace

REPRO_ERROR_STRING(rwkv_wkv)

// ckpt: null, or (B, H, ceil(S / TC), d, d) fp32 for the chunk-start
// states; prof: null, or P_SLOTS zeroed counters that a profiled launch
// adds to
extern "C" int rwkv_wkv_launch(const void* r, const void* k, const void* v,
                               const float* w, const float* u, float* y,
                               float* s_fin, float* ckpt, int B, int S,
                               int H, int d, int bf16,
                               unsigned long long* prof,
                               cudaStream_t stream) {
  if (B <= 0 || S <= 0 || H <= 0) return cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return launch_d<16>(bf16, r, k, v, w, u, y, s_fin, ckpt, B, S, H, prof,
                          stream);
    case 32:
      return launch_d<32>(bf16, r, k, v, w, u, y, s_fin, ckpt, B, S, H, prof,
                          stream);
    case 64:
      return launch_d<64>(bf16, r, k, v, w, u, y, s_fin, ckpt, B, S, H, prof,
                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}
