// Mamba selective scan in the JAX layout: delta, x (B, S, di), B, C
// (B, S, ds) and A (di, ds); out y (B, S, di), the scan's output before the
// D skip and the gate, and the state after the last step h_fin (B, di, ds),
// both fp32. delta, B, C and A are fp32; x is fp32 or bf16 (the model
// dtype); ds is 4, 8, 16 or 32; S is any size, di a multiple of 8 (the
// wrapper pads other widths).
//
// Replaces: src/repro/kernels/mamba_scan.py:55, mamba_scan_pallas (the JAX
// model path's time scan, models/ssm.py:126-137, computes the same
// recurrence). The Pallas kernel keeps h in VMEM scratch and asks for
// di % 512 == 0 and S % 256 == 0; here h_fin is an output, since the decode
// cache starts from it.
//
// What it computes: with h_0 = 0, for t = 0 .. S-1 and each channel i,
//   h[i][s] <- exp(delta_t[i] A[i][s]) h[i][s] + (delta_t[i] x_t[i]) B_t[s],
//   y_t[i]   = sum_s h[i][s] C_t[s].
//
// What bounds it: at the jamba prefill (B 4, S 2048, di 16384, ds 16;
// delta fp32, x bf16) it reads 537 MB of delta and 268 MB of x and writes
// 537 MB of y (B, C, A and h_fin are a few MB): 0.40 ms at 3.35 TB/s. It
// takes one exp per state element and step, 2.15 G of them: 0.51 ms at the
// special-function units' (MUFU) 16 a clock per SM (132 SMs, 1.98 GHz),
// if each exp is one MUFU instruction. Around it a state-step issues 4
// FP32 instructions (delta A, the multiply of delta x by B, two FMAs).
//
// Design: one thread per (b, channel), its ds states and its row of
// A log2(e) in registers for the whole sequence; a block holds 128
// consecutive channels of one b. Each exp is exp2 of delta (A log2 e):
// one multiply and one ex2.approx.ftz (a MUFU.EX2, max relative error
// 2^-22; the accurate expf costs ~8 FP32 instructions around its MUFU).
// The warps' issue, not the MUFU, sets the pace (the profile's 98
// scheduler cycles a warp-step are fewer than 15 MUFU.EX2 at 16 a clock
// per SM would take), and under this kernel the SM clock falls to ~1.45
// GHz (PERF.md); evaluating 1 of every 16 exps on the FMA pipe instead (a
// degree-6 polynomial, 13 issue slots) took 2% longer (tools/kernel_ab.py,
// PERF.md).
//
// Staging is off the consumer threads: a producer warp issues TMA loads of
// a chunk of TC steps of delta and x (a (TC, 128) box of each) and of B
// and C (a (TC, ds) box) into a ring of NS stages on mbarriers; the
// consumers wait on the stage's barrier, read their delta and x as
// conflict-free 32-bit and 16-bit loads and B, C as broadcast float4s, and
// store each step's y from registers (a warp's 32 channels are 128
// contiguous bytes); at the end of a chunk each warp hands the stage back
// to the producer. Staging y in the stage and storing the (TC, 128) tile by
// TMA instead held the stage a chunk longer and cost a barrier of the four
// consumer warps a chunk: 0.660 ms against 0.639 (tools/kernel_ab.py).
// h_fin goes out from registers at the end.
//
// For the backward (mamba_scan_bwd.cu), given a checkpoint buffer each
// consumer thread also stores its channel's state at the start of every
// chunk, before its steps, into ckpt (B, ceil(S / TC), di, ds) fp32 (a
// template instance of its own, so the serve path's code is unchanged).
#include "common.cuh"
#include "mamba_scan.cuh"
#include "tma.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int NC = 128;  // channels (consumer threads) a block
constexpr int NS = 3;    // stages of the ring
constexpr int THREADS = NC + 32;   // + the producer warp

template <typename T, int DS>
struct Smem {
  static constexpr int DELTA = TC * NC * 4;
  static constexpr int X = TC * NC * static_cast<int>(sizeof(T));
  static constexpr int BC = TC * DS * 4;
  static constexpr int STAGE = (DELTA + X + 2 * BC + 127) / 128 * 128;
  static constexpr int BAR_OFF = NS * STAGE;        // 2 NS mbarriers
  static constexpr int BYTES = BAR_OFF + 2 * NS * 8 + 128;  // + alignment
  static constexpr uint32_t TX = DELTA + X + 2 * BC;
};

// Profile slots (mamba_scan.py's PROFILE_SLOTS): clock64 cycles summed
// over the consumer warps (lane 0 of each) and over the producer threads,
// then the number of each.
enum {
  P_CONSUMER_WAIT, P_CONSUMER_STEPS, P_CONSUMER_CHUNK_END,
  P_PRODUCER_WAIT_EMPTY, P_PRODUCER_ISSUE, P_CONSUMER_WARPS,
  P_PRODUCER_THREADS, P_SLOTS
};

template <typename T, int DS, bool kProf, bool kCkpt>
__global__ void __launch_bounds__(THREADS, 4)
scan_kernel(const __grid_constant__ CUtensorMap tm_delta,
            const __grid_constant__ CUtensorMap tm_x,
            const __grid_constant__ CUtensorMap tm_b,
            const __grid_constant__ CUtensorMap tm_c,
            float* __restrict__ y,
            const float* __restrict__ A, float* __restrict__ h_fin,
            float* __restrict__ ckpt, int S, int di,
            unsigned long long* __restrict__ prof) {
  using M = Smem<T, DS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sm = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm + M::BAR_OFF);
  uint64_t* const empty = full + NS;
  auto sdelta = [&](int st) {
    return reinterpret_cast<float*>(sm + st * M::STAGE);
  };
  auto sx = [&](int st) {
    return reinterpret_cast<T*>(sm + st * M::STAGE + M::DELTA);
  };
  auto sb = [&](int st) {
    return reinterpret_cast<float*>(sm + st * M::STAGE + M::DELTA + M::X);
  };
  auto sc = [&](int st) { return sb(st) + TC * DS; };

  const int tid = threadIdx.x;
  const int b = blockIdx.y, c0 = blockIdx.x * NC;
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
      mbar_init(&empty[st], NC / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NC) {
    // ---- producer warp: one lane issues every load ----
    if (tid == NC) {
      for (int c = 0; c < n_chunks; ++c) {
        const int st = c % NS;
        if (c >= NS) mbar_wait(&empty[st], (c / NS - 1) & 1);
        lap(P_PRODUCER_WAIT_EMPTY);
        mbar_expect_tx(&full[st], M::TX);
        tma_load_3d(sdelta(st), &tm_delta, &full[st], c0, c * TC, b);
        tma_load_3d(sx(st), &tm_x, &full[st], c0, c * TC, b);
        tma_load_3d(sb(st), &tm_b, &full[st], 0, c * TC, b);
        tma_load_3d(sc(st), &tm_c, &full[st], 0, c * TC, b);
        lap(P_PRODUCER_ISSUE);
      }
      flush(P_PRODUCER_WAIT_EMPTY, P_PRODUCER_ISSUE, P_PRODUCER_THREADS);
    }
    return;
  }

  // ---- consumer threads: channel c0 + tid ----
  const int i = c0 + tid;
  const bool live = i < di;
  const int ic = live ? i : di - 1;        // a ragged block's spare lanes
  float a2[DS], h[DS];
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a2[s] = A[static_cast<int64_t>(ic) * DS + s] * LOG2E;
    h[s] = 0.f;
  }

  auto step = [&](const float* dp, const T* xp, const float* bt,
                  const float* ct, float* yp) {
    const float dt = dp[tid];
    const float dx = dt * to_f(xp[tid]);
    float acc = 0.f;
#pragma unroll
    for (int s4 = 0; s4 < DS; s4 += 4) {
      const float4 b4 = *reinterpret_cast<const float4*>(bt + s4);
      const float4 c4 = *reinterpret_cast<const float4*>(ct + s4);
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s4 + e;
        h[s] = fmaf(exp2_mufu(dt * a2[s]), h[s], dx * bv[e]);
        acc = fmaf(h[s], cv[e], acc);
      }
    }
    if (live) *yp = acc;
  };

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % NS, steps = min(TC, S - c * TC);
    const float* dp = sdelta(st);
    const T* xp = sx(st);
    const float* bt = sb(st);
    const float* ct = sc(st);
    float* yp = y + (static_cast<int64_t>(b) * S + c * TC) * di + i;
    if constexpr (kCkpt) {
      if (live) {
        float4* cp = reinterpret_cast<float4*>(
            ckpt + ((static_cast<int64_t>(b) * n_chunks + c) * di + i) * DS);
#pragma unroll
        for (int s = 0; s < DS; s += 4)
          cp[s / 4] = make_float4(h[s], h[s + 1], h[s + 2], h[s + 3]);
      }
    }
    mbar_wait(&full[st], (c / NS) & 1);
    lap(P_CONSUMER_WAIT);
    if (steps == TC) {             // the chunk as one block of code
#pragma unroll
      for (int tt = 0; tt < TC; ++tt)
        step(dp + tt * NC, xp + tt * NC, bt + tt * DS, ct + tt * DS,
             yp + static_cast<int64_t>(tt) * di);
    } else {
#pragma unroll 1
      for (int tt = 0; tt < steps; ++tt)
        step(dp + tt * NC, xp + tt * NC, bt + tt * DS, ct + tt * DS,
             yp + static_cast<int64_t>(tt) * di);
    }
    lap(P_CONSUMER_STEPS);
    __syncwarp();                  // the warp is done with the stage
    if ((tid & 31) == 0) mbar_arrive(&empty[st]);
    lap(P_CONSUMER_CHUNK_END);
  }
  if ((tid & 31) == 0)
    flush(P_CONSUMER_WAIT, P_CONSUMER_CHUNK_END, P_CONSUMER_WARPS);
  if (live) {
    float4* hp = reinterpret_cast<float4*>(
        h_fin + (static_cast<int64_t>(b) * di + i) * DS);
#pragma unroll
    for (int s = 0; s < DS; s += 4)
      hp[s / 4] = make_float4(h[s], h[s + 1], h[s + 2], h[s + 3]);
  }
}

template <typename T, int DS>
int launch_typed(const float* delta, const float* bm, const float* cm,
                 const void* x, const float* A, float* y, float* h_fin,
                 float* ckpt, int B, int S, int di,
                 unsigned long long* prof, cudaStream_t stream) {
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapDataType TX = sizeof(T) == 4
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long wide[3] = {di, S, B}, narrow[3] = {DS, S, B};
  const int wide_box[3] = {NC, TC, 1}, narrow_box[3] = {DS, TC, 1};
  CUtensorMap md, mx, mb, mc;
  cudaError_t err;
  if ((err = contiguous_map(&md, F32, delta, 3, wide, 4, wide_box)) !=
          cudaSuccess ||
      (err = contiguous_map(&mx, TX, x, 3, wide, sizeof(T), wide_box)) !=
          cudaSuccess ||
      (err = contiguous_map(&mb, F32, bm, 3, narrow, 4, narrow_box)) !=
          cudaSuccess ||
      (err = contiguous_map(&mc, F32, cm, 3, narrow, 4, narrow_box)) !=
          cudaSuccess)
    return err;
  constexpr int smem = Smem<T, DS>::BYTES;
  auto kernel = prof   ? scan_kernel<T, DS, true, false>
                : ckpt ? scan_kernel<T, DS, false, true>
                       : scan_kernel<T, DS, false, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((di + NC - 1) / NC, B);
  kernel<<<grid, THREADS, smem, stream>>>(md, mx, mb, mc, y, A, h_fin,
                                          ckpt, S, di, prof);
  return cudaGetLastError();
}

template <int DS>
int launch_ds(int bf16, const float* delta, const float* bm, const float* cm,
              const void* x, const float* A, float* y, float* h_fin,
              float* ckpt, int B, int S, int di, unsigned long long* prof,
              cudaStream_t stream) {
  if (bf16)
    return launch_typed<__nv_bfloat16, DS>(delta, bm, cm, x, A, y, h_fin,
                                           ckpt, B, S, di, prof, stream);
  return launch_typed<float, DS>(delta, bm, cm, x, A, y, h_fin, ckpt, B, S,
                                 di, prof, stream);
}

}  // namespace

REPRO_ERROR_STRING(mamba_scan)

// ckpt: null, or (B, ceil(S / TC), di, ds) fp32 for the chunk-start
// states; prof: null, or P_SLOTS zeroed counters that a profiled launch
// adds to
extern "C" int mamba_scan_launch(const float* delta, const float* bm,
                                 const float* cm, const void* x,
                                 const float* A, float* y, float* h_fin,
                                 float* ckpt, int B, int S, int di, int ds,
                                 int bf16, unsigned long long* prof,
                                 cudaStream_t stream) {
  if (B <= 0 || S <= 0 || di <= 0 || di % 8 || B > 65535)
    return cudaErrorInvalidValue;
  switch (ds) {
    case 4:
      return launch_ds<4>(bf16, delta, bm, cm, x, A, y, h_fin, ckpt, B, S, di,
                          prof, stream);
    case 8:
      return launch_ds<8>(bf16, delta, bm, cm, x, A, y, h_fin, ckpt, B, S, di,
                          prof, stream);
    case 16:
      return launch_ds<16>(bf16, delta, bm, cm, x, A, y, h_fin, ckpt, B, S, di,
                           prof, stream);
    case 32:
      return launch_ds<32>(bf16, delta, bm, cm, x, A, y, h_fin, ckpt, B, S, di,
                           prof, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
