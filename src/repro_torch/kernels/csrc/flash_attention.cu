// Causal / sliding-window / soft-capped attention with an online softmax,
// in the JAX layout: q (B, S, H, d), k and v (B, S, KV, d), o (B, S, H, d),
// bf16 or fp32, d in {32, 64, 112, 128}. GQA is read in place: query head
// h reads KV head h / (H / KV), with no repeated copy of k and v.
//
// Replaces: src/repro/kernels/flash_attention.py:85, flash_attention_pallas
// (and the model path's flash_attention_jax, models/layers.py:149).
//
// What it computes, as both JAX versions do: fp32 scores q.k / sqrt(d),
// the optional tanh soft cap, masked scores -1e30, a running max m, sum l
// and accumulator acc per query row over KV tiles (p = exp(s - m_new),
// corr = exp(m - m_new)), and o = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: operations. At the LM serve shapes (B 4, S 2048, H 32,
// KV 4, d 128, causal) the causal pairs need 4 B H d S^2/2 ~ 137 GFLOP
// against ~151 MB of q, k, v and o: 0.139 ms at the 989 TFLOP/s bf16
// tensor-core peak (2.05 ms at the 67 TFLOP/s fp32 peak for fp32 inputs),
// 0.045 ms of bytes. Only wgmma reaches the bf16 peak on Hopper, and only
// if the tiles' loads overlap the products.
//
// Both paths skip the KV tiles above the causal diagonal or before the
// window (the Pallas kernel's block-triangular skip) and take the
// heaviest causal query tiles first. Keys past S score -1e30.
//
// bf16 (the serve path; flash_bf16), warp-specialised and persistent: one
// block of three warpgroups per SM walks the (head, batch, 128-query tile)
// items, heaviest first. Warpgroup 2 is the producer: one thread issues
// TMA loads (cp.async.bulk.tensor, 3-d tensor maps over (d * heads, S, B),
// so rows past S of one batch read as zeros and never as the next
// batch's; GQA's KV head by the column coordinate kvh * d) of each item's
// Q tile into one of two buffers and of its K and V tiles of 128 keys into
// a ring of STAGES stages, with full and empty mbarriers whose phases run
// on across items, so one item's loads overlap the end of the last; it
// gives its registers to the consumers (setmaxnreg). Warpgroups 0 and 1
// each own 64 query rows: S = Q.K^T by wgmma m64n128k16 with both
// operands in shared memory (K-major, 128-byte swizzle; 64-byte at d 32,
// whose rows are 64 bytes), then the online softmax in fp32 registers,
// then O += P.V by wgmma with P in registers as the A operand (the
// accumulator layout of S is the register layout of A) and V from shared
// memory MN-major (the transpose bit). Each step issues S_i and
// P_{i-1}.V_{i-1} together and runs tile i's softmax while P.V runs; the
// two warpgroups take turns at issuing (named barriers), so one's softmax
// overlaps the other's products. The softmax works in log2 units: ex2 on
// scores pre-scaled by 1/sqrt(d) * log2(e), folded into one FMA on the
// tiles that need no mask; only the tiles that cross the causal diagonal,
// the window's edge or the ragged end at S test each score (a masked
// score, -1e30, gives p = 1 while the row's max is still -1e30, and the
// first live score wipes it with corr = 0, as in the plain version). The
// soft cap is exact: tanh of the scaled score. Row max and sum reduce over
// the 4 lanes that hold a row; one reciprocal of l per row at the end. P
// rounded once to bf16 would move an output by up to a bf16 ulp of it
// (0.0156 measured against the 0.02 bound), so P.V runs on bf16 hi and lo
// parts of P (lo = P - hi, rounded: P keeps ~16 bits), two wgmmas back to
// back on one accumulator and one V descriptor: the tensor work is 1.5x
// the bound's, and the output agrees with the fp32 plain version but for
// its final rounding to bf16. What sets the pace on the H100 (the stage
// profile, flash_stage_cycles): the consumers' softmax and P conversion,
// about half their cycles, then their issue of products, which waits for
// the other warpgroup's products to leave the tensor pipe.
//
// d 112 (kimi-k2's heads) is no multiple of the 64 bf16 of a 128-byte
// swizzle row, and a 224-byte row fits no one box. The bf16 kernel keeps
// its tiles 128 wide (tile_dim in wgmma.cuh): a head's two column blocks
// are boxes of 64 columns at h * 112 and h * 112 + 64, so the second reads
// 16 columns past the head (the next head's, or zeros past the last one,
// TMA's fill). Q.K^T runs 7 k-steps of 16 and never reads them; P.V runs
// at N 128, and they feed only output columns 112-127, which the epilogue
// does not store. The tensor work is 128/112 of what the head needs, the
// loads of K and V 8/7: the simplest correct form, not yet a fast one.
// The fp32 kernel takes d 112 as it is (28 float4 reads a row, 7 output
// dims a thread).
//
// For the backward (flash_attention_bwd.cu) either kernel also writes each
// query row's log-sum-exp of its scaled (and capped) scores, m + log(l) in
// natural units, into lse (B, H, S) fp32 when given a pointer; given null
// (the serve path) it writes nothing and computes what it did before.
//
// fp32 (flash_fp32): fp32 FMAs on the CUDA cores, q cast and scaled before
// the product as in JAX. One block per (head, batch, 64-query tile), 256
// threads as a 16 x 16 grid: thread (ty, tx) owns query rows 4ty..4ty+3,
// scores them against keys tx and tx + 16 of a 32-key tile over float4
// reads, keeps m and l in registers (reduced over the 16 lanes that share
// a row), writes p to shared memory and accumulates output dims tx,
// tx + 16, ... of its rows.
#include "common.cuh"
#include "wgmma.cuh"       // swizzle, descriptors, wgmma, TMA (tma.cuh)

#include <cuda_bf16.h>

namespace {

constexpr float NEG = -1e30f;

// the first KV tile start (a multiple of bk) that the window leaves to
// query tile q0: tiles with q0 - (k0 + bk - 1) >= window are skipped
__device__ __forceinline__ int first_kv_tile(int q0, int window, int bk) {
  if (window <= 0) return 0;
  const int lo = q0 - window - bk + 2;
  return lo > 0 ? (lo + bk - 1) / bk * bk : 0;
}

__device__ __forceinline__ bool live(int qp, int kp, int S, int causal,
                                     int window) {
  bool ok = kp < S;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

constexpr int TQ = 128;          // query rows per block: 2 warpgroups x 64
constexpr int TK = 128;          // keys per KV tile
constexpr int STAGES = 2;        // K and V stages in the ring
constexpr int BF16_THREADS = 384;  // consumer warpgroups 0, 1; producer 2
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// slots of the optional stage profile (summed cycles, flash_stage_cycles
// in flash_attention.py): a consumer warpgroup's waits for K and V, for
// its turn, its issue of products, its waits for them, its softmax, its
// output; the producer's waits for free stages and its whole run
enum {
  PROF_DATA, PROF_TURN, PROF_ISSUE_QK, PROF_ISSUE_PV, PROF_PRODUCTS,
  PROF_SOFTMAX, PROF_EPILOGUE, PROF_STAGES,
  PROF_PRODUCER_BLOCKED = PROF_STAGES, PROF_PRODUCER, PROF_SLOTS
};

// a Q or K/V tile's bytes in shared memory (and a TMA load's: every box
// counts whole, its columns past the tensor's edge too)
template <int HD>
__host__ __device__ constexpr int q_bytes() { return TQ * tile_dim<HD>() * 2; }
template <int HD>
__host__ __device__ constexpr int kv_bytes() {
  return TK * tile_dim<HD>() * 2;
}
template <int HD>
constexpr size_t bf16_smem_bytes() {
  return 1024 + 2 * q_bytes<HD>() + STAGES * 2 * kv_bytes<HD>();  // + align
}

// One consumer warpgroup's softmax step on its 64 x TK scores, in place
// (this thread's rows qp0 and qp0 + 8, wgmma accumulator layout: s[4i + e]
// is column 8i + 2 (lane % 4) + (e & 1) of row qp0 + 8 (e >> 1)): p = exp2
// of the scaled score less the new row max; l and m updated, and each
// row's rescale of the output accumulator returned in corr. `c` scales a
// score into log2 units; MASK tiles test each score.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[TK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float c,
                                             int qp0, int k0, int S,
                                             int causal, int window) {
  const int tig = threadIdx.x & 3;
  if constexpr (MASK) {
#pragma unroll
    for (int j = 0; j < TK / 2; ++j) {
      const int kp = k0 + 8 * (j >> 2) + 2 * tig + (j & 1);
      const int qp = qp0 + 8 * ((j >> 1) & 1);
      s[j] = live(qp, kp, S, causal, window) ? s[j] * c : NEG;
    }
    c = 1.f;
  }
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < TK / 2; ++j)
    mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL_MASK, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * c);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    mc[r] = -m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < TK / 2; ++j) {
    s[j] = ex2(fmaf(s[j], c, mc[(j >> 1) & 1]));
    sum[(j >> 1) & 1] += s[j];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(FULL_MASK, sum[r], 1);
    sum[r] += __shfl_xor_sync(FULL_MASK, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
}

// The two consumer warpgroups take turns at issuing their products, so
// that one's softmax runs while the other's products run: warpgroup wg
// waits on named barrier 1 + wg, which the other arrives at when it has
// issued its own.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg) : "memory");
}

// One work item: the 128-query tile of one (head, batch); items are
// numbered heaviest causal tile first, heads fastest (the heads that share
// a KV head run side by side)
struct Item {
  int h, b, q0, kvh, k_begin, tiles;
};

__device__ __forceinline__ Item item_at(int w, int S, int H, int KV, int B,
                                        int causal, int window) {
  Item it;
  const int q_tiles = (S + TQ - 1) / TQ;
  it.h = w % H;
  it.b = (w / H) % B;
  it.q0 = (q_tiles - 1 - w / (H * B)) * TQ;
  it.kvh = it.h / (H / KV);
  it.k_begin = first_kv_tile(it.q0, window, TK);
  const int k_end = causal ? min(S, it.q0 + TQ) : S;
  it.tiles = (k_end - it.k_begin + TK - 1) / TK;
  return it;
}

// Persistent: block i takes items i, i + gridDim.x, ...; the ring and the
// barriers' phases run on across items, and Q is double-buffered, so an
// item's loads overlap the end of the one before.
template <int HD, bool PROFILE>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_bf16(const __grid_constant__ CUtensorMap tm_q,
           const __grid_constant__ CUtensorMap tm_k,
           const __grid_constant__ CUtensorMap tm_v,
           __nv_bfloat16* __restrict__ o, int B, int S, int H, int KV,
           int causal, int window, float softcap, float scale,
           float* __restrict__ lse, unsigned long long* __restrict__ prof) {
  constexpr int SWB = swz_bytes<HD>(), SWE = swz_elems<HD>();
  constexpr int NCB = col_blocks<HD>(), TD = tile_dim<HD>();
  constexpr uint64_t LAYOUT = swz_layout<HD>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t q_full[2], q_empty[2], k_full[STAGES], v_full[STAGES],
      k_empty[STAGES], v_empty[STAGES];
  // tiles start on 1024-byte boundaries, the 128-byte swizzle's period
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  // Q buffer qb: NCB blocks of TQ rows x SWB bytes; then the K, V stages
  auto Qs = [&](int qb) { return smem + qb * q_bytes<HD>(); };
  auto Ks = [&](int st) {
    return smem + 2 * q_bytes<HD>() + st * 2 * kv_bytes<HD>();
  };
  auto Vs = [&](int st) { return Ks(st) + kv_bytes<HD>(); };
  const int items = H * B * ((S + TQ - 1) / TQ);

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(&q_full[qb], 1);
      mbar_init(&q_empty[qb], 8);      // one arrival per consumer warp
    }
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], 8);
      mbar_init(&v_empty[st], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full --------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      const long long t_start = PROFILE ? clock64() : 0;
      long long t_blocked = 0;
      int T = 0;                       // K and V tiles loaded so far
      for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
        const Item it = item_at(w, S, H, KV, B, causal, window);
        const int qb = n & 1;
        long long t0 = PROFILE ? clock64() : 0;
        mbar_wait(&q_empty[qb], ((n >> 1) & 1) ^ 1);
        if (PROFILE) t_blocked += clock64() - t0;
        mbar_expect_tx(&q_full[qb], q_bytes<HD>());
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_3d(Qs(qb) + cb * TQ * SWB, &tm_q, &q_full[qb],
                      it.h * HD + cb * SWE, it.q0, it.b);
        for (int i = 0; i < it.tiles; ++i, ++T) {
          const int st = T % STAGES, k0 = it.k_begin + i * TK;
          const int free_par = ((T / STAGES) & 1) ^ 1;
          t0 = PROFILE ? clock64() : 0;
          mbar_wait(&k_empty[st], free_par);
          mbar_expect_tx(&k_full[st], kv_bytes<HD>());
#pragma unroll
          for (int cb = 0; cb < NCB; ++cb)
            tma_load_3d(Ks(st) + cb * TK * SWB, &tm_k, &k_full[st],
                        it.kvh * HD + cb * SWE, k0, it.b);
          mbar_wait(&v_empty[st], free_par);
          if (PROFILE) t_blocked += clock64() - t0;
          mbar_expect_tx(&v_full[st], kv_bytes<HD>());
#pragma unroll
          for (int cb = 0; cb < NCB; ++cb)
            tma_load_3d(Vs(st) + cb * TK * SWB, &tm_v, &v_full[st],
                        it.kvh * HD + cb * SWE, k0, it.b);
        }
      }
      if (PROFILE) {
        atomicAdd(&prof[PROF_PRODUCER_BLOCKED],
                  static_cast<unsigned long long>(t_blocked));
        atomicAdd(&prof[PROF_PRODUCER],
                  static_cast<unsigned long long>(clock64() - t_start));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    // Each step issues S_i = Q.K_i^T and O += P_{i-1}.V_{i-1} together,
    // then runs tile i's softmax while the P.V product is in flight.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const float c = softcap > 0.f ? 1.f : scale * LOG2E;
    const float cap_in = scale / softcap, cap_out = softcap * LOG2E;
    // acc holds TD columns; those past HD (d 112) are never stored
    float m[2], l[2], corr[2], acc[TD / 2], s[TK / 2];
    uint32_t phi[TK / 16][4], plo[TK / 16][4];
    // with a profile buffer, thread 0 of each consumer warpgroup charges
    // the cycles since its last mark to a stage
    const bool timed = PROFILE && (threadIdx.x & 127) == 0;
    long long stage_cycles[PROF_STAGES] = {}, t_last = timed ? clock64() : 0;
    auto mark = [&](int stage) {
      if (PROFILE && timed) {
        const long long now = clock64();
        stage_cycles[stage] += now - t_last;
        t_last = now;
      }
    };
    auto full_par = [](int t) { return (t / STAGES) & 1; };
    // V (B of P.V): MN-major, column blocks of SWE dims TK * SWB apart,
    // 8-key groups 8 SWB apart; a 16-key step moves 16 rows. P's hi and
    // lo parts go back to back into one accumulator.
    auto issue_pv = [&](int t) {
      const uint32_t v_addr = smem_u32(Vs(t % STAGES));
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint64_t dv = gmma_desc(v_addr + kk * 16 * SWB, TK * SWB,
                                      8 * SWB, LAYOUT);
        wgmma_rs_d<TD>(acc, phi[kk], dv);
        wgmma_rs_d<TD>(acc, plo[kk], dv);
      }
      wgmma_commit();
    };

    if (wg == 1) turn_pass(wg);       // warpgroup 0 takes the first turn
    int T = 0;                        // K and V tiles consumed so far
    for (int w = blockIdx.x, n = 0; w < items; w += gridDim.x, ++n) {
      const Item it = item_at(w, S, H, KV, B, causal, window);
      const bool last_item = w + static_cast<int>(gridDim.x) >= items;
      const int row0 = it.q0 + 64 * wg;               // the warpgroup's
      const int qp0 = row0 + 16 * warp + (lane >> 2); // first row; this
                                                      // thread's: qp0, +8
      m[0] = m[1] = NEG;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int j = 0; j < TD / 2; ++j) acc[j] = 0.f;

      // Q (A of Q.K^T): K-major rows of SWB bytes, 8-row groups 8 SWB
      // apart; a 16-wide k step moves 32 bytes along the swizzled row
      const int qb = n & 1;
      const uint32_t q_addr = smem_u32(Qs(qb)) + 64 * wg * SWB;
      auto issue_qk = [&](int t) {
        const uint32_t k_addr = smem_u32(Ks(t % STAGES));
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk * 16 / SWE) * TQ * SWB +
                               (kk * 16 % SWE) * 2;
          const uint32_t koff = (kk * 16 / SWE) * TK * SWB +
                                (kk * 16 % SWE) * 2;
          wgmma_ss_n128(s, gmma_desc(q_addr + off, 16, 8 * SWB, LAYOUT),
                        gmma_desc(k_addr + koff, 16, 8 * SWB, LAYOUT),
                        kk > 0);
        }
        wgmma_commit();
      };
      auto softmax = [&](int i) {
        const int k0 = it.k_begin + i * TK;
        if (softcap > 0.f) {
#pragma unroll
          for (int j = 0; j < TK / 2; ++j)
            s[j] = tanhf(s[j] * cap_in) * cap_out;
        }
        if ((causal && k0 + TK - 1 > row0) ||
            (window > 0 && row0 + 63 - k0 >= window) || k0 + TK > S)
          softmax_tile<true>(s, m, l, corr, c, qp0, k0, S, causal, window);
        else
          softmax_tile<false>(s, m, l, corr, c, qp0, k0, S, causal, window);
      };

      mbar_wait(&q_full[qb], (n >> 1) & 1);
      mbar_wait(&k_full[T % STAGES], full_par(T));
      mark(PROF_DATA);
      turn_wait(wg);
      mark(PROF_TURN);
      fence_regs(s);
      wgmma_fence();
      issue_qk(T);
      turn_pass(wg);
      mark(PROF_ISSUE_QK);
      wgmma_wait<0>();
      fence_regs(s);
      mark(PROF_PRODUCTS);
      if (lane == 0) mbar_arrive(&k_empty[T % STAGES]);
      softmax(0);
      to_operand<TK>(s, phi, plo);
      mark(PROF_SOFTMAX);
      for (int i = 1; i < it.tiles; ++i) {
        const int t = T + i;
        mbar_wait(&k_full[t % STAGES], full_par(t));
        mbar_wait(&v_full[(t - 1) % STAGES], full_par(t - 1));
        mark(PROF_DATA);
        turn_wait(wg);
        mark(PROF_TURN);
        fence_regs(s);
        fence_regs(acc);
        wgmma_fence();
        issue_qk(t);
        mark(PROF_ISSUE_QK);
        issue_pv(t - 1);
        turn_pass(wg);
        mark(PROF_ISSUE_PV);
        wgmma_wait<1>();              // S_i is in; P_{i-1}.V still runs
        fence_regs(s);
        mark(PROF_PRODUCTS);
        if (lane == 0) mbar_arrive(&k_empty[t % STAGES]);
        softmax(i);
        mark(PROF_SOFTMAX);
        wgmma_wait<0>();
        fence_regs(acc);
        mark(PROF_PRODUCTS);
        if (lane == 0) mbar_arrive(&v_empty[(t - 1) % STAGES]);
#pragma unroll
        for (int j = 0; j < TD / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
        to_operand<TK>(s, phi, plo);
        mark(PROF_SOFTMAX);
      }
      T += it.tiles;
      mbar_wait(&v_full[(T - 1) % STAGES], full_par(T - 1));
      mark(PROF_DATA);
      turn_wait(wg);
      mark(PROF_TURN);
      fence_regs(acc);
      wgmma_fence();
      issue_pv(T - 1);
      // warpgroup 1 passes the turn on to warpgroup 0's next item; after
      // the block's last item nobody waits for it
      if (wg == 0 || !last_item) turn_pass(wg);
      mark(PROF_ISSUE_PV);
      wgmma_wait<0>();
      fence_regs(acc);
      mark(PROF_PRODUCTS);
      if (lane == 0) {
        mbar_arrive(&v_empty[(T - 1) % STAGES]);
        mbar_arrive(&q_empty[qb]);
      }

      const int64_t qrow = static_cast<int64_t>(H) * HD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = qp0 + 8 * r;
        if (qp >= S) continue;
        const float inv = __frcp_rn(fmaxf(l[r], 1e-30f));
        // m and the scores are in log2 units: lse = ln 2 (m + log2 l)
        if (lse != nullptr && (lane & 3) == 0)
          lse[(static_cast<int64_t>(it.b) * H + it.h) * S + qp] =
              (m[r] + log2f(l[r])) * LN2;
        __nv_bfloat16* orow = o + (static_cast<int64_t>(it.b) * S + qp) *
                                      qrow + it.h * HD + 2 * (lane & 3);
#pragma unroll
        for (int i = 0; i < HD / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
              __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv,
                                    acc[4 * i + 2 * r + 1] * inv);
      }
      mark(PROF_EPILOGUE);
    }
    if (PROFILE && timed)
#pragma unroll
      for (int st = 0; st < PROF_STAGES; ++st)
        atomicAdd(&prof[st],
                  static_cast<unsigned long long>(stage_cycles[st]));
  }
}

// ---------------------------------------------------------------------------
// fp32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;          // query rows per block
constexpr int F32_BK = 32;      // keys per KV tile
constexpr int F32_NT = 256;     // threads per block: a 16 x 16 grid
constexpr int PS = F32_BK + 4;  // row stride of the probability tile

// row stride (floats) of the Q and K tiles
template <int HD>
__host__ __device__ constexpr int f32_stride() { return HD + 4; }

template <int HD>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (BQ * f32_stride<HD>() + F32_BK * f32_stride<HD>() +
                          F32_BK * HD + BQ * PS);
}

// Rows [r0, r0 + ROWS) of one head, src pointing at (row 0, that head) of a
// row-major tensor whose rows are row_stride elements apart, into the fp32
// tile dst (row stride `stride`), each value times mul; rows >= S are
// zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* __restrict__ src,
                                          int64_t row_stride, int r0, int S,
                                          float mul) {
  constexpr int PER_ROW = HD / 4;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += F32_NT) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) {
      x = *reinterpret_cast<const float4*>(
          src + static_cast<int64_t>(r0 + r) * row_stride + c);
      x = make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
    }
    *reinterpret_cast<float4*>(dst + r * stride + c) = x;
  }
}

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

// a butterfly: every lane of the 16 ends with the same bits (IEEE addition
// commutes)
__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

template <int HD>
__global__ void __launch_bounds__(F32_NT, 2)
flash_fp32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, int S, int H,
           int KV, int causal, int window, float softcap, float scale,
           float* __restrict__ lse) {
  constexpr int QS = f32_stride<HD>();
  constexpr int DPT = HD / 16;               // output dims per thread
  extern __shared__ __align__(16) float smem_f[];
  float* Qs = smem_f;                        // BQ x QS, q * scale
  float* Ks = Qs + BQ * QS;                  // F32_BK x QS
  float* Vs = Ks + F32_BK * QS;              // F32_BK x HD
  float* Ps = Vs + F32_BK * HD;              // BQ x PS

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest first
  const int kvh = h / (H / KV);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qrow = static_cast<int64_t>(H) * HD;
  const int64_t krow = static_cast<int64_t>(KV) * HD;
  const float* kb = k + (static_cast<int64_t>(b) * S * KV + kvh) * HD;
  const float* vb = v + (static_cast<int64_t>(b) * S * KV + kvh) * HD;

  load_tile<HD, BQ>(Qs, QS, q + (static_cast<int64_t>(b) * S * H + h) * HD,
                    qrow, q0, S, scale);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const int k_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = first_kv_tile(q0, window, F32_BK); k0 < k_end;
       k0 += F32_BK) {
    __syncthreads();          // the last tile's K, V and P reads are done
    load_tile<HD, F32_BK>(Ks, QS, kb, krow, k0, S, 1.f);
    load_tile<HD, F32_BK>(Vs, HD, vb, krow, k0, S, 1.f);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < HD; dd += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * QS + dd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[i][j] = live(qp, k0 + tx + 16 * j, S, causal, window) ? x : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(4 * ty + i) * PS + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group16_sum(sum);
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
      m[i] = m_new;
    }
    __syncwarp();             // a warp reads only the P rows it wrote

#pragma unroll 2
    for (int c = 0; c < F32_BK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DPT];
#pragma unroll
        for (int e = 0; e < DPT; ++e) vv[e] = Vs[(c + cc) * HD + 16 * e + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pc = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                         : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int e = 0; e < DPT; ++e) acc[i][e] = fmaf(pc, vv[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + 4 * ty + i;
    if (qp < S) {
      const float den = fmaxf(l[i], 1e-30f);
      if (lse != nullptr && tx == 0)
        lse[(static_cast<int64_t>(b) * H + h) * S + qp] = m[i] + logf(l[i]);
      float* orow = o + (static_cast<int64_t>(b) * S + qp) * qrow + h * HD;
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        orow[16 * e + tx] = __fdiv_rn(acc[i][e], den);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD>
int launch_hd(int bf16, const void* q, const void* k, const void* v,
              void* o, int B, int S, int H, int KV, int causal, int window,
              float softcap, float scale, float* lse, void* prof,
              cudaStream_t stream) {
  cudaError_t err;
  if (bf16) {
    CUtensorMap mq, mk, mv;
    if ((err = head_map<HD>(&mq, q, B, S, H, TQ)) != cudaSuccess ||
        (err = head_map<HD>(&mk, k, B, S, KV, TK)) != cudaSuccess ||
        (err = head_map<HD>(&mv, v, B, S, KV, TK)) != cudaSuccess)
      return err;
    const size_t smem = bf16_smem_bytes<HD>();
    auto kernel = prof ? flash_bf16<HD, true> : flash_bf16<HD, false>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return err;
    const int items = H * B * ((S + TQ - 1) / TQ);   // one block an SM
    kernel<<<min(items, sms), BF16_THREADS, smem, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), B, S, H, KV, causal,
        window, softcap, scale, lse, static_cast<unsigned long long*>(prof));
  } else {
    const size_t smem = f32_smem_bytes<HD>();
    err = cudaFuncSetAttribute(flash_fp32<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(H, B, (S + BQ - 1) / BQ);
    flash_fp32<HD><<<grid, F32_NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, KV,
        causal, window, softcap, scale, lse);
  }
  return cudaGetLastError();
}

}  // namespace

REPRO_ERROR_STRING(flash_attention)

// lse: null, or (B, H, S) fp32 for the rows' log-sum-exp; prof: null, or
// PROF_SLOTS zeroed uint64 on the card that the bf16 kernel adds its stage
// cycles to
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KV, int d, int bf16,
                                      int causal, int window, float softcap,
                                      float scale, float* lse, void* prof,
                                      cudaStream_t stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  switch (d) {
    case 32:
      return launch_hd<32>(bf16, q, k, v, o, B, S, H, KV, causal, window,
                           softcap, scale, lse, prof, stream);
    case 64:
      return launch_hd<64>(bf16, q, k, v, o, B, S, H, KV, causal, window,
                           softcap, scale, lse, prof, stream);
    case 112:
      return launch_hd<112>(bf16, q, k, v, o, B, S, H, KV, causal, window,
                            softcap, scale, lse, prof, stream);
    case 128:
      return launch_hd<128>(bf16, q, k, v, o, B, S, H, KV, causal, window,
                            softcap, scale, lse, prof, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
