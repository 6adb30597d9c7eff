// Hopper's warpgroup products (wgmma) on bf16 tiles that TMA brought into
// shared memory, shared by the flash attention kernels (flash_attention.cu,
// flash_attention_bwd.cu): the swizzle of a head's tile, the shared-memory
// descriptors, the fences and waits, the products with both operands in
// shared memory (ss) or A in registers (rs), and the tensor map of a
// (B, S, heads, d) tensor's head tiles.
//
// A tile of `rows` rows of d bf16 lies in shared memory as column blocks
// of swz_elems<HD>() dims (one swizzle width: 128 bytes, 64 at d 32), each
// `rows` x swz_bytes<HD>() bytes, TMA's swizzle applied; tiles start on
// 1024-byte boundaries, the 128-byte swizzle's period. A d that is no
// multiple of the swizzle width (112) takes whole blocks: its tile is
// tile_dim<HD>() wide (128), and the box of its last block reads past the
// head's d columns (what lies there is never a product's operand for the
// products that contract over d, Q.K^T in the forward and S, dP and their
// transposes in the backward, which run d / 16 k-steps; it only feeds
// output columns past d in the products whose N is d, P.V, dV, dK and dQ,
// which the kernels do not store).
#pragma once

#include <cuda_bf16.h>

#include "tma.cuh"

namespace {

// bytes of one swizzled row of a tile (a row of d bf16 is split into
// column blocks of this width: TMA's 128-byte swizzle spans 64 bf16)
template <int HD>
__host__ __device__ constexpr int swz_bytes() { return HD >= 64 ? 128 : 64; }
template <int HD>
__host__ __device__ constexpr int swz_elems() { return swz_bytes<HD>() / 2; }
template <int HD>
__host__ __device__ constexpr int col_blocks() {
  return (HD + swz_elems<HD>() - 1) / swz_elems<HD>();
}
// the width of a head's tile in shared memory: whole column blocks
template <int HD>
__host__ __device__ constexpr int tile_dim() {
  return col_blocks<HD>() * swz_elems<HD>();
}
// the wgmma descriptors' layout type of that swizzle (1: 128 B, 2: 64 B)
template <int HD>
__host__ __device__ constexpr uint64_t swz_layout() {
  return swz_bytes<HD>() == 128 ? 1 : 2;
}

// a wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle's layout type
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// The descriptor of k-step kk (16 dims) of a K-major tile of `rows` rows
// (an operand whose reduction runs along d: A or B of Q.K^T), starting
// `row0` rows in: 8-row groups 8 rows of bytes apart, a 16-dim step 32
// bytes along the swizzled row or into the next column block.
template <int HD>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int row0, int kk) {
  constexpr int SWB = swz_bytes<HD>(), SWE = swz_elems<HD>();
  const uint32_t off = (kk * 16 / SWE) * rows * SWB + (kk * 16 % SWE) * 2;
  return gmma_desc(tile + row0 * SWB + off, 16, 8 * SWB, swz_layout<HD>());
}

// The descriptor of rows 16 kk .. 16 kk + 15 of a tile of `rows` rows
// read MN-major (the transpose bit: the B of P.V, whose reduction runs
// along the rows and whose N is d): column blocks rows x SWB bytes apart,
// 8-row groups 8 rows of bytes apart.
template <int HD>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows,
                                                 int kk) {
  constexpr int SWB = swz_bytes<HD>();
  return gmma_desc(tile + kk * 16 * SWB, rows * SWB, 8 * SWB,
                   swz_layout<HD>());
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the registers of an
// asynchronous product across its issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_F8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),      \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_F16(i) WG_F8(i), WG_F8(i + 8)
#define WG_F32(i) WG_F16(i), WG_F16(i + 16)

// d = A . B (acc 0) or d += A . B (acc 1), m64n64k16: A and B bf16 in
// shared memory, both K-major (descriptors da, db)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(0)
      : "l"(da), "l"(db), "r"(acc));
}

#define WG_O8(i)                                                   \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),      \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
#define WG_O16(i) WG_O8(i), WG_O8(i + 8)
#define WG_O32(i) WG_O16(i), WG_O16(i + 16)

// d = A . B, m64n64k16, the first step of a product: as wgmma_ss_n64
// with acc 0, but d's earlier values are not read, so that the compiler
// may keep other values in its registers until this product
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_O32(0)
      : "l"(da), "l"(db), "r"(0));
}

// d = A . B (acc 0) or d += A . B (acc 1), m64n128k16: A and B bf16 in
// shared memory, both K-major (descriptors da, db)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(0), WG_F32(32)
      : "l"(da), "l"(db), "r"(acc));
}

// d += A . B, m64n32k16: A bf16 in registers, B bf16 in shared memory
// stored MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n64k16: A bf16 in registers, B bf16 in shared memory
// stored MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n128k16: A bf16 in registers, B bf16 in shared memory
// stored MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F32(0), WG_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B with N = TD, a tile's width (tile_dim): A (64 x 16) bf16 in
// registers, B (16 x TD) an MN-major tile
template <int TD>
__device__ __forceinline__ void wgmma_rs_d(float (&d)[TD / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  static_assert(TD == 32 || TD == 64 || TD == 128, "a tile 32, 64 or 128 "
                "wide");
  if constexpr (TD == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (TD == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// 2^x by the special-function unit (2 ulp; 2^-huge is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as two packed bf16 pairs: hi rounds them, lo rounds what hi
// leaves (exact in fp32), so hi + lo holds x and y to ~2^-17 of them
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// An accumulator of N columns (wgmma's layout: a[4i + e] is column 8i + 2
// (lane % 4) + (e & 1) of row (lane / 4) + 8 (e >> 1) of the warp's 16)
// as the A operand of N / 16 products of depth 16, in bf16 hi and lo
// parts: slice kk is accumulator tiles 2kk and 2kk + 1
template <int N>
__device__ __forceinline__ void to_operand(const float (&p)[N / 2],
                                           uint32_t (&hi)[N / 16][4],
                                           uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1], hi[kk][r],
                 lo[kk][r]);
}

// A (d * heads, S, B) bf16 map of a (B, S, heads, d) tensor, boxes of
// `rows` rows x one swizzle width of columns; rows past S read as zeros.
template <int HD>
cudaError_t head_map(CUtensorMap* map, const void* base, int B, int S,
                     int heads, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * HD;
  const cuuint64_t dims[3] = {row, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {row * 2, row * 2 * S};   // bytes
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(swz_elems<HD>()),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swz_bytes<HD>() == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
