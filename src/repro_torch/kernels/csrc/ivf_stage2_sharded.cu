// IVF stage 2 over a sharded index: one top-k per (query, shard) over the
// occupied rows of the buckets each shard's own probes name, in the
// shard-major (S * C * cap, D) layout of a ShardedIVFIndex, in one set of
// launches for every shard.
//
// Replaces: src/repro/kernels/nn_search_ivf.py:381 ivf_stage2_sharded_pallas
// (body _ivf_kernel_sharded :344). The int8 entry is the same pass over a
// QuantizedShardedIVFIndex's codes (the JAX package scores those in jnp,
// src/repro/core/sharded_kb.py:336-351).
//
// What bounds it: bytes for fp32, as the single-index stage 2
// (ivf_stage2.cuh): the occupied rows of every bucket that some query of
// the batch probes, read once, and their ids; 2 * D operations per
// (query, probed row). nlist and nprobe are per shard, so at the serving
// shapes (32 queries, 8 probes of 64 buckets in each of 3 shards of
// 646,581 rows) a query scores about as many rows as over a single index
// of 64 buckets, and the batch's probes reach most of the bank, in three
// times as many buckets of a third the rows. The int8 entry, as
// ivf_stage2_q, is held back by what it does per byte (the conversions,
// shared-memory reads and list inserts) before the bytes.
//
// Design: the pass of ivf_stage2.cuh with one group of probes per shard.
// The wrapper lays the probes (B, S, nprobe) out as (B, S * nprobe),
// shard-major, each local id b of shard s turned into the global bucket
// s * nlist + b (an id outside [0, nlist) into -1, which matches no
// bucket), so the partial pass streams each probed bucket once per tile
// of 32 queries through its TMA ring, as for one index, a query still
// probes each global bucket at most once, and each (query, shard) has its
// own shared bound. The merge then runs one block per (query, shard) over
// the lists written for that shard's probe positions, writing the (B, S,
// k) output in the Pallas _merge_topk's order: a shard whose probed
// buckets hold fewer than k rows gets (-1e30, INT_MAX) in the rest (the
// Pallas list, restarted at each shard's first chunk, repeats there the
// lowest id it took, at score -1e30). The plan weighs the 192 buckets of
// ~10,100 rows by their queries, as for one index: at the serve shapes
// ~258 items of about equal work fill one wave of two blocks an SM.
#include "ivf_stage2.cuh"

REPRO_ERROR_STRING(ivf_stage2_sharded)

extern "C" int ivf_stage2_sharded_plan(int D, int k, int streamed,
    int* stages, int* per_sm, int* sms) {
  return ivf_plan<false>(D, k, streamed, stages, per_sm, sms);
}

extern "C" int ivf_stage2_sharded_q_plan(int D, int k, int streamed,
    int* stages, int* per_sm, int* sms) {
  return ivf_plan<true>(D, k, streamed, stages, per_sm, sms);
}

// C and nprobe count every shard's buckets and probes (S * nlist and
// S * nprobe), probes are global bucket ids; out_s / out_i are
// (B, shards, k).
extern "C" int ivf_stage2_sharded_launch(
    const float* packed_vecs, const int* packed_ids, const int* bucket_occ,
    int C, long long cap, const float* queries, const int* probes, int B,
    int nprobe, int D, int k, int stages, int streamed, int resident,
    int slices, int* scratch, float* part_s, int* part_i, float* out_s,
    int64_t* out_i, int shards, unsigned long long* prof,
    cudaStream_t stream) {
  return ivf_stage2_run<false>(
      packed_vecs, nullptr, nullptr, packed_ids, bucket_occ, C, cap, queries,
      probes, B, nprobe, D, k, stages, streamed, resident, slices, scratch,
      part_s, part_i, out_s, out_i, shards, prof, stream);
}

// The same over int8 codes, scored scale * (q . c) + sum(q) * offset.
extern "C" int ivf_stage2_sharded_q_launch(
    const int8_t* packed_codes, const float* packed_scale,
    const float* packed_offset, const int* packed_ids, const int* bucket_occ,
    int C, long long cap, const float* queries, const int* probes, int B,
    int nprobe, int D, int k, int stages, int streamed, int resident,
    int slices, int* scratch, float* part_s, int* part_i, float* out_s,
    int64_t* out_i, int shards, unsigned long long* prof,
    cudaStream_t stream) {
  return ivf_stage2_run<true>(
      packed_codes, packed_scale, packed_offset, packed_ids, bucket_occ, C,
      cap, queries, probes, B, nprobe, D, k, stages, streamed, resident,
      slices, scratch, part_s, part_i, out_s, out_i, shards, prof, stream);
}
