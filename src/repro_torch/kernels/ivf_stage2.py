"""IVF stage 2 on the card (``csrc/ivf_stage2.cu``, ``csrc/ivf_stage2_q.cu``).

The Hopper kernels in place of ``repro/kernels/nn_search_ivf.py:186``
(``ivf_stage2_pallas``) and ``:281`` (``ivf_stage2_quantized_pallas``):
each query's running top-k over the occupied rows of its probed buckets,
fp32 or int8 snapshot rows, in the Pallas kernels' (score descending, id
ascending) order with (-1e30, 2**31 - 1) padding. A probed bucket is read
once per tile of 32 queries; ``csrc/ivf_stage2.cuh`` says how.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.env import fit_block_rows
from repro_torch.kernels._build import launch, require_cuda

QB = 32                 # queries per block (ivf_stage2.cuh)
KMAX = 128              # largest k the kernels support
SLICE_ROWS = 2048       # bucket rows one block walks, at most
TOPK_NEG = -1e30        # a padding slot: (TOPK_NEG, INT32_MAX), common.cuh
INT32_MAX = 2**31 - 1

# after the row pointers: packed_ids, bucket_occ, C, cap, queries, probes,
# B, nprobe, D, k, tile rows, rows per slice, slices, part_s, part_i,
# out_s, out_i
_TAIL_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_longlong, ctypes.c_int) + \
    (ctypes.c_void_p,) * 4


def tile_rows(dim: int, k: int) -> int:
    """Rows per shared-memory tile: the 32 queries and the tile (row
    stride dim + 4), the tile's scores, ids, scales and offsets, and the
    per-query lists must fit one block's shared memory (an int8 tile
    takes about a quarter of the fp32 tile's bytes, so it fits too)."""
    stride = dim + 4
    return fit_block_rows(stride + QB + 3, want=128,
                          fixed_bytes=4 * QB * (stride + 3) + 8 * QB * k,
                          minimum=32)


def stage2(name, packed, extra, packed_ids, bucket_occ, queries, probes,
           k: int, align: int, *, symbol=None, groups: int = 0):
    """Launch ``symbol`` (default ``{name}_launch``) of library ``name``
    after checking every input: the single-index entries, or with
    ``groups`` = S >= 1 the sharded ones, whose probes (B, S * nprobe)
    hold one run of global bucket ids per shard and whose output is (B,
    S, k)."""
    require_cuda(packed_ids, "packed_ids", torch.int32, 1)
    require_cuda(bucket_occ, "bucket_occ", torch.int32, 1)
    require_cuda(queries, "queries", torch.float32, 2)
    require_cuda(probes, "probes", torch.int32, 2)
    rows, D = packed.shape
    C = bucket_occ.shape[0]
    B, nprobe = probes.shape
    dev = packed.device
    if (queries.shape != (B, D) or rows != packed_ids.shape[0]
            or C < 1 or rows % C or C > 65535 or not 1 <= nprobe <= C
            or C % max(groups, 1) or nprobe % max(groups, 1)
            or len({t.device for t in (packed, packed_ids, bucket_occ,
                                       queries, probes, *extra)}) != 1):
        raise ValueError(
            f"{name}: packed {tuple(packed.shape)}, packed_ids "
            f"{tuple(packed_ids.shape)}, {C} buckets, queries "
            f"{tuple(queries.shape)} and probes {tuple(probes.shape)} do not "
            "fit one index on one device (C <= 65535 buckets in all, "
            "nprobe <= C, both divisible by the shards)")
    if not 1 <= k <= KMAX:
        raise ValueError(f"{name} kernel takes 1 <= k <= {KMAX}, got {k}")
    if D % align or packed.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs D % {align} == 0 and 16-byte "
                         f"aligned rows (D={D})")
    cap = rows // C
    shape = (B, groups, k) if groups else (B, k)
    out_s = torch.empty(shape, dtype=torch.float32, device=dev)
    out_i = torch.empty(shape, dtype=torch.int64, device=dev)
    if B == 0:
        return out_s, out_i
    tile = tile_rows(D, k)
    per_slice = -(-min(SLICE_ROWS, cap) // tile) * tile
    slices = -(-cap // per_slice)
    # A slot is written by the block of its (slice, probed bucket). Start
    # every slot as padding, so that one a block never writes (a bucket
    # probed twice by a query, or an id outside [0, C)) merges as nothing.
    part_s = torch.full((B, nprobe, slices, k), TOPK_NEG,
                        dtype=torch.float32, device=dev)
    part_i = torch.full((B, nprobe, slices, k), INT32_MAX,
                        dtype=torch.int32, device=dev)
    grouped = (groups,) if groups else ()
    launch(name, symbol or f"{name}_launch",
           (ctypes.c_void_p,) * (1 + len(extra)) + _TAIL_ARGTYPES
           + (ctypes.c_int,) * len(grouped), dev,
           packed.data_ptr(), *(t.data_ptr() for t in extra),
           packed_ids.data_ptr(), bucket_occ.data_ptr(), C, cap,
           queries.data_ptr(), probes.data_ptr(), B, nprobe, D, k, tile,
           per_slice, slices, part_s.data_ptr(), part_i.data_ptr(),
           out_s.data_ptr(), out_i.data_ptr(), *grouped)
    return out_s, out_i


def ivf_stage2_cuda(packed_vecs, packed_ids, bucket_occ, queries, probes,
                    k: int):
    """packed_vecs (C*cap, D) f32, packed_ids (C*cap,) int32, bucket_occ
    (C,) int32, queries (B, D) f32, probes (B, nprobe) int32 ->
    (scores (B, k) f32, ids (B, k) int64), snapshot scores. Takes
    1 <= k <= 128, D % 4 == 0, and raises on anything else."""
    require_cuda(packed_vecs, "packed_vecs", torch.float32, 2)
    out = stage2("ivf_stage2", packed_vecs, (), packed_ids, bucket_occ,
                  queries, probes, k, 4)
    ivf_stage2_cuda.launches += 1
    return out


def ivf_stage2_q_cuda(packed_codes, packed_scale, packed_offset, packed_ids,
                      bucket_occ, queries, probes, k: int):
    """``ivf_stage2_cuda`` over int8 rows: packed_codes (C*cap, D) int8,
    packed_scale / packed_offset (C*cap,) f32; scores
    ``scale * (q . c) + sum(q) * offset``. Takes D % 16 == 0."""
    require_cuda(packed_codes, "packed_codes", torch.int8, 2)
    for t, what in ((packed_scale, "packed_scale"),
                    (packed_offset, "packed_offset")):
        require_cuda(t, what, torch.float32, 1)
        if t.shape[0] != packed_codes.shape[0]:
            raise ValueError(f"{what} {tuple(t.shape)} does not match "
                             f"packed_codes {tuple(packed_codes.shape)}")
    out = stage2("ivf_stage2_q", packed_codes,
                  (packed_scale, packed_offset), packed_ids, bucket_occ,
                  queries, probes, k, 16)
    ivf_stage2_q_cuda.launches += 1
    return out


ivf_stage2_cuda.launches = 0
ivf_stage2_q_cuda.launches = 0
