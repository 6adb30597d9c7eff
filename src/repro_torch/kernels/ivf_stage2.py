"""IVF stage 2 on the card (``csrc/ivf_stage2.cu``, ``csrc/ivf_stage2_q.cu``).

The Hopper kernels in place of ``repro/kernels/nn_search_ivf.py:186``
(``ivf_stage2_pallas``) and ``:281`` (``ivf_stage2_quantized_pallas``):
each query's running top-k over the occupied rows of its probed buckets,
fp32 or int8 snapshot rows, in the Pallas kernels' (score descending, id
ascending) order with (-1e30, 2**31 - 1) padding. fp32 is bound by the
bytes of the probed buckets; int8 reads a quarter of them for the same
FMAs, so there the work per byte sets the pace. Three launches: a plan on
the card cuts each probed (query tile, bucket) pair into items of equal
work (rows times the query chunks they take); persistent blocks, two an
SM, stream an item's rows once per tile of 32 queries through a TMA ring
while every warp scores a box of them for 4 queries in registers (int8
codes converted once per 4 queries), and scores meet their query's
bar in registers, in the lists' (score, id) order (its list's k-th, or
a bound shared across items), before any reaches a list, so a zero query
of a padded batch lets through only ids below its k-th's; a merge keeps
each (query, group)'s k best. A block keeps its 32 queries in shared
memory where they fit beside two stages (to ~1.1-1.2k dims, by k); at any
wider D the streamed instance loads their slice of each stage beside the
rows instead, with the same FMAs in the same order.
``csrc/ivf_stage2.cuh`` says how, and
``ivf_stage2_cycles`` profiles where a launch's cycles go.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.env import SMEM_BYTES
from repro_torch.kernels._build import (kernel_function, launch,
                                        require_cuda)

QB = 32                 # queries per block (ivf_stage2.cuh)
QA = 4                  # queries per register tile
KMAX = 128              # largest k the kernels support
CAND = 32               # candidate slots per query and round
STAGE_BYTES = 32 * 1024  # bytes per stage of the ring
MAX_STAGES = 4
TOPK_NEG = -1e30        # a padding slot: (TOPK_NEG, INT32_MAX), common.cuh
INT32_MAX = 2**31 - 1
# dynamic shared memory a block may ask for, less room for the static
# barriers and query slots
SMEM_BUDGET = SMEM_BYTES - 1024

# after the row pointers: packed_ids, bucket_occ, C, cap, queries, probes,
# B, nprobe, D, k, stages, streamed, resident blocks, slices, scratch,
# part_s, part_i, out_s, out_i (then the shards, for the sharded entries,
# and the profile)
_TAIL_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p) + \
    (ctypes.c_int,) * 8 + (ctypes.c_void_p,) * 5
_PLAN_ARGTYPES = (ctypes.c_int,) * 3 + \
    (ctypes.POINTER(ctypes.c_int),) * 3
# the partial pass's optional profile (ivf_stage2.cuh IvfProfSlot)
PROFILE_SLOTS = ("setup", "data", "fma", "score", "filter", "offer", "sync",
                 "write", "rounds", "candidates", "blocks", "stages",
                 "partial_t0", "partial_t1", "merge_t0", "merge_t1")


def tile_rows(int8: bool) -> int:
    """Rows of a tile when a bucket has at most 4 queries of the block's
    tile: 8 warps x 32 lanes x the rows a lane scores (4 int8, 2 fp32),
    each warp one box of the stage; with more queries the warps split into
    query chunks over tiles of fewer boxes. A stage holds 32 dims of a
    tile's int8 rows or 16 of its fp32 rows: 32 KB either way."""
    return 8 * 32 * (4 if int8 else 2)


def stage_dims(int8: bool) -> int:
    """Dims of a row a stage holds: 32 bytes of int8 codes, 64 of fp32."""
    return 32 if int8 else 16


def smem_bytes(dim: int, k: int, stages: int, int8: bool,
               streamed: bool = False) -> int:
    """Dynamic shared memory of one partial-pass block (ivf_stage2.cuh
    ivf_smem_bytes): room to align the ring, the ring (streamed: with the
    32 queries' slice of each stage), the side buffers of ceil(stages /
    chunks) tiles (ids, and int8 scales and offsets), the 32 queries
    transposed (resident only) and their sums, the candidate counts and
    buffers, and the 32 lists of k."""
    chunks = -(-dim // stage_dims(int8))
    sides = -(-stages // chunks)
    qslice = 4 * QB * stage_dims(int8) if streamed else 0
    return (1024 + stages * (STAGE_BYTES + qslice)
            + sides * tile_rows(int8) * (12 if int8 else 4)
            + (0 if streamed else 4 * QB * dim) + 8 * QB + 8 * QB * CAND
            + 8 * QB * k)


def streams_queries(dim: int, k: int, int8: bool) -> bool:
    """Whether the partial pass takes its streamed instance: where 32
    queries of width ``dim`` beside two stages and the lists of ``k`` do
    not fit one block's shared memory."""
    return smem_bytes(dim, k, 2, int8) > SMEM_BUDGET


def scratch_ints(pairs: int, resident: int, bounds: int) -> int:
    """Ints of the plan's scratch (ivf_stage2.cuh ivf_scratch_ints): the
    queries and slices of each (query tile, bucket) pair, two counters,
    up to max(resident, pairs) items of four ints, 16-byte aligned, and
    the shared bound of each (query, group) list, a 64-bit key."""
    return ((2 * pairs + 2 + 3) // 4 * 4 + 4 * (resident + pairs)
            + 2 * bounds)


@functools.lru_cache(maxsize=64)
def _plan(name: str, symbol: str, dim: int, k: int, streamed: bool,
          device_index: int):
    """(stages, blocks per SM, SMs) of the partial pass's (streamed or
    resident) instance at this D and k on this card (ivf_stage2.cuh
    ivf_plan)."""
    fn = kernel_function(name, symbol, _PLAN_ARGTYPES)
    stages, per_sm, sms = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        code = fn(dim, k, int(streamed), ctypes.byref(stages),
                  ctypes.byref(per_sm), ctypes.byref(sms))
    if code != 0:
        raise RuntimeError(f"{symbol} failed with CUDA error {code}")
    return stages.value, per_sm.value, sms.value


def check_stage2(name: str, rows: int, dim: int, C: int, k: int,
                 align: int, int8: bool, pointers) -> None:
    """The refusals of every stage-2 entry beyond the tensors' device, type
    and shape: 1 <= k <= 128; D % ``align`` (4 fp32, 16 int8: whole
    16-byte row pieces); 16-byte aligned rows, ids, scales and offsets
    (TMA and bulk copies); a bucket capacity that is a multiple of 4 (a
    tile's ids, scales and offsets are copied 16 bytes at a time); fewer
    than 2**31 packed rows (a TMA row coordinate is an int32). Any D
    plans: where 32 queries of width D leave no room for two stages, the
    streamed instance, whose shared memory does not grow with D, takes it
    (``streams_queries``)."""
    if not 1 <= k <= KMAX:
        raise ValueError(f"{name} kernel takes 1 <= k <= {KMAX}, got {k}")
    if dim % align or any(p % 16 for p in pointers):
        raise ValueError(f"{name} kernel needs D % {align} == 0 and 16-byte "
                         f"aligned rows, ids, scales and offsets (D={dim})")
    cap = rows // C
    if cap % 4 or rows >= 2**31:
        raise ValueError(f"{name} kernel needs a bucket capacity that is a "
                         f"multiple of 4 and fewer than 2**31 packed rows "
                         f"(cap={cap}, rows={rows})")


def stage2(name, packed, extra, packed_ids, bucket_occ, queries, probes,
           k: int, align: int, *, symbol=None, groups: int = 0, prof=None):
    """Launch ``symbol`` (default ``{name}_launch``) of library ``name``
    after checking every input: the single-index entries, or with
    ``groups`` = S >= 1 the sharded ones, whose probes (B, S * nprobe)
    hold one run of global bucket ids per shard and whose output is (B,
    S, k). ``prof``: zeroed int64 counters, one per PROFILE_SLOTS entry,
    for the partial pass's profiled instantiation."""
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
    int8 = packed.dtype == torch.int8
    check_stage2(name, rows, D, C, k, align, int8,
                 [t.data_ptr() for t in (packed, packed_ids, queries,
                                         *extra)])
    cap = rows // C
    shape = (B, groups, k) if groups else (B, k)
    out_s = torch.empty(shape, dtype=torch.float32, device=dev)
    out_i = torch.empty(shape, dtype=torch.int64, device=dev)
    if B == 0:
        return out_s, out_i
    symbol = symbol or f"{name}_launch"
    streamed = streams_queries(D, k, int8)
    stages, per_sm, sms = _plan(name, symbol.replace("_launch", "_plan"), D,
                                k, streamed, dev.index)
    resident = per_sm * sms
    # The device cuts each probed bucket into slices of whole tiles; an
    # item writes the slot (query, probe position, slice) of each query of
    # its tile that probes its bucket, and the merge reads only those, so
    # the rest (a bucket listed twice, an id outside [0, C), slices past
    # the plan's) need no padding here. One allocation holds the plan's
    # scratch (16-byte aligned, its size rounded to 4 ints) and the
    # (B, nprobe, slices, k) partial scores and ids.
    slices = -(-cap // tile_rows(int8))
    n_scratch = -(-scratch_ints(-(-B // QB) * C, resident,
                                B * max(groups, 1)) // 4) * 4
    n_part = B * nprobe * slices * k
    buf = torch.empty(n_scratch + 2 * n_part, dtype=torch.int32, device=dev)
    scratch = buf.data_ptr()
    part_s = scratch + 4 * n_scratch
    part_i = part_s + 4 * n_part
    grouped = (groups,) if groups else ()
    launch(name, symbol,
           (ctypes.c_void_p,) * (1 + len(extra)) + _TAIL_ARGTYPES
           + (ctypes.c_int,) * len(grouped) + (ctypes.c_void_p,), dev,
           packed.data_ptr(), *(t.data_ptr() for t in extra),
           packed_ids.data_ptr(), bucket_occ.data_ptr(), C, cap,
           queries.data_ptr(), probes.data_ptr(), B, nprobe, D, k, stages,
           int(streamed), resident, slices, scratch, part_s, part_i,
           out_s.data_ptr(), out_i.data_ptr(), *grouped,
           None if prof is None else prof.data_ptr())
    return out_s, out_i


def ivf_stage2_cycles(name: str, *args, k: int) -> dict:
    """One launch of stage-2 entry ``name`` (``ivf_stage2``,
    ``ivf_stage2_q``, ``ivf_stage2_sharded`` or ``ivf_stage2_sharded_q``,
    with its launcher's arguments but k) with the partial pass's profile
    on: cycles summed over every warp of the blocks with rows to score
    (setup, data, fma, score, filter, offer, sync, write), then the candidate
    rounds, the candidates buffered, those blocks and the stages they
    consumed, and the windows of the partial pass and of the merge on the
    global timer (partial_ns, merge_ns: first block's start to last
    block's end). A measurement of the kernel, not a launch of the main
    path: the launch count does not move."""
    from repro_torch.kernels.nn_search_ivf import global_probes
    packed, *rest = args
    int8 = packed.dtype == torch.int8
    extra = tuple(rest[:2]) if int8 else ()
    packed_ids, bucket_occ, queries, probes = rest[-4:]
    groups = 0
    if name.startswith("ivf_stage2_sharded"):
        groups = probes.shape[1]
        probes = global_probes(probes, bucket_occ.shape[0])
    call = functools.partial(
        stage2, "ivf_stage2_sharded" if groups else name, packed, extra,
        packed_ids, bucket_occ, queries, probes, k, 16 if int8 else 4,
        symbol=f"{name}_launch", groups=groups)
    call()                                  # a warm-up
    prof = torch.zeros(len(PROFILE_SLOTS), dtype=torch.int64,
                       device=packed.device)
    for slot in ("partial_t0", "merge_t0"):             # atomicMin's start
        prof[PROFILE_SLOTS.index(slot)] = 2**63 - 1
    call(prof=prof)
    out = dict(zip(PROFILE_SLOTS, prof.tolist()))
    for what in ("partial", "merge"):
        out[f"{what}_ns"] = out.pop(f"{what}_t1") - out.pop(f"{what}_t0")
    return out


def ivf_stage2_cuda(packed_vecs, packed_ids, bucket_occ, queries, probes,
                    k: int):
    """packed_vecs (C*cap, D) f32, packed_ids (C*cap,) int32, bucket_occ
    (C,) int32, queries (B, D) f32, probes (B, nprobe) int32 ->
    (scores (B, k) f32, ids (B, k) int64), snapshot scores. Takes
    1 <= k <= 128, D % 4 == 0, cap % 4 == 0, and raises on anything
    else."""
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
