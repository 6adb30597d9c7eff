"""Exact top-k MIPS on the card (``csrc/nn_search.cu``).

The Hopper kernel in place of ``repro/kernels/nn_search.py:99``
(``nn_search_pallas``): fp32 FMAs, a running top-k per query and block,
then a merge of the blocks' lists; ties go to the lowest id. Reading the
bank bounds it (bytes), with the FMAs close behind, so each block streams
its slice of the bank by TMA through a ring of shared-memory stages (tiles
of up to 512 rows, 16 dims a stage) while its warps score the stage that
has arrived, each lane 8 queries against 8 rows in registers, so that a
float read from shared memory feeds 4 FMAs; the block's 32 queries ride
the ring too, their 16 dims of the chunk beside the bank's, so any width
D % 4 == 0 runs. Scores meet their query's k-th in registers; only those
that may beat it reach the lists. The source's header says how.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.env import SMEM_BYTES
from repro_torch.kernels._build import (kernel_function, launch,
                                        require_cuda)

QB = 32         # queries per block of the first pass (nn_search.cu)
KMAX = 128      # largest k the kernel supports
TILE_ROWS = (512, 256, 128, 64)   # bank rows per tile: 8 warps x 8 row
#                                   groups of lanes x 8, 4, 2 or 1 rows
DC = 16         # dims of a tile per stage (nn_search.cu DC)
CAND = 64       # candidate slots per query (nn_search.cu CAND)
MAX_STAGES = 4  # stages in the ring (nn_search.cu MAX_STAGES)
QSLICE = 4 * QB * DC   # a stage's query slice (nn_search.cu)
# a bank of fewer tiles of a size takes a smaller size, so that it still
# spreads over the card's SMs (2048 rows of width 4096, 64 queries, k 9:
# 64-row tiles 0.284 ms, 512-row tiles 0.591; tools/search_forms.py)
MIN_TILES = 128
# dynamic shared memory a block may ask for, less room for the static
# barriers
SMEM_BUDGET = SMEM_BYTES - 1024

_PLAN_ARGTYPES = (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_longlong))
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_int) + \
    (ctypes.c_void_p,) * 4


def partial_smem_bytes(k: int, rows: int, stages: int) -> int:
    """Dynamic shared memory of one first-pass block (nn_search.cu
    partial_smem_bytes): room to align the ring, the ring of ``stages``
    tiles of ``rows`` x 16 dims with the queries' 16 dims beside each, the
    candidate buffers and counts, and the lists. It does not depend on
    D."""
    return (1024 + stages * (4 * DC * rows + QSLICE) + 8 * QB * CAND
            + 4 * QB + 8 * QB * k)


def tile_plan(k: int, n_rows: int) -> tuple:
    """(bank rows per tile, stages in the ring): the most rows, but for a
    bank of ``n_rows`` that would make fewer than MIN_TILES tiles of a size
    the next smaller size; then the most stages (up to 4) that fit one
    block's shared memory with the lists of ``k`` (4 for every k <= KMAX;
    the ring does not grow with D)."""
    rows = next(r for r in TILE_ROWS
                if r == TILE_ROWS[-1] or n_rows >= r * MIN_TILES)
    stages = min(MAX_STAGES, (SMEM_BUDGET - partial_smem_bytes(k, rows, 0))
                 // (4 * DC * rows + QSLICE))
    return rows, stages


@functools.lru_cache(maxsize=64)
def _plan(n_rows: int, k: int, tile: int, stages: int, device_index: int):
    """(slices, rows per slice): one wave of first-pass blocks per query
    tile, as many as the occupancy calculator fits on this card."""
    fn = kernel_function("nn_search", "nn_search_plan", _PLAN_ARGTYPES)
    slices, rows = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device_index):
        code = fn(n_rows, k, tile, stages, ctypes.byref(slices),
                  ctypes.byref(rows))
    if code != 0:
        raise RuntimeError(f"nn_search_plan failed with CUDA error {code}")
    return slices.value, rows.value


def nn_search_cuda(queries, bank, k: int):
    """queries: (B, D) f32 CUDA; bank: (N, D) f32 CUDA -> (scores (B, k)
    f32, ids (B, k) int64), exact fp32 top-k by inner product, ties to the
    lowest id. Takes any D with D % 4 == 0, 1 <= k <= min(128, N) and a
    16-byte aligned bank and queries, and raises on anything else."""
    require_cuda(queries, "queries", torch.float32, 2)
    require_cuda(bank, "bank", torch.float32, 2)
    B, D = queries.shape
    N = bank.shape[0]
    if queries.device != bank.device or bank.shape[1] != D:
        raise ValueError(f"queries {tuple(queries.shape)} on "
                         f"{queries.device} do not match bank "
                         f"{tuple(bank.shape)} on {bank.device}")
    if not 1 <= k <= min(KMAX, N):
        raise ValueError(f"nn_search kernel takes 1 <= k <= min({KMAX}, N="
                         f"{N}), got k={k}")
    if (D % 4 or bank.data_ptr() % 16 or queries.data_ptr() % 16
            or N >= 2 ** 31 - 1):
        raise ValueError("nn_search kernel needs D % 4 == 0, a 16-byte "
                         "aligned bank and queries and N < 2**31 - 1 "
                         f"(D={D}, N={N})")
    dev = bank.device
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int64, device=dev)
    if B == 0:
        return out_s, out_i
    tile, stages = tile_plan(k, N)
    slices, rows_per_slice = _plan(N, k, tile, stages, dev.index)
    part_s = torch.empty((B, slices, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, slices, k), dtype=torch.int32, device=dev)
    launch("nn_search", "nn_search_launch", _ARGTYPES, dev,
           queries.data_ptr(), bank.data_ptr(), B, N, D, k, tile, stages,
           rows_per_slice, slices, part_s.data_ptr(), part_i.data_ptr(),
           out_s.data_ptr(), out_i.data_ptr())
    nn_search_cuda.launches += 1
    return out_s, out_i


nn_search_cuda.launches = 0
