"""Exact top-k MIPS on the card (``csrc/nn_search.cu``).

The Hopper kernel in place of ``repro/kernels/nn_search.py:99``
(``nn_search_pallas``): an fp32 FMA product tiled through shared memory,
a running top-k per query and block, then a merge of the blocks' lists;
ties go to the lowest id. The source's header says how.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.env import DEFAULT_BLOCK_ROWS, fit_block_rows
from repro_torch.kernels._build import (kernel_function, launch,
                                        require_cuda)

QB = 32         # queries per block of the first pass (nn_search.cu)
KMAX = 128      # largest k the kernel supports

_PLAN_ARGTYPES = (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_longlong))
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int) + (ctypes.c_void_p,) * 4


def tile_rows(dim: int, k: int) -> int:
    """Bank rows per shared-memory tile: the queries, the tile (both at
    row stride dim + 4), the tile's scores and the per-query lists must
    fit one block's shared memory, and a tile spans whole warps."""
    stride = dim + 4
    return fit_block_rows(stride + QB, want=DEFAULT_BLOCK_ROWS,
                          fixed_bytes=4 * QB * stride + 8 * QB * k,
                          minimum=32)


@functools.lru_cache(maxsize=64)
def _plan(n_rows: int, dim: int, k: int, tile: int, device_index: int):
    """(slices, rows per slice): one wave of first-pass blocks per query
    tile, as many as the occupancy calculator fits on this card."""
    fn = kernel_function("nn_search", "nn_search_plan", _PLAN_ARGTYPES)
    slices, rows = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(device_index):
        code = fn(n_rows, dim, k, tile, ctypes.byref(slices),
                  ctypes.byref(rows))
    if code != 0:
        raise RuntimeError(f"nn_search_plan failed with CUDA error {code}")
    return slices.value, rows.value


def nn_search_cuda(queries, bank, k: int):
    """queries: (B, D) f32 CUDA; bank: (N, D) f32 CUDA -> (scores (B, k)
    f32, ids (B, k) int64), exact fp32 top-k by inner product, ties to the
    lowest id. Takes 1 <= k <= min(128, N), D % 4 == 0 and a 16-byte
    aligned bank, and raises on anything else."""
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
    if D % 4 or bank.data_ptr() % 16 or N >= 2 ** 31 - 1:
        raise ValueError("nn_search kernel needs D % 4 == 0, a 16-byte "
                         f"aligned bank and N < 2**31 - 1 (D={D}, N={N})")
    dev = bank.device
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int64, device=dev)
    if B == 0:
        return out_s, out_i
    tile = tile_rows(D, k)
    slices, rows_per_slice = _plan(N, D, k, tile, dev.index)
    part_s = torch.empty((B, slices, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, slices, k), dtype=torch.int32, device=dev)
    launch("nn_search", "nn_search_launch", _ARGTYPES, dev,
           queries.data_ptr(), bank.data_ptr(), B, N, D, k, tile,
           rows_per_slice, slices, part_s.data_ptr(), part_i.data_ptr(),
           out_s.data_ptr(), out_i.data_ptr())
    nn_search_cuda.launches += 1
    return out_s, out_i


nn_search_cuda.launches = 0
