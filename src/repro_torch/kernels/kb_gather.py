"""Row gather on the card (``csrc/kb_gather.cu``).

The Hopper kernel in place of ``repro/kernels/kb_gather.py:47``
(``kb_gather_pallas``): a coalesced copy of each requested row, where the
TPU kernel runs a one-hot matmul over the whole bank.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.env import fused_lookup_block
from repro_torch.kernels._build import launch, require_cuda

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def kb_gather_cuda(table, ids) -> torch.Tensor:
    """table: (N, D) f32 CUDA; ids: (B,) int64 -> (B, D) rows, zeros for
    ids outside [0, N)."""
    require_cuda(table, "table", torch.float32, 2)
    require_cuda(ids, "ids", torch.int64, 1)
    if ids.device != table.device:
        raise ValueError("ids and table lie on different devices")
    N, D = table.shape
    B = ids.shape[0]
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    if B == 0:
        return out
    vec4 = D % 4 == 0 and table.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    launch("kb_gather", "kb_gather_launch", _ARGTYPES, table.device,
           table.data_ptr(), ids.data_ptr(), B, N, D, int(vec4),
           fused_lookup_block(B, D), out.data_ptr())
    kb_gather_cuda.launches += 1
    return out


kb_gather_cuda.launches = 0
