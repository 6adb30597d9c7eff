"""Fused Knowledge Bank lookup on the card (``csrc/kb_fused_lookup.cu``).

The Hopper kernel in place of ``repro/kernels/kb_fused_lookup.py:84``
(``kb_fused_lookup_pallas``): apply each requested row's clipped pending
gradient, write it back, zero its caches, return the rows. It touches only
the requested rows, where the TPU kernel streams the whole bank through a
one-hot matmul; the source's header says how.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.env import fused_lookup_block
from repro_torch.kernels._build import launch, require_bank, require_cuda

_ARGTYPES = (ctypes.c_void_p,) * 5 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def kb_fused_lookup_cuda(table, grad_sum, grad_cnt, grad_sqnorm, ids, *,
                         lazy_lr: float, zmax: float) -> torch.Tensor:
    """``kb_lookup(apply_pending=True)`` without the version bump, on CUDA
    tensors, IN PLACE on the four leaves; returns the (B, D) rows. ids:
    (B,) int64; ids outside [0, N) read zeros and change nothing, and
    duplicates all read the same updated row."""
    require_bank(table, grad_sum, grad_cnt, grad_sqnorm)
    require_cuda(ids, "ids", torch.int64, 1)
    N, D = table.shape
    B = ids.shape[0]
    vals = torch.empty((B, D), dtype=torch.float32, device=table.device)
    if B == 0:
        return vals
    launch("kb_fused_lookup", "kb_fused_lookup_launch", _ARGTYPES,
           table.device, table.data_ptr(), grad_sum.data_ptr(),
           grad_cnt.data_ptr(), grad_sqnorm.data_ptr(), ids.data_ptr(), B, N,
           D, lazy_lr, zmax, fused_lookup_block(B, D), vals.data_ptr())
    kb_fused_lookup_cuda.launches += 1
    return vals


kb_fused_lookup_cuda.launches = 0
