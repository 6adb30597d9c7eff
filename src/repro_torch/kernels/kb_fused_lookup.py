"""Fused Knowledge Bank lookup on the card (``csrc/kb_fused_lookup.cu``).

The Hopper kernel in place of ``repro/kernels/kb_fused_lookup.py:84``
(``kb_fused_lookup_pallas``): apply each requested row's clipped pending
gradient, write it back, zero its caches, bump its version, return the
rows. It touches only the requested rows, in one launch designed for
latency, where the TPU kernel streams the whole bank through a one-hot
matmul; ``csrc/kb_lookup.cuh`` says how.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.env import fused_lookup_block, stage_lookup_ids
from repro_torch.kernels._build import launch, require_bank, require_cuda

_ARGTYPES = (ctypes.c_void_p,) * 6 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def require_version(version, n_rows: int, device) -> None:
    """Raise unless ``version`` is an (N,) int32 CUDA tensor on the bank's
    device."""
    require_cuda(version, "version", torch.int32, 1)
    if version.shape[0] != n_rows or version.device != device:
        raise ValueError(f"version {tuple(version.shape)} on "
                         f"{version.device} does not match the bank's "
                         f"{n_rows} rows on {device}")


def kb_fused_lookup_cuda(table, grad_sum, grad_cnt, grad_sqnorm, ids, *,
                         lazy_lr: float, zmax: float,
                         version=None) -> torch.Tensor:
    """``kb_lookup(apply_pending=True)`` on CUDA tensors, IN PLACE on the
    four leaves and, where given, on ``version`` ((N,) int32: +1 for each
    requested row with pending gradients, once however often it is
    requested); returns the (B, D) rows. ids: (B,) int64; ids outside
    [0, N) read zeros and change nothing, and duplicates all read the same
    updated row. One kernel launch per call."""
    require_bank(table, grad_sum, grad_cnt, grad_sqnorm)
    require_cuda(ids, "ids", torch.int64, 1)
    N, D = table.shape
    if version is not None:
        require_version(version, N, table.device)
    B = ids.shape[0]
    vals = torch.empty((B, D), dtype=torch.float32, device=table.device)
    if B == 0:
        return vals
    rows = fused_lookup_block(B, D)
    launch("kb_fused_lookup", "kb_fused_lookup_launch", _ARGTYPES,
           table.device, table.data_ptr(), grad_sum.data_ptr(),
           grad_cnt.data_ptr(), grad_sqnorm.data_ptr(),
           None if version is None else version.data_ptr(), ids.data_ptr(),
           B, N, D, lazy_lr, zmax, rows, int(stage_lookup_ids(B, D, rows)),
           vals.data_ptr())
    kb_fused_lookup_cuda.launches += 1
    return vals


kb_fused_lookup_cuda.launches = 0
