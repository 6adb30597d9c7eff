"""Fused int8 Knowledge Bank lookup on the card (``csrc/kb_fused_lookup_q.cu``).

The Hopper kernel in place of ``repro/kernels/kb_fused_lookup.py:209``
(``kb_fused_lookup_q_pallas``): dequantize each requested row, apply its
clipped pending gradient, re-quantize only the rows that had one, zero the
caches, and return the dequantization of what was written. It touches only
the requested rows; the source's header says how.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.env import fused_lookup_block
from repro_torch.kernels._build import launch, require_cuda

_ARGTYPES = (ctypes.c_void_p,) * 7 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def kb_fused_lookup_q_cuda(codes, qscale, qoffset, grad_sum, grad_cnt,
                           grad_sqnorm, ids, *, lazy_lr: float,
                           zmax: float) -> torch.Tensor:
    """``kb_lookup_q`` without the version bump, on CUDA tensors, IN PLACE
    on the codes (N, D) int8, the scale/offset side-cars (N,) f32 and the
    three caches; returns the (B, D) f32 rows. ids: (B,) int64; ids
    outside [0, N) read zeros and change nothing, and duplicates all read
    the same row."""
    require_cuda(codes, "codes", torch.int8, 2)
    N, D = codes.shape
    for t, what, shape in ((qscale, "qscale", (N,)), (qoffset, "qoffset", (N,)),
                           (grad_sum, "grad_sum", (N, D)),
                           (grad_cnt, "grad_cnt", (N,)),
                           (grad_sqnorm, "grad_sqnorm", (N,))):
        require_cuda(t, what, torch.float32, len(shape))
        if tuple(t.shape) != shape or t.device != codes.device:
            raise ValueError(f"{what} {tuple(t.shape)} on {t.device} does "
                             f"not match codes {(N, D)} on {codes.device}")
    require_cuda(ids, "ids", torch.int64, 1)
    B = ids.shape[0]
    vals = torch.empty((B, D), dtype=torch.float32, device=codes.device)
    if B == 0:
        return vals
    launch("kb_fused_lookup_q", "kb_fused_lookup_q_launch", _ARGTYPES,
           codes.device, codes.data_ptr(), qscale.data_ptr(),
           qoffset.data_ptr(), grad_sum.data_ptr(), grad_cnt.data_ptr(),
           grad_sqnorm.data_ptr(), ids.data_ptr(), B, N, D, lazy_lr, zmax,
           fused_lookup_block(B, D), vals.data_ptr())
    kb_fused_lookup_q_cuda.launches += 1
    return vals


kb_fused_lookup_q_cuda.launches = 0
