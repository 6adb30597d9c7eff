"""Fused int8 Knowledge Bank lookup on the card (``csrc/kb_fused_lookup_q.cu``).

The Hopper kernel in place of ``repro/kernels/kb_fused_lookup.py:209``
(``kb_fused_lookup_q_pallas``): dequantize each requested row, apply its
clipped pending gradient, re-quantize only the rows that had one, zero the
caches, bump the versions, and return the dequantization of what was
written. It touches only the requested rows, in the fp32 lookup's one
launch (``csrc/kb_lookup.cuh``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.env import fused_lookup_block, stage_lookup_ids
from repro_torch.kernels._build import launch, require_cuda
from repro_torch.kernels.kb_fused_lookup import require_version

_ARGTYPES = (ctypes.c_void_p,) * 8 + (
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def kb_fused_lookup_q_cuda(codes, qscale, qoffset, grad_sum, grad_cnt,
                           grad_sqnorm, ids, *, lazy_lr: float,
                           zmax: float, version=None) -> torch.Tensor:
    """``kb_lookup_q`` on CUDA tensors, IN PLACE on the codes (N, D) int8,
    the scale/offset side-cars (N,) f32, the three caches and, where
    given, ``version`` ((N,) int32: +1 for each requested row with pending
    gradients, once however often it is requested); returns the (B, D) f32
    rows. ids: (B,) int64; ids outside [0, N) read zeros and change
    nothing, and duplicates all read the same row. One kernel launch per
    call."""
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
    if version is not None:
        require_version(version, N, codes.device)
    B = ids.shape[0]
    vals = torch.empty((B, D), dtype=torch.float32, device=codes.device)
    if B == 0:
        return vals
    rows = fused_lookup_block(B, D)
    launch("kb_fused_lookup_q", "kb_fused_lookup_q_launch", _ARGTYPES,
           codes.device, codes.data_ptr(), qscale.data_ptr(),
           qoffset.data_ptr(), grad_sum.data_ptr(), grad_cnt.data_ptr(),
           grad_sqnorm.data_ptr(),
           None if version is None else version.data_ptr(), ids.data_ptr(),
           B, N, D, lazy_lr, zmax, rows, int(stage_lookup_ids(B, D, rows)),
           vals.data_ptr())
    kb_fused_lookup_q_cuda.launches += 1
    return vals


kb_fused_lookup_q_cuda.launches = 0
