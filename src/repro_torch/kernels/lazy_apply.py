"""Flush on the card (``csrc/lazy_apply.cu``).

The Hopper kernel in place of ``repro/kernels/lazy_apply.py:46``
(``lazy_apply_pallas``): apply every pending lazy gradient and zero all
gradient caches, one warp per row, reading only the rows that have
pending gradients.
"""
from __future__ import annotations

import ctypes

from repro_torch.env import DEFAULT_ROWS_PER_BLOCK, fit_block_rows
from repro_torch.kernels._build import launch, require_bank

_ARGTYPES = (ctypes.c_void_p,) * 4 + (
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_int)


def lazy_apply_cuda(table, grad_sum, grad_cnt, grad_sqnorm, *,
                    lazy_lr: float, zmax: float) -> None:
    """``kb_flush`` on the four leaves of CUDA tensors, in place (the
    version bump and the step are the caller's). A block takes one row per
    warp, each staging its D averaged gradients in shared memory."""
    require_bank(table, grad_sum, grad_cnt, grad_sqnorm)
    N, D = table.shape
    if N == 0:
        return
    launch("lazy_apply", "lazy_apply_launch", _ARGTYPES, table.device,
           table.data_ptr(), grad_sum.data_ptr(), grad_cnt.data_ptr(),
           grad_sqnorm.data_ptr(), N, D, lazy_lr, zmax,
           fit_block_rows(D, want=DEFAULT_ROWS_PER_BLOCK))
    lazy_apply_cuda.launches += 1


lazy_apply_cuda.launches = 0
