"""Flash attention on the card (``csrc/flash_attention.cu``).

The Hopper kernel in place of ``repro/kernels/flash_attention.py:85``
(``flash_attention_pallas``), which the LM's prefill reaches through
``layers.attention``: causal, sliding-window and soft-capped attention with
an online softmax over KV tiles, skipping the tiles above the causal
diagonal or before the window. It works in the JAX layout, q (B, S, H, d)
and k/v (B, S, KV, d), and reads GQA's shared KV heads in place. The
source's header says how.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import launch, require_cuda

KV_TILE = 32            # keys per KV tile (flash_attention.cu F32_BK)
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (ctypes.c_float,
                                                           ) * 2


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, d), k/v: (B, S, KV, d), one dtype (fp32 or bf16), on
    one CUDA device, contiguous, d in (32, 64, 128), H a multiple of KV ->
    (B, S, H, d) in q's dtype."""
    if q.dtype not in DTYPES:
        raise ValueError(f"flash attention takes fp32 or bf16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require_cuda(t, name, q.dtype, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel reads 16 bytes at a time)")
    B, S, H, d = q.shape
    KV = k.shape[2]
    if k.shape != (B, S, KV, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, S, KV, d) = ({B}, {S}, KV, {d})")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV "
                         "heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v lie on different devices")
    out = torch.empty_like(q)
    if B * S == 0:
        return out
    launch("flash_attention", "flash_attention_launch", _ARGTYPES, q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
           KV, d, int(q.dtype == torch.bfloat16), int(causal), int(window),
           float(softcap), 1.0 / math.sqrt(d))
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
