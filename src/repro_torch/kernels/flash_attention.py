"""Flash attention on the card (``csrc/flash_attention.cu``).

The Hopper kernel in place of ``repro/kernels/flash_attention.py:85``
(``flash_attention_pallas``), which the LM's prefill reaches through
``layers.attention``: causal, sliding-window and soft-capped attention with
an online softmax over KV tiles, skipping the tiles above the causal
diagonal or before the window. It works in the JAX layout, q (B, S, H, d)
and k/v (B, S, KV, d), and reads GQA's shared KV heads in place.

bf16 inputs (the serve path) take the warp-specialised tensor-core
kernel: one persistent block per SM walks the (head, batch, 128-query
tile) items, heaviest first; a producer thread streams each item's Q and
its K and V tiles of 128 keys by TMA into a two-stage ring, and two
consumer warpgroups of 64 query rows take turns at issuing Q.K^T and P.V
as wgmma products, with the softmax between them in registers. The
products bound it (operations), so the loads overlap them. fp32 inputs
take an FMA kernel on the CUDA cores. The source's header says how each
works; ``flash_stage_cycles`` measures where the bf16 kernel's cycles go.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import launch, require_cuda, require_no_grad

KV_TILE = 32            # keys per KV tile of the fp32 kernel (F32_BK), the
#                         tiles the plain version's fp32 arithmetic follows
BF16_Q_TILE = 128       # query rows per work item of the bf16 kernel (TQ)
BF16_KV_TILE = 128      # keys per K and V tile of the bf16 kernel (TK)
BF16_STAGES = 2         # K and V tiles in the bf16 kernel's ring (STAGES)
TMA_MAX_STRIDE = 2 ** 40  # bytes: a tensor map's strides stay below this
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + \
    (ctypes.c_float,) * 2 + (ctypes.c_void_p,)
# the bf16 kernel's stage profile (flash_attention.cu PROF_*): cycles that
# thread 0 of each consumer warpgroup spends in each stage, and the
# producer thread's
PROFILE_SLOTS = ("data", "turn", "issue_qk", "issue_pv", "products",
                 "softmax", "epilogue", "producer_blocked", "producer")


def require_tma_strides(name: str, S: int, heads: int, d: int,
                        itemsize: int = 2) -> None:
    """Raise unless a (B, S, heads, d) tensor's byte strides fit the
    bf16 kernel's tensor map (d * heads, S, B): TMA takes strides that are
    multiples of 16 bytes and below 2**40."""
    row = heads * d * itemsize
    if row % 16 or row * S >= TMA_MAX_STRIDE:
        raise ValueError(f"{name}'s strides ({row} and {row * S} bytes) do "
                         "not fit a TMA tensor map (multiples of 16 bytes, "
                         "below 2**40)")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, d), k/v: (B, S, KV, d), one dtype (fp32 or bf16), on
    one CUDA device, contiguous, d in (32, 64, 128), H a multiple of KV ->
    (B, S, H, d) in q's dtype."""
    _check(q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _launch(q, k, v, out, causal, window, softcap, None)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def _check(q, k, v) -> None:
    """Raise on what the kernels do not take."""
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
    if q.dtype == torch.bfloat16:
        require_tma_strides("q", S, H, d)
        require_tma_strides("k and v", S, KV, d)
    require_no_grad("flash_attention", q, k, v)


def _launch(q, k, v, out, causal, window, softcap, prof) -> None:
    B, S, H, d = q.shape
    launch("flash_attention", "flash_attention_launch", _ARGTYPES, q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
           k.shape[2], d, int(q.dtype == torch.bfloat16), int(causal),
           int(window), float(softcap), 1.0 / math.sqrt(d),
           None if prof is None else prof.data_ptr())


def flash_stage_cycles(q, k, v, *, causal: bool = True, window: int = 0,
                       softcap: float = 0.0) -> dict:
    """One launch of the bf16 kernel on the wrapper's checked inputs with
    its stage profile on: {stage: cycles summed over the blocks} for
    thread 0 of each consumer warpgroup (data, turn, issue_qk, issue_pv,
    products, softmax, epilogue) and for the producer thread (producer_blocked,
    producer). A measurement of the kernel, not a launch of the main
    path: the launch count does not move."""
    if q.dtype != torch.bfloat16:
        raise ValueError("the stage profile is the bf16 kernel's")
    _check(q, k, v)
    out = torch.empty_like(q)
    _launch(q, k, v, out, causal, window, softcap, None)     # a warm-up
    prof = torch.zeros(len(PROFILE_SLOTS), dtype=torch.int64,
                       device=q.device)
    _launch(q, k, v, out, causal, window, softcap, prof)
    return dict(zip(PROFILE_SLOTS, prof.tolist()))
