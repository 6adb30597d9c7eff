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
The forward and the backward take head dims ``HEAD_DIMS``, 112 among them
(kimi-k2: the bf16 kernels' tiles stay 128 wide, the sources' headers say
how).

Under autograd (grad mode on and an input that requires grad) the launcher
runs ``FlashAttentionFn``: its forward is the same kernel, which then also
writes each row's log-sum-exp; its backward is
``csrc/flash_attention_bwd.cu`` (no Pallas counterpart: JAX differentiates
``flash_attention_jax``), which recomputes P from the log-sum-exp: for
bf16 inputs two warp-specialised tensor-core kernels (dK and dV per 128
keys of a KV head, dQ per 128 queries of a head; every product a wgmma on
tiles that TMA streams, P and dS as bf16 hi and lo parts), for fp32 FMAs
on the CUDA cores. The wgmma helpers both sources use are in
``csrc/wgmma.cuh``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import (launch, require_cuda,
                                       require_same_stream, stream_of)

KV_TILE = 32            # keys per KV tile of the fp32 kernel (F32_BK), the
#                         tiles the plain version's fp32 arithmetic follows
BF16_Q_TILE = 128       # query rows per work item of the bf16 kernel (TQ)
BF16_KV_TILE = 128      # keys per K and V tile of the bf16 kernel (TK)
BF16_STAGES = 2         # K and V tiles in the bf16 kernel's ring (STAGES)
TMA_MAX_STRIDE = 2 ** 40  # bytes: a tensor map's strides stay below this
BWD_KEY_TILE = 128      # keys per tile of the plain backward (memory only)
HEAD_DIMS = (32, 64, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + \
    (ctypes.c_float,) * 2 + (ctypes.c_void_p,) * 2
_BWD_ARGTYPES = (ctypes.c_void_p,) * 12 + (ctypes.c_int,) * 10 + \
    (ctypes.c_float,) * 2
BWD_BF16_ROWS = 128     # keys or queries a block of the bf16 backward owns
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
    one CUDA device, contiguous, d in ``HEAD_DIMS``, H a multiple of KV ->
    (B, S, H, d) in q's dtype. Where autograd would record the call, it
    runs through ``FlashAttentionFn``, whose backward is the backward
    kernel."""
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap, False)[0]


flash_attention_cuda.launches = 0


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """One launch of the forward kernel that also writes the rows'
    log-sum-exp: -> (out, lse (B, H, S) fp32), what
    ``flash_attention_bwd_cuda`` takes."""
    _check(q, k, v)
    return _forward(q, k, v, causal, window, softcap, True)


def _forward(q, k, v, causal, window, softcap, with_lse: bool):
    """One launch of the forward kernel on checked inputs -> (out, the
    rows' log-sum-exp (B, H, S) fp32 where ``with_lse``, else None)."""
    B, S, H, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    _launch(q, k, v, out, causal, window, softcap, None, lse)
    flash_attention_cuda.launches += 1
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with the backward kernel as its backward: the
    forward keeps q, k, v, the output and the rows' log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = _forward(q, k, v, causal, window, softcap, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap)
        ctx.stream = stream_of(q)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        require_same_stream(ctx.stream, q, "flash_attention_bwd")
        causal, window, softcap = ctx.opts
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, lse, dout.contiguous(), causal=causal,
            window=window, softcap=softcap)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """The backward kernel: q, k, v, the forward's ``out`` and ``dout``
    (all in the forward's layout and dtype) and ``lse`` (B, H, S) fp32 ->
    (dq, dk, dv) fp32 in the shapes of q, k and v. One call launches a
    pre-pass for D = rowsum(dout * out), the dK/dV kernel and the dQ
    kernel (csrc/flash_attention_bwd.cu): with bf16 inputs the
    tensor-core kernels, which read q, k, v and dout by TMA."""
    _check(q, k, v)
    B, S, H, d = q.shape
    for name, t in (("out", out), ("dout", dout)):
        require_cuda(t, name, q.dtype, 4)
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have q's shape "
                             f"{tuple(q.shape)}")
    if dout.data_ptr() % 16:
        raise ValueError("dout must start on a 16-byte boundary (the "
                         "kernel reads 16 bytes at a time)")
    require_cuda(lse, "lse", torch.float32, 3)
    if lse.shape != (B, H, S):
        raise ValueError(f"lse {tuple(lse.shape)} must be (B, H, S) = "
                         f"({B}, {H}, {S})")
    if len({q.device, out.device, dout.device, lse.device}) != 1:
        raise ValueError("q, out, dout and lse lie on different devices")
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return dq, dk, dv
    bf16 = q.dtype == torch.bfloat16
    KV = k.shape[2]
    lse_pad = part = None
    groups = 1
    if bf16:
        # D and a copy of lse in rows of SP entries, zeros past S
        sp = -(-S // BWD_BF16_ROWS) * BWD_BF16_ROWS
        dvec = torch.zeros((B, H, sp), dtype=torch.float32, device=q.device)
        lse_pad = torch.zeros_like(dvec)
        groups = heads_split(B, S, KV, H // KV, sm_count(q.device))
        if groups > 1:
            part = torch.empty((2, groups) + tuple(k.shape),
                               dtype=torch.float32, device=q.device)
    else:
        sp = S
        dvec = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    launch("flash_attention_bwd", "flash_attention_bwd_launch",
           _BWD_ARGTYPES, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
           ptr(lse_pad), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           ptr(part), B, S, sp, H, KV, groups, d, int(bf16), int(causal),
           int(window), float(softcap), 1.0 / math.sqrt(d))
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


def sm_count(device) -> int:
    """The streaming multiprocessors of ``device``, a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def heads_split(B: int, S: int, KV: int, G: int, sms: int) -> int:
    """The groups the bf16 dK/dV kernel splits each KV head's G query heads
    into: the fewest (a divisor of G) that give at least two blocks an SM.
    Its blocks own 128 keys of one KV head, so at a small batch there are
    fewer of them than SMs, and the causal ones at the start of the
    sequence carry the most work; a group's block writes its partial dK
    and dV, which a second pass adds in the groups' order."""
    blocks = -(-S // BWD_BF16_ROWS) * KV * B
    return next(p for p in range(1, G + 1)
                if G % p == 0 and (blocks * p >= 2 * sms or p == G))


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


def _launch(q, k, v, out, causal, window, softcap, prof, lse=None) -> None:
    B, S, H, d = q.shape
    launch("flash_attention", "flash_attention_launch", _ARGTYPES, q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
           k.shape[2], d, int(q.dtype == torch.bfloat16), int(causal),
           int(window), float(softcap), 1.0 / math.sqrt(d),
           None if lse is None else lse.data_ptr(),
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
