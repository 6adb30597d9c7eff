"""The Mamba selective scan on the card (``csrc/mamba_scan.cu``).

The Hopper kernel in place of ``repro/kernels/mamba_scan.py:55``
(``mamba_scan_pallas``), which every prefill Mamba layer of the jamba LM
reaches through ``repro_torch.models.ssm.mamba_apply_state``: one thread
per (batch, channel) walks time with the channel's ds states in
registers, each exp one MUFU instruction, while a producer warp streams
delta, x, B and C in by TMA; it stores y each step from registers and
writes the state after the last step beside y, for the decode cache.
The source's header says how.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import launch, require_cuda, require_no_grad

STATE_DIMS = (4, 8, 16, 32)
X_DTYPES = (torch.float32, torch.bfloat16)
DI_MULTIPLE = 8     # the kernel takes di in multiples of it (pad_channels)

_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
# the kernel's clock64 profile (csrc/mamba_scan.cu's P_* slots)
PROFILE_SLOTS = ("consumer_wait", "consumer_steps", "consumer_chunk_end",
                 "producer_wait_empty", "producer_issue", "consumer_warps",
                 "producer_threads")


def mamba_scan_cuda(delta, bm, cm, x, A):
    """delta (B, S, di), bm/cm (B, S, ds) and A (di, ds) fp32; x
    (B, S, di) fp32 or bf16; all contiguous on one CUDA device, ds in
    (4, 8, 16, 32) -> (y (B, S, di), h_fin (B, di, ds)), both fp32."""
    return _launch(delta, bm, cm, x, A, None)


def mamba_scan_cycles(delta, bm, cm, x, A) -> dict:
    """One launch with the kernel's clock64 profile on: the cycles a
    consumer warp spends waiting for a chunk, running its steps (y stored
    each step) and handing the stage back, and the producer
    thread waiting for a free stage and issuing the loads, each summed
    over the sequence and averaged over the warps (threads) of that role.
    A measurement of the kernel, not a launch of the main path: the count
    does not move."""
    prof = torch.zeros(len(PROFILE_SLOTS), dtype=torch.int64,
                       device=delta.device)
    _launch(delta, bm, cm, x, A, prof)           # a warm-up
    prof.zero_()
    _launch(delta, bm, cm, x, A, prof)
    raw = dict(zip(PROFILE_SLOTS, prof.tolist()))
    return {name: n / max(raw["consumer_warps" if name.startswith(
                "consumer") else "producer_threads"], 1)
            for name, n in raw.items()
            if name not in ("consumer_warps", "producer_threads")}


def pad_channels(delta, x, A):
    """delta and x (B, S, di) and A (di, ds) with zero channels appended up
    to a multiple of DI_MULTIPLE channels: TMA takes rows of a multiple of
    16 bytes. A zero channel (delta, x and A all 0) keeps its h at 0 and
    its y at 0, so the launch cuts the added channels off again."""
    pad = -delta.shape[-1] % DI_MULTIPLE
    if not pad:
        return delta, x, A
    return F.pad(delta, (0, pad)), F.pad(x, (0, pad)), F.pad(A, (0, 0, 0, pad))


def _launch(delta, bm, cm, x, A, prof):
    if x.dtype not in X_DTYPES:
        raise ValueError(f"the Mamba scan kernel takes fp32 or bf16 x, got "
                         f"{x.dtype}")
    B, S, di = delta.shape
    ds = A.shape[-1]
    if ds not in STATE_DIMS:
        raise ValueError(f"state dim {ds} not in {STATE_DIMS}")
    if x.shape != delta.shape:
        raise ValueError(f"x {tuple(x.shape)} must have delta's shape "
                         f"{tuple(delta.shape)}")
    for name, t in (("bm", bm), ("cm", cm)):
        if t.shape != (B, S, ds):
            raise ValueError(f"{name} {tuple(t.shape)} must be (B, S, ds) = "
                             f"({B}, {S}, {ds})")
    if A.shape != (di, ds):
        raise ValueError(f"A {tuple(A.shape)} must be (di, ds) = ({di}, "
                         f"{ds})")
    for name, t, dtype, ndim in (("delta", delta, torch.float32, 3),
                                 ("bm", bm, torch.float32, 3),
                                 ("cm", cm, torch.float32, 3),
                                 ("x", x, x.dtype, 3),
                                 ("A", A, torch.float32, 2)):
        require_cuda(t, name, dtype, ndim)
    for name, t in (("delta", delta), ("bm", bm), ("cm", cm), ("x", x)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel reads it by TMA)")
    if len({delta.device, bm.device, cm.device, x.device, A.device}) != 1:
        raise ValueError("delta, bm, cm, x and A lie on different devices")
    require_no_grad("mamba_scan", delta, bm, cm, x, A)
    if di % DI_MULTIPLE:
        delta, x, A = pad_channels(delta, x, A)
        y, h_fin = _launch(delta, bm, cm, x, A, prof)
        return y[..., :di].contiguous(), h_fin[:, :di].contiguous()
    y = torch.empty((B, S, di), dtype=torch.float32, device=delta.device)
    if B * S * di == 0:            # no step: the state stays at 0
        return y, torch.zeros((B, di, ds), device=delta.device)
    h_fin = torch.empty((B, di, ds), dtype=torch.float32,
                        device=delta.device)
    launch("mamba_scan", "mamba_scan_launch", _ARGTYPES, delta.device,
           delta.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
           A.data_ptr(), y.data_ptr(), h_fin.data_ptr(), B, S, di, ds,
           int(x.dtype == torch.bfloat16),
           None if prof is None else prof.data_ptr())
    if prof is None:               # a launch of the main path
        mamba_scan_cuda.launches += 1
    return y, h_fin


mamba_scan_cuda.launches = 0
