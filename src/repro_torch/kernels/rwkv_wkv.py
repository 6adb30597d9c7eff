"""The RWKV6 WKV recurrence on the card (``csrc/rwkv_wkv.cu``).

The Hopper kernel in place of ``repro/kernels/rwkv_wkv.py:54``
(``rwkv_wkv_pallas``), which every prefill layer of the rwkv6 LM reaches
through ``repro_torch.models.ssm.rwkv6_apply_state``: one block per
(batch, head) walks time with the (d, d) state in its consumer warps'
registers while a producer warp streams r, k, v and w in by TMA, and
writes the state after the last step beside y, for the decode cache. The
source's header says how.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import launch, require_cuda, require_no_grad

HEAD_DIMS = (16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)

_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
# the kernel's clock64 profile (csrc/rwkv_wkv.cu's P_* slots)
PROFILE_SLOTS = ("consumer_wait", "consumer_steps", "consumer_chunk_end",
                 "producer_wait_loaded", "producer_widen", "producer_c_sum",
                 "producer_refill", "consumer_warps", "producer_warps")


def rwkv_wkv_cuda(r, k, v, w, u):
    """r/k/v: (B, S, H, d) in one dtype (fp32 or bf16); w: (B, S, H, d)
    fp32; u: (H, d) fp32; all contiguous on one CUDA device, d in
    (16, 32, 64) -> (y (B, S, H, d), S_fin (B, H, d, d)), both fp32."""
    return _launch(r, k, v, w, u, None)


def rwkv_wkv_cycles(r, k, v, w, u) -> dict:
    """One launch with the kernel's clock64 profile on: the cycles a
    consumer warp spends waiting for a chunk, running its steps and
    closing it (y's store), and a producer warp waiting for the TMA loads,
    widening r, k, v, summing c_t and refilling the ring, each summed over
    the sequence and averaged over the warps of that role. A measurement
    of the kernel, not a launch of the main path: the count does not
    move."""
    prof = torch.zeros(len(PROFILE_SLOTS), dtype=torch.int64,
                       device=r.device)
    _launch(r, k, v, w, u, prof)                 # a warm-up
    prof.zero_()
    _launch(r, k, v, w, u, prof)
    raw = dict(zip(PROFILE_SLOTS, prof.tolist()))
    out = {}
    for name, n in raw.items():
        if not name.endswith("_warps"):
            role = name.split("_")[0]
            out[name] = n / max(raw[f"{role}_warps"], 1)
    return out


def _launch(r, k, v, w, u, prof):
    if r.dtype not in DTYPES:
        raise ValueError(f"the WKV kernel takes fp32 or bf16 r/k/v, got "
                         f"{r.dtype}")
    B, S, H, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have r's shape "
                             f"{tuple(r.shape)}")
    if u.shape != (H, d):
        raise ValueError(f"u {tuple(u.shape)} must be (H, d) = ({H}, {d})")
    for name, t, dtype in (("r", r, r.dtype), ("k", k, r.dtype),
                           ("v", v, r.dtype), ("w", w, torch.float32)):
        require_cuda(t, name, dtype, 4)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(the kernel reads it by TMA)")
    require_cuda(u, "u", torch.float32, 2)
    if u.data_ptr() % 16:
        raise ValueError("u must start on a 16-byte boundary (the kernel "
                         "reads it as float4s)")
    if len({r.device, k.device, v.device, w.device, u.device}) != 1:
        raise ValueError("r, k, v, w and u lie on different devices")
    require_no_grad("rwkv_wkv", r, k, v, w, u)
    y = torch.empty((B, S, H, d), dtype=torch.float32, device=r.device)
    if B * S * H == 0:             # no step: the state stays at 0
        return y, torch.zeros((B, H, d, d), device=r.device)
    s_fin = torch.empty((B, H, d, d), dtype=torch.float32, device=r.device)
    launch("rwkv_wkv", "rwkv_wkv_launch", _ARGTYPES, r.device,
           r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
           u.data_ptr(), y.data_ptr(), s_fin.data_ptr(), B, S, H, d,
           int(r.dtype == torch.bfloat16),
           None if prof is None else prof.data_ptr())
    if prof is None:               # a launch of the main path
        rwkv_wkv_cuda.launches += 1
    return y, s_fin


rwkv_wkv_cuda.launches = 0
