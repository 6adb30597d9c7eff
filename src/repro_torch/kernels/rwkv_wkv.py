"""The RWKV6 WKV recurrence on the card (``csrc/rwkv_wkv.cu``).

The Hopper kernel in place of ``repro/kernels/rwkv_wkv.py:54``
(``rwkv_wkv_pallas``), which every prefill layer of the rwkv6 LM reaches
through ``repro_torch.models.ssm.rwkv6_apply_state``: one block per
(batch, head) walks time with the (d, d) state in its consumer warps'
registers while a producer warp streams r, k, v and w in by TMA, and
writes the state after the last step beside y, for the decode cache. The
source's header says how.

Under autograd the launcher runs ``RwkvWkvFn``: its forward is the same
kernel, which then also writes the state at the start of every chunk of
``CHUNK`` steps; its backward is ``csrc/rwkv_wkv_bwd.cu`` (no Pallas
counterpart: JAX differentiates its checkpointed ``lax.scan``): a cluster
of blocks per (batch, head), each holding 16 columns of the state's
gradient, recomputes each chunk's states from its checkpoint in registers
and walks it backward, the blocks adding their row sums through each
other's shared memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (launch, require_cuda,
                                       require_same_stream, stream_of)

HEAD_DIMS = (16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)

CHUNK = 16          # steps between the forward's checkpoints (its TC)

_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 14 + (ctypes.c_int,) * 5 + \
    (ctypes.c_void_p,)
# the kernel's clock64 profile (csrc/rwkv_wkv.cu's P_* slots)
PROFILE_SLOTS = ("consumer_wait", "consumer_steps", "consumer_chunk_end",
                 "producer_wait_loaded", "producer_widen", "producer_c_sum",
                 "producer_refill", "consumer_warps", "producer_warps")
# the backward's (csrc/rwkv_wkv_bwd.cu's P_* slots)
BWD_PROFILE_SLOTS = ("consumer_wait", "consumer_level1", "consumer_cluster",
                     "consumer_sum", "consumer_walk", "producer_wait_loaded",
                     "producer_prepare", "producer_cluster",
                     "producer_refill", "consumer_warps", "producer_warps")


def rwkv_wkv_cuda(r, k, v, w, u):
    """r/k/v: (B, S, H, d) in one dtype (fp32 or bf16); w: (B, S, H, d)
    fp32; u: (H, d) fp32; all contiguous on one CUDA device, d in
    (16, 32, 64) -> (y (B, S, H, d), S_fin (B, H, d, d)), both fp32.
    Where autograd would record the call, it runs through ``RwkvWkvFn``,
    whose backward is the backward kernel."""
    _check(r, k, v, w, u)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (r, k, v, w, u)):
        return RwkvWkvFn.apply(r, k, v, w, u)
    return _launch(r, k, v, w, u, None)[:2]


def rwkv_wkv_checkpoints(r, k, v, w, u):
    """One launch of the forward kernel that also keeps its checkpoints:
    -> (y, S_fin, the state before each chunk of CHUNK steps (B, H,
    ceil(S / CHUNK), d, d) fp32), what ``rwkv_wkv_bwd_cuda`` takes."""
    _check(r, k, v, w, u)
    return _launch(r, k, v, w, u, None, checkpoints=True)


class RwkvWkvFn(torch.autograd.Function):
    """The WKV recurrence with the backward kernel as its backward: the
    forward keeps its inputs and the chunk-start states; the backward
    takes the gradients of y and of S_fin."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y, s_fin, ckpt = _launch(r, k, v, w, u, None, checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.stream = stream_of(r)
        return y, s_fin

    @staticmethod
    def backward(ctx, dy, ds_fin):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        require_same_stream(ctx.stream, r, "rwkv_wkv_bwd")
        dr, dk, dv, dw, du = rwkv_wkv_bwd_cuda(
            r, k, v, w, u, ckpt, dy.contiguous(), ds_fin.contiguous())
        return dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du


def rwkv_wkv_bwd_cuda(r, k, v, w, u, ckpt, dy, ds_fin):
    """The backward kernel: the forward's inputs, its checkpoints
    (``rwkv_wkv_checkpoints``), the gradient of y (B, S, H, d) and of
    S_fin (B, H, d, d), both fp32 -> (dr, dk, dv, dw (B, S, H, d), du
    (H, d)), all fp32. One call launches the kernel, a cluster of d / 16
    blocks per (batch, head) walking the chunks backward, and the pass
    that sums du's per-batch partials in a fixed order."""
    grads = _launch_bwd(r, k, v, w, u, ckpt, dy, ds_fin, None)
    if r.shape[0] * r.shape[1] * r.shape[2]:
        rwkv_wkv_bwd_cuda.launches += 1
    return grads


rwkv_wkv_bwd_cuda.launches = 0


def rwkv_wkv_bwd_cycles(r, k, v, w, u, ckpt, dy, ds_fin) -> dict:
    """One launch of the backward kernel with its clock64 profile on: the
    cycles a consumer warp spends waiting for a chunk, recomputing its
    states before steps 0, 4, 8 and 12, at the cluster barrier, adding the
    previous chunk's gradients (and, last, du's) and walking its
    sub-chunks back, and the producer warp waiting for the TMA loads,
    preparing a chunk (widening, dy . v, c_t), at the cluster barrier and
    refilling the ring; each summed over the sequence and averaged over
    the warps of that role. A measurement, not a launch of the main path:
    the count does not move."""
    prof = torch.zeros(len(BWD_PROFILE_SLOTS), dtype=torch.int64,
                       device=r.device)
    args = (r, k, v, w, u, ckpt, dy, ds_fin)
    _launch_bwd(*args, prof)                     # a warm-up
    prof.zero_()
    _launch_bwd(*args, prof)
    return _per_warp(dict(zip(BWD_PROFILE_SLOTS, prof.tolist())))


def _per_warp(raw: dict) -> dict:
    """Profile slots averaged over the warps of their role."""
    return {name: n / max(raw[f"{name.split('_')[0]}_warps"], 1)
            for name, n in raw.items() if not name.endswith("_warps")}


def _launch_bwd(r, k, v, w, u, ckpt, dy, ds_fin, prof):
    """One launch of the backward kernel on checked inputs -> (dr, dk, dv,
    dw, du)."""
    _check(r, k, v, w, u)
    B, S, H, d = r.shape
    require_cuda(ckpt, "ckpt", torch.float32, 5)
    require_cuda(dy, "dy", torch.float32, 4)
    require_cuda(ds_fin, "ds_fin", torch.float32, 4)
    if ckpt.shape != (B, H, -(-S // CHUNK), d, d):
        raise ValueError(f"ckpt {tuple(ckpt.shape)} must be (B, H, "
                         f"ceil(S / {CHUNK}), d, d)")
    if dy.shape != r.shape or ds_fin.shape != (B, H, d, d):
        raise ValueError(f"dy {tuple(dy.shape)} and ds_fin "
                         f"{tuple(ds_fin.shape)} must be (B, S, H, d) and "
                         "(B, H, d, d)")
    if len({r.device, ckpt.device, dy.device, ds_fin.device}) != 1:
        raise ValueError("the inputs lie on different devices")
    grads = [torch.empty((B, S, H, d), device=r.device) for _ in range(4)]
    du = torch.zeros((H, d), device=r.device)
    if B * S * H == 0:
        return (*grads, du)
    du_part = torch.empty((B, H, d), device=r.device)
    launch("rwkv_wkv_bwd", "rwkv_wkv_bwd_launch", _BWD_ARGTYPES, r.device,
           r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
           u.data_ptr(), ckpt.data_ptr(), dy.data_ptr(), ds_fin.data_ptr(),
           *(g.data_ptr() for g in grads), du.data_ptr(), du_part.data_ptr(),
           B, S, H, d, int(r.dtype == torch.bfloat16),
           None if prof is None else prof.data_ptr())
    return (*grads, du)


def rwkv_wkv_cycles(r, k, v, w, u) -> dict:
    """One launch with the kernel's clock64 profile on: the cycles a
    consumer warp spends waiting for a chunk, running its steps and
    closing it (y's store), and a producer warp waiting for the TMA loads,
    widening r, k, v, summing c_t and refilling the ring, each summed over
    the sequence and averaged over the warps of that role. A measurement
    of the kernel, not a launch of the main path: the count does not
    move."""
    _check(r, k, v, w, u)
    prof = torch.zeros(len(PROFILE_SLOTS), dtype=torch.int64,
                       device=r.device)
    _launch(r, k, v, w, u, prof)                 # a warm-up
    prof.zero_()
    _launch(r, k, v, w, u, prof)
    return _per_warp(dict(zip(PROFILE_SLOTS, prof.tolist())))


def _check(r, k, v, w, u) -> None:
    """Raise on what the kernels do not take."""
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


def _launch(r, k, v, w, u, prof, checkpoints: bool = False):
    """One launch on checked inputs -> (y, S_fin, the chunk-start states
    where ``checkpoints``, else None)."""
    B, S, H, d = r.shape
    y = torch.empty((B, S, H, d), dtype=torch.float32, device=r.device)
    ckpt = (torch.empty((B, H, -(-S // CHUNK), d, d), device=r.device)
            if checkpoints else None)
    if B * S * H == 0:             # no step: the state stays at 0
        return y, torch.zeros((B, H, d, d), device=r.device), ckpt
    s_fin = torch.empty((B, H, d, d), dtype=torch.float32, device=r.device)
    launch("rwkv_wkv", "rwkv_wkv_launch", _ARGTYPES, r.device,
           r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
           u.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
           None if ckpt is None else ckpt.data_ptr(), B, S, H, d,
           int(r.dtype == torch.bfloat16),
           None if prof is None else prof.data_ptr())
    if prof is None:               # a launch of the main path
        rwkv_wkv_cuda.launches += 1
    return y, s_fin, ckpt


rwkv_wkv_cuda.launches = 0
