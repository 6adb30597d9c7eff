"""The Mamba selective scan on the card (``csrc/mamba_scan.cu``).

The Hopper kernel in place of ``repro/kernels/mamba_scan.py:55``
(``mamba_scan_pallas``), which every prefill Mamba layer of the jamba LM
reaches through ``repro_torch.models.ssm.mamba_apply_state``: one thread
per (batch, channel) walks time with the channel's ds states in
registers, each exp one MUFU instruction, while a producer warp streams
delta, x, B and C in by TMA; it stores y each step from registers and
writes the state after the last step beside y, for the decode cache.
The source's header says how.

Under autograd the launcher runs ``MambaScanFn``: its forward is the same
kernel, which then also writes each channel's state at the start of every
chunk of ``CHUNK`` steps; its backward is ``csrc/mamba_scan_bwd.cu`` (no
Pallas counterpart: JAX differentiates its checkpointed ``lax.scan``),
which recomputes each chunk's states and decays from its checkpoint in
registers with the forward's own exp2 and walks it backward, ds / 4 lanes
a channel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import (launch, require_cuda,
                                       require_same_stream, stream_of)

STATE_DIMS = (4, 8, 16, 32)
X_DTYPES = (torch.float32, torch.bfloat16)
DI_MULTIPLE = 8     # the kernel takes di in multiples of it (pad_channels)

CHUNK = 16          # steps between the forward's checkpoints (its TC)
# channels a block of the backward kernel (its Cfg::NCH) by state dim: a
# block sums dB and dC over them before it writes a partial
BWD_CHANNELS = {4: 128, 8: 128, 16: 128, 32: 32}

_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 15 + (ctypes.c_int,) * 5 + \
    (ctypes.c_void_p,)
# the kernel's clock64 profile (csrc/mamba_scan.cu's P_* slots)
PROFILE_SLOTS = ("consumer_wait", "consumer_steps", "consumer_chunk_end",
                 "producer_wait_empty", "producer_issue", "consumer_warps",
                 "producer_threads")
# the backward's (csrc/mamba_scan_bwd.cu's P_* slots)
BWD_PROFILE_SLOTS = ("consumer_wait", "consumer_level1", "consumer_walk",
                     "consumer_sync", "consumer_sum", "producer_wait_empty",
                     "producer_issue", "consumer_warps", "producer_threads")


def mamba_scan_cuda(delta, bm, cm, x, A):
    """delta (B, S, di), bm/cm (B, S, ds) and A (di, ds) fp32; x
    (B, S, di) fp32 or bf16; all contiguous on one CUDA device, ds in
    (4, 8, 16, 32) -> (y (B, S, di), h_fin (B, di, ds)), both fp32.
    Where autograd would record the call, it runs through
    ``MambaScanFn``, whose backward is the backward kernel."""
    _check(delta, bm, cm, x, A)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (delta, bm, cm, x, A)):
        return MambaScanFn.apply(delta, bm, cm, x, A)
    di = delta.shape[-1]
    y, h_fin, _ = _launch(*_padded(delta, bm, cm, x, A), None)
    return _cut(y, h_fin, di)


def mamba_scan_checkpoints(delta, bm, cm, x, A):
    """One launch of the forward kernel that also keeps its checkpoints,
    on inputs whose di is a multiple of DI_MULTIPLE: -> (y, h_fin, each
    channel's state before each chunk of CHUNK steps (B, ceil(S / CHUNK),
    di, ds) fp32), what ``mamba_scan_bwd_cuda`` takes."""
    _check(delta, bm, cm, x, A)
    if delta.shape[-1] % DI_MULTIPLE:
        raise ValueError(f"di {delta.shape[-1]} is no multiple of "
                         f"{DI_MULTIPLE}: pad_channels first")
    return _launch(delta, bm, cm, x, A, None, checkpoints=True)


class MambaScanFn(torch.autograd.Function):
    """The selective scan with the backward kernel as its backward: the
    forward keeps its inputs, padded to a multiple of DI_MULTIPLE
    channels, and the chunk-start states; the backward takes the
    gradients of y and of h_fin and cuts the padded channels' gradients
    off."""

    @staticmethod
    def forward(ctx, delta, bm, cm, x, A):
        di = delta.shape[-1]
        padded = _padded(delta, bm, cm, x, A)
        y, h_fin, ckpt = _launch(*padded, None, checkpoints=True)
        ctx.save_for_backward(*padded, ckpt)
        ctx.di = di
        ctx.stream = stream_of(delta)
        return _cut(y, h_fin, di)

    @staticmethod
    def backward(ctx, dy, dh_fin):
        delta, bm, cm, x, A, ckpt = ctx.saved_tensors
        require_same_stream(ctx.stream, delta, "mamba_scan_bwd")
        di, pad = ctx.di, delta.shape[-1] - ctx.di
        dy = F.pad(dy, (0, pad)) if pad else dy.contiguous()
        dh_fin = F.pad(dh_fin, (0, 0, 0, pad)) if pad else \
            dh_fin.contiguous()
        dd, dbm, dcm, dx, dA = mamba_scan_bwd_cuda(delta, bm, cm, x, A, ckpt,
                                                   dy, dh_fin)
        if pad:
            dd, dx, dA = dd[..., :di], dx[..., :di], dA[:di]
        return dd, dbm, dcm, dx.to(x.dtype), dA


def mamba_scan_bwd_cuda(delta, bm, cm, x, A, ckpt, dy, dh_fin):
    """The backward kernel: the forward's inputs (di a multiple of
    DI_MULTIPLE), its checkpoints (``mamba_scan_checkpoints``), the
    gradient of y (B, S, di) and of h_fin (B, di, ds), both fp32 ->
    (ddelta, dbm, dcm, dx, dA), fp32 in the shapes of delta, bm, cm, x
    and A. One call launches the kernel, ds / 4 lanes a (batch, channel)
    walking the chunks backward, which writes dB and dC as sums over each
    block's ``BWD_CHANNELS[ds]`` channels and dA per batch, and the pass
    that sums those partials in a fixed order."""
    grads = _launch_bwd(delta, bm, cm, x, A, ckpt, dy, dh_fin, None)
    if delta.numel():
        mamba_scan_bwd_cuda.launches += 1
    return grads


mamba_scan_bwd_cuda.launches = 0


def mamba_scan_bwd_cycles(delta, bm, cm, x, A, ckpt, dy, dh_fin) -> dict:
    """One launch of the backward kernel with its clock64 profile on: the
    cycles a consumer warp spends waiting for a chunk, recomputing its
    states before steps 0, 4, 8 and 12, walking its sub-chunks back, at
    the consumers' barrier and adding the block's dB and dC, and the
    producer thread waiting for a free stage and issuing the loads; each
    summed over the sequence and averaged over the warps (threads) of that
    role. A measurement, not a launch of the main path: the count does not
    move."""
    prof = torch.zeros(len(BWD_PROFILE_SLOTS), dtype=torch.int64,
                       device=delta.device)
    args = (delta, bm, cm, x, A, ckpt, dy, dh_fin)
    _launch_bwd(*args, prof)                     # a warm-up
    prof.zero_()
    _launch_bwd(*args, prof)
    raw = dict(zip(BWD_PROFILE_SLOTS, prof.tolist()))
    return {name: n / max(raw["consumer_warps" if name.startswith(
                "consumer") else "producer_threads"], 1)
            for name, n in raw.items()
            if name not in ("consumer_warps", "producer_threads")}


def _launch_bwd(delta, bm, cm, x, A, ckpt, dy, dh_fin, prof):
    """One launch of the backward kernel on checked inputs -> (ddelta,
    dbm, dcm, dx, dA)."""
    _check(delta, bm, cm, x, A)
    B, S, di = delta.shape
    ds = A.shape[-1]
    if di % DI_MULTIPLE:
        raise ValueError(f"di {di} is no multiple of {DI_MULTIPLE}")
    require_cuda(ckpt, "ckpt", torch.float32, 4)
    require_cuda(dy, "dy", torch.float32, 3)
    require_cuda(dh_fin, "dh_fin", torch.float32, 3)
    if ckpt.shape != (B, -(-S // CHUNK), di, ds):
        raise ValueError(f"ckpt {tuple(ckpt.shape)} must be (B, ceil(S / "
                         f"{CHUNK}), di, ds)")
    if dy.shape != delta.shape or dh_fin.shape != (B, di, ds):
        raise ValueError(f"dy {tuple(dy.shape)} and dh_fin "
                         f"{tuple(dh_fin.shape)} must be (B, S, di) and "
                         "(B, di, ds)")
    if len({delta.device, ckpt.device, dy.device, dh_fin.device}) != 1:
        raise ValueError("the inputs lie on different devices")
    dev = delta.device
    ddelta, dx = (torch.empty((B, S, di), device=dev) for _ in range(2))
    dbm, dcm = (torch.zeros((B, S, ds), device=dev) for _ in range(2))
    dA = torch.zeros((di, ds), device=dev)
    if B * S * di == 0:
        return ddelta, dbm, dcm, dx, dA
    da_part, bc_part = bwd_scratch(B, S, di, ds, dev)
    launch("mamba_scan_bwd", "mamba_scan_bwd_launch", _BWD_ARGTYPES, dev,
           delta.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
           A.data_ptr(), ckpt.data_ptr(), dy.data_ptr(), dh_fin.data_ptr(),
           ddelta.data_ptr(), dbm.data_ptr(), dcm.data_ptr(), dx.data_ptr(),
           dA.data_ptr(), da_part.data_ptr(), bc_part.data_ptr(), B, S, di,
           ds, int(x.dtype == torch.bfloat16),
           None if prof is None else prof.data_ptr())
    return ddelta, dbm, dcm, dx, dA


def bwd_scratch(B: int, S: int, di: int, ds: int, device):
    """The backward kernel's scratch: dA per batch (B, di, ds) and dB, dC
    per block of ``BWD_CHANNELS[ds]`` channels (B, blocks, S, 2 ds), both
    fp32, which its second pass sums in a fixed order."""
    blocks = -(-di // BWD_CHANNELS[ds])
    return (torch.empty((B, di, ds), device=device),
            torch.empty((B, blocks, S, 2 * ds), device=device))


def mamba_scan_cycles(delta, bm, cm, x, A) -> dict:
    """One launch with the kernel's clock64 profile on: the cycles a
    consumer warp spends waiting for a chunk, running its steps (y stored
    each step) and handing the stage back, and the producer
    thread waiting for a free stage and issuing the loads, each summed
    over the sequence and averaged over the warps (threads) of that role.
    A measurement of the kernel, not a launch of the main path: the count
    does not move."""
    _check(delta, bm, cm, x, A)
    args = _padded(delta, bm, cm, x, A)
    prof = torch.zeros(len(PROFILE_SLOTS), dtype=torch.int64,
                       device=delta.device)
    _launch(*args, prof)                         # a warm-up
    prof.zero_()
    _launch(*args, prof)
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


def _padded(delta, bm, cm, x, A):
    """The kernel's inputs with di padded to a multiple of DI_MULTIPLE."""
    if delta.shape[-1] % DI_MULTIPLE:
        delta, x, A = pad_channels(delta, x, A)
    return delta, bm, cm, x, A


def _cut(y, h_fin, di: int):
    """y and h_fin without the padded channels."""
    if y.shape[-1] == di:
        return y, h_fin
    return y[..., :di].contiguous(), h_fin[:, :di].contiguous()


def _check(delta, bm, cm, x, A) -> None:
    """Raise on what the kernels do not take."""
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


def _launch(delta, bm, cm, x, A, prof, checkpoints: bool = False):
    """One launch on checked inputs whose di is a multiple of DI_MULTIPLE
    -> (y, h_fin, the chunk-start states where ``checkpoints``, else
    None)."""
    B, S, di = delta.shape
    ds = A.shape[-1]
    y = torch.empty((B, S, di), dtype=torch.float32, device=delta.device)
    ckpt = (torch.empty((B, -(-S // CHUNK), di, ds), device=delta.device)
            if checkpoints else None)
    if B * S * di == 0:            # no step: the state stays at 0
        return y, torch.zeros((B, di, ds), device=delta.device), ckpt
    h_fin = torch.empty((B, di, ds), dtype=torch.float32,
                        device=delta.device)
    launch("mamba_scan", "mamba_scan_launch", _ARGTYPES, delta.device,
           delta.data_ptr(), bm.data_ptr(), cm.data_ptr(), x.data_ptr(),
           A.data_ptr(), y.data_ptr(), h_fin.data_ptr(),
           None if ckpt is None else ckpt.data_ptr(), B, S, di, ds,
           int(x.dtype == torch.bfloat16),
           None if prof is None else prof.data_ptr())
    if prof is None:               # a launch of the main path
        mamba_scan_cuda.launches += 1
    return y, h_fin, ckpt


mamba_scan_cuda.launches = 0
