"""AdamW's step on the card (``csrc/adamw.cu``).

No Pallas kernel stands behind it: JAX's update
(``repro/optim/optimizer.py:37-73``) is jnp code that XLA fuses. Its eager
port (``ref.adamw_ref``) runs about twenty elementwise kernels per chunk
of 2^24 entries, which took most of a training step's device time; this
kernel is that fusion written by hand. One call is the whole step over a
tree's leaves: per leaf a launch of the norm's partial sums, one launch
that adds them in a fixed order into the global norm and the clip scale
(both left on the card), and per leaf a launch of the update, which reads
the scale, the bias corrections and the learning rate through pointers,
so that a step never waits on the host. Each entry's arithmetic is the
eager version's, operation for operation: given the same scale, the new
parameters and moments are bit-identical to ``ref.adamw_update_ref``'s.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import launch, require_cuda

NORM_SLOTS = 1024       # partial sums a leaf (adamw.cu NORM_SLOTS)
GRAD_DTYPES = PARAM_DTYPES = MOMENT_DTYPES = (torch.float32,
                                              torch.bfloat16)

_ARGTYPES = (ctypes.c_int,) + (ctypes.c_void_p,) * 6 + \
    (ctypes.c_void_p,) * 5 + (ctypes.c_float,) * 7


def leaf_kind(g, p, m, v) -> int:
    """The kernel's code of one leaf's dtypes (bit 0: g bf16, bit 1: p
    bf16, bit 2: the moments bf16); raises ValueError, naming the
    combination, on one the kernel does not take."""
    if (g.dtype not in GRAD_DTYPES or p.dtype not in PARAM_DTYPES
            or m.dtype not in MOMENT_DTYPES or v.dtype != m.dtype):
        raise ValueError(
            "the AdamW kernel takes gradients and parameters in bf16 or "
            "fp32 and both moments in one of fp32 or bf16; got gradient "
            f"{g.dtype}, parameter {p.dtype}, moments {m.dtype} and "
            f"{v.dtype}")
    return (int(g.dtype == torch.bfloat16)
            | int(p.dtype == torch.bfloat16) << 1
            | int(m.dtype == torch.bfloat16) << 2)


def _require_scalar(t, name: str) -> None:
    require_cuda(t, name, torch.float32, 0)


def adamw_cuda(grads, mus, nus, params, bc1, bc2, lr, *, b1: float,
               b2: float, eps: float, weight_decay: float,
               clip_norm: float):
    """One AdamW step over lists of leaves (gradients, first and second
    moments, parameters: one shape a leaf, contiguous CUDA tensors on one
    device), in place. ``bc1``, ``bc2`` and ``lr`` are 0-d fp32 tensors on
    that device. Returns (gn, scale), 0-d fp32 tensors on the card: the
    global norm of the unclipped gradients and the clip scale (1 where
    ``clip_norm`` <= 0, which then is not applied)."""
    leaves = list(zip(grads, mus, nus, params))
    if not leaves:
        raise ValueError("AdamW takes at least one leaf")
    kinds = []
    for i, (g, m, v, p) in enumerate(leaves):
        kinds.append(leaf_kind(g, p, m, v))
        for name, t in (("gradient", g), ("first moment", m),
                        ("second moment", v), ("parameter", p)):
            require_cuda(t, f"leaf {i}'s {name}", t.dtype, t.dim())
            if t.shape != p.shape:
                raise ValueError(f"leaf {i}'s {name} {tuple(t.shape)} does "
                                 f"not have its parameter's shape "
                                 f"{tuple(p.shape)}")
    for name, t in (("bc1", bc1), ("bc2", bc2), ("lr", lr)):
        _require_scalar(t, name)
    device = params[0].device
    if len({t.device for leaf in leaves for t in leaf}
           | {bc1.device, bc2.device, lr.device}) != 1:
        raise ValueError("the leaves and scalars lie on different devices")
    n = len(leaves)
    slots = torch.empty(n * NORM_SLOTS, dtype=torch.float64, device=device)
    out = torch.empty(2, dtype=torch.float32, device=device)
    arr = lambda ctype, vals: (ctype * n)(*vals)
    ptrs = [arr(ctypes.c_void_p, [t.data_ptr() for t in col])
            for col in (grads, mus, nus, params)]
    numel = arr(ctypes.c_longlong, [p.numel() for p in params])
    kind = arr(ctypes.c_int, kinds)
    launch("adamw", "adamw_launch", _ARGTYPES, device, n,
           *(ctypes.addressof(a) for a in ptrs), ctypes.addressof(numel),
           ctypes.addressof(kind), slots.data_ptr(), out.data_ptr(),
           bc1.data_ptr(), bc2.data_ptr(), lr.data_ptr(), b1, 1 - b1, b2,
           1 - b2, eps, weight_decay,
           clip_norm if clip_norm and clip_norm > 0 else 0.0)
    adamw_cuda.launches += 1
    return out[0], out[1]


adamw_cuda.launches = 0
