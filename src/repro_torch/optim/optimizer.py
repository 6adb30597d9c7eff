"""AdamW with optional low-precision moments, global-norm clipping, and
warmup-cosine / warmup-stable-decay schedules; the port of
``repro/optim/optimizer.py``.

The update is the JAX function's, operation for operation: every gradient
in fp32, clipped by one global scale, moments in fp32 and stored in
``moments_dtype``, bias correction and ``lr(count)`` at the incremented
count, the new parameter rounded back to its dtype (round to nearest
even, as ``astype`` rounds). On the card it is one call of the AdamW
kernel (``kernels/adamw.py``: the global norm summed in a fixed order,
then one fused pass a leaf); on the CPU, and only there, its plain
version (``ref.adamw_ref``). Two differences of form from JAX:

- **In place.** JAX casts the whole gradient tree to fp32 before it
  starts (at the full width of yi-6b a 13 GB copy). Here the parameters
  and moments are overwritten in place and ``update`` returns the objects
  it was given. The kernel reads each entry once; the plain version
  widens each leaf ``CHUNK`` entries at a time under ``torch.no_grad()``
  (a layer-stacked leaf of yi-6b holds up to 721 M entries, 2.9 GB in
  fp32), so its fp32 temporaries are a few of one chunk's. Each entry's
  arithmetic is the same whatever the chunking, and the kernel's is the
  plain version's.
- The global norm adds the leaves' fp32 sums of squares in JAX's leaf
  order (each dict's keys sorted); in the plain version a leaf's sum is
  its chunks' sums added in order, in the kernel fixed partial sums in
  fp64.

``count`` is a () int32 tensor on the parameters' device, and a schedule
maps it to a () fp32 tensor there, so a step never waits on the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.adamw import adamw_cuda
from repro_torch.tree import tree_leaves, tree_map


# entries of a leaf the plain version widens to fp32 at a time (64 MB a
# temporary)
CHUNK = 1 << 24


class AdamWState(NamedTuple):
    count: torch.Tensor
    mu: dict
    nu: dict


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        dt = getattr(torch, self.moments_dtype)
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One step from ``grads`` (a tree shaped like ``params``).
        Returns (params, state, global norm of the unclipped gradients),
        ``params`` and ``state`` updated in place: by the AdamW kernel on
        the card, by its plain version for parameters on the CPU."""
        state.count.add_(1)
        count = state.count
        bc1 = 1 - self.b1 ** count
        bc2 = 1 - self.b2 ** count
        lr = self.lr(count)
        leaves = [tree_leaves(t) for t in (grads, state.mu, state.nu,
                                           params)]
        kw = dict(b1=self.b1, b2=self.b2, eps=self.eps,
                  weight_decay=self.weight_decay, clip_norm=self.clip_norm)
        if leaves[3] and on_cpu(leaves[3][0]):
            gn, _ = ref.adamw_ref(*leaves, bc1, bc2, lr, chunk=CHUNK, **kw)
        else:
            gn, _ = adamw_cuda(*leaves, bc1, bc2, lr.to(torch.float32),
                               **kw)
        return params, state, gn


def on_cpu(t: torch.Tensor) -> bool:
    """Whether the update of ``t``'s tree takes the plain version."""
    return t.device.type == "cpu"


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX's order) of each leaf's fp32 sum
    of squares (the plain version's, ``CHUNK`` entries at a time)."""
    return ref.global_norm_ref(tree_leaves(tree), CHUNK)


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable:
    def lr(count):
        count = count.to(torch.float32)
        warm = peak_lr * count / max(warmup, 1)
        prog = torch.clamp((count - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(count < warmup, warm, cos)
    return lr


def warmup_stable_decay(peak_lr: float, warmup: int, total: int,
                        decay_frac: float = 0.2) -> Callable:
    decay_start = int(total * (1 - decay_frac))

    def lr(count):
        count = count.to(torch.float32)
        warm = peak_lr * count / max(warmup, 1)
        prog = torch.clamp((count - decay_start)
                           / max(total - decay_start, 1), 0.0, 1.0)
        dec = peak_lr * (1.0 - 0.9 * prog)
        return torch.where(count < warmup, warm,
                           torch.where(count < decay_start,
                                       torch.full_like(count, peak_lr), dec))
    return lr


def constant_lr(v: float) -> Callable:
    return lambda count: torch.full((), v, dtype=torch.float32,
                                    device=count.device)
