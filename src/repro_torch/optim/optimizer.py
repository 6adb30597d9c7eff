"""AdamW with optional low-precision moments, global-norm clipping, and
warmup-cosine / warmup-stable-decay schedules; the port of
``repro/optim/optimizer.py``.

The update is the JAX function's, operation for operation: every gradient
in fp32, clipped by one global scale, moments in fp32 and stored in
``moments_dtype``, bias correction and ``lr(count)`` at the incremented
count, the new parameter rounded back to its dtype (round to nearest
even, as ``astype`` rounds). Two differences of form:

- **Chunk by chunk, in place.** JAX casts the whole gradient tree to
  fp32 before it starts (at the full width of yi-6b a 13 GB copy). Here
  each leaf is widened, used and dropped in turn under
  ``torch.no_grad()``, ``CHUNK`` entries at a time (a layer-stacked leaf
  of yi-6b holds up to 721 M entries, 2.9 GB in fp32), and the
  parameters and moments are overwritten in place; ``update`` returns the
  objects it was given. So a step's fp32 temporaries are a few of one
  chunk's. Each entry's arithmetic is the same whatever the chunking.
- ``global_norm`` adds the leaves' fp32 sums of squares in JAX's leaf
  order (each dict's keys sorted); a leaf's sum is its chunks' sums
  added in order.

``count`` is a () int32 tensor on the parameters' device, and a schedule
maps it to a () fp32 tensor there, so a step never waits on the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_items, tree_leaves, tree_map


# entries of a leaf widened to fp32 at a time (64 MB a temporary)
CHUNK = 1 << 24


def _chunks(t: torch.Tensor):
    """Contiguous views of ``CHUNK`` entries (the last one shorter) that
    write through to ``t``."""
    return t.view(-1).split(CHUNK)


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
        ``params`` and ``state`` updated in place."""
        gn = global_norm(grads)
        scale = None
        if self.clip_norm and self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-12),
                                max=1.0)
        state.count.add_(1)
        count = state.count
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        lr = self.lr(count)
        for (_, g), (_, m), (_, v), (_, p) in zip(
                tree_items(grads), tree_items(state.mu),
                tree_items(state.nu), tree_items(params)):
            for gc, mc, vc, pc in zip(_chunks(g), _chunks(m), _chunks(v),
                                      _chunks(p)):
                g32 = gc.float()
                if scale is not None:
                    g32 = g32 * scale
                m32 = mc.float() * b1 + g32 * (1 - b1)
                v32 = vc.float() * b2 + torch.square(g32) * (1 - b2)
                del g32
                step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
                if self.weight_decay:
                    step = step + self.weight_decay * pc.float()
                pc.copy_(pc.float() - lr * step)
                mc.copy_(m32)
                vc.copy_(v32)
        return params, state, gn


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX's order) of each leaf's fp32 sum
    of squares."""
    return torch.sqrt(sum(
        sum(torch.sum(torch.square(c.float())) for c in _chunks(leaf))
        for leaf in tree_leaves(tree)))


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
