"""Mixture-of-Experts feed-forward, single device; the port of
``repro/models/moe.py``'s routing and its meshless semantics.

- ``route``: top-k softmax gating over E experts, the gates renormalised,
  and the Switch load-balance aux loss, as in JAX.
- ``moe_ref``: the JAX oracle as it is, dense over all experts (every
  expert on every token, combined with the exact top-k gates). The tests
  hold the port against it.
- ``moe_apply``: what the model runs, prefill and decode alike. With no
  mesh the JAX function runs ``moe_ref`` (``repro/models/moe.py:281-284``):
  exact, no token dropped. The port runs a dropless top-k dispatch with
  the same values up to the order of its sums: each expert computes only
  the tokens routed to it (plain products, outside any kernel), and each
  token sums its K outputs times their gates in fp32 in ascending expert
  id, the order of ``moe_ref``'s sum over experts. No float atomics, so a
  run on the card repeats bit for bit.

The capacity dispatch and the slot gather of JAX (``moe_capacity``,
``moe_slot_gather``) drop tokens past a capacity or run only under a
mesh; they come with the multi-card slice (ROADMAP Q1 item 6).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def route(x: torch.Tensor, wr: torch.Tensor, k: int):
    """x: (T, D); wr: (D, E) -> gates (T, K) fp32, experts (T, K) int64,
    plus the router aux loss (load balance, Switch style)."""
    probs = torch.softmax(x.float() @ wr.float(), dim=-1)      # (T, E)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    E = wr.shape[-1]
    me = probs.mean(0)                                         # (E,)
    ce = torch.bincount(experts.reshape(-1), minlength=E).float() \
        / experts.numel()
    return gates, experts, E * torch.sum(me * ce)


def moe_ref(x, wr, wi, wg, wo, k: int):
    """x: (T, D); wr (D, E), wi/wg (E, D, F), wo (E, F, D). Every expert
    on every token, combined with the exact top-k gates. O(T E D F):
    small configs only."""
    T, E = x.shape[0], wr.shape[-1]
    gates, experts, aux = route(x, wr, k)
    h = torch.einsum("td,edf->tef", x, wg)
    h = F.silu(h) * torch.einsum("td,edf->tef", x, wi)
    y_all = torch.einsum("tef,efd->ted", h, wo)                # (T, E, D)
    dense_gates = torch.zeros((T, E), device=x.device).scatter_add_(
        1, experts, gates)
    y = torch.einsum("ted,te->td", y_all.float(), dense_gates)
    return y.to(x.dtype), aux


def moe_dispatch(x, wr, wi, wg, wo, k: int):
    """``moe_ref``'s function, dropless: x (T, D) -> (y (T, D), aux). The
    (T, K) assignments are sorted by expert; each expert gathers its
    tokens and runs SwiGLU on them alone; the outputs go back to their
    (token, slot) places, and each token sums gate times output in fp32
    over its K slots in ascending expert id."""
    T, D = x.shape
    gates, experts, aux = route(x, wr, k)
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=wr.shape[-1]).tolist()
    out = torch.empty((T * k, D), dtype=x.dtype, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        slots = order[start:start + n]
        xe = x.index_select(0, slots // k)
        he = F.silu(xe @ wg[e]) * (xe @ wi[e])
        out.index_copy_(0, slots, he @ wo[e])
        start += n
    experts, perm = torch.sort(experts, dim=-1)               # ascending id
    gates = torch.gather(gates, 1, perm)
    ys = torch.gather(out.view(T, k, D), 1,
                      perm[..., None].expand(T, k, D)).float()
    y = gates[:, 0, None] * ys[:, 0]
    for j in range(1, k):
        y = y + gates[:, j, None] * ys[:, j]
    return y.to(x.dtype), aux


def moe_apply(x, params, *, cfg):
    """x: (B, S, D). params: wr (D, E), wi/wg (E, D, F), wo (E, F, D).
    Returns (y (B, S, D), aux), as the JAX function with no mesh."""
    B, S, D = x.shape
    y, aux = moe_dispatch(x.reshape(-1, D), params["wr"], params["wi"],
                          params["wg"], params["wo"], cfg.experts_per_token)
    return y.reshape(B, S, D), aux
