"""Knowledge Bank (paper §3.2): the reference semantics of the port.

The fp32 half of ``repro.core.knowledge_bank``: the shared ``KBState``
and the ops every backend of ``repro_torch.core.kb_engine`` must agree
with. The formulas are the JAX package's, term for term.

One difference of form: the JAX functions return new arrays, while these
**update the given state's tensors in place** and return the same state
(so ``vals, kb = kb_lookup(kb, ids)`` reads as it does in JAX). At
ogbn-mag scale the two (N, D) leaves hold 2 GB, and a copy of each per
op would double the device memory the bank needs.

Batched-call invariants (what makes server-side coalescing legal), as in
the JAX package:

- ops are deterministic under duplicate ids within one call: lookups of
  a repeated id return identical rows, version counters bump once per
  touched row per call, and ``kb_lazy_grad`` accumulates per occurrence;
- ``kb_lazy_grad`` adds duplicate ids one after another in occurrence
  order (``index_add_in_order``), as the JAX scatter-add does, and never
  with float atomics, so its bits do not change from run to run on CUDA
  (``index_add_`` there adds in whatever order the atomics land);
- ``kb_lazy_grad`` takes an optional 0/1 ``mask`` so a batch can be padded
  to a bucket size without the padding contributing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.env import resolve_device

_EMA_DECAY = 0.9


class KBState(NamedTuple):
    table: torch.Tensor         # (N, D) f32
    version: torch.Tensor       # (N,) int32: bumped on every write
    grad_sum: torch.Tensor      # (N, D) f32: cached gradient sum
    grad_cnt: torch.Tensor      # (N,) f32: number of cached gradients
    grad_sqnorm: torch.Tensor   # (N,) f32: sum of per-gradient sq norms
    norm_ema: torch.Tensor      # (N,) f32: EMA of contribution sq norms
    step: torch.Tensor          # () int32: bank clock


def kb_create(num_entries: int, dim: int, *, device="cuda",
              generator: Optional[torch.Generator] = None) -> KBState:
    """A bank of zeros, or of N(0, 0.01²) rows drawn from ``generator``
    (which must live on ``device``)."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    if generator is not None:
        table = torch.randn((num_entries, dim), generator=generator,
                            **f32) * 0.01
    else:
        table = torch.zeros((num_entries, dim), **f32)
    return KBState(
        table=table,
        version=torch.zeros((num_entries,), dtype=torch.int32,
                            device=device),
        grad_sum=torch.zeros((num_entries, dim), **f32),
        grad_cnt=torch.zeros((num_entries,), **f32),
        grad_sqnorm=torch.zeros((num_entries,), **f32),
        norm_ema=torch.zeros((num_entries,), **f32),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# lazy-update math
# ---------------------------------------------------------------------------

def pending_delta(grad_sum, grad_cnt, grad_sqnorm, *, lazy_lr: float,
                  zmax: float):
    """The update each row would receive if its cache were applied now.

    Average of cached gradients, norm-clipped at zmax * rms contribution
    norm (outlier rejection). Rows with an empty cache get zero."""
    cnt = torch.clamp(grad_cnt, min=1.0)[..., None]
    avg = grad_sum / cnt
    avg_norm = torch.sqrt(torch.sum(avg * avg, dim=-1, keepdim=True))
    rms = torch.sqrt(grad_sqnorm / torch.clamp(grad_cnt, min=1.0))[..., None]
    cap = zmax * torch.clamp(rms, min=1e-12)
    scale = torch.clamp(cap / torch.clamp(avg_norm, min=1e-12), max=1.0)
    delta = -lazy_lr * avg * scale
    return torch.where((grad_cnt > 0)[..., None], delta,
                       torch.zeros_like(delta))


# ---------------------------------------------------------------------------
# ops (in place; each returns the state it was given)
# ---------------------------------------------------------------------------

def kb_lookup(kb: KBState, ids: torch.Tensor, *, lazy_lr: float = 0.1,
              zmax: float = 3.0, apply_pending: bool = True
              ) -> Tuple[torch.Tensor, KBState]:
    """Fetch rows ``ids`` (any shape). If ``apply_pending``, first applies
    the lazily-cached gradient average to those rows and clears their
    caches (paper: "caching the results of gradient update until the next
    lookup request arrives")."""
    flat = ids.reshape(-1).long()
    if not apply_pending:
        return kb.table[flat].reshape(*ids.shape, -1), kb
    cnt = kb.grad_cnt[flat]
    new_rows = kb.table[flat] + pending_delta(
        kb.grad_sum[flat], cnt, kb.grad_sqnorm[flat], lazy_lr=lazy_lr,
        zmax=zmax)
    # gather first, scatter after: duplicate ids write identical values,
    # and the version moves +1 per touched row per call, never per
    # occurrence
    kb.version[flat] = kb.version[flat] + (cnt > 0).to(torch.int32)
    kb.table[flat] = new_rows
    kb.grad_sum[flat] = 0.0
    kb.grad_cnt[flat] = 0.0
    kb.grad_sqnorm[flat] = 0.0
    return new_rows.reshape(*ids.shape, -1), kb


def kb_update(kb: KBState, ids: torch.Tensor, values: torch.Tensor
              ) -> KBState:
    """Direct write (knowledge-maker push). ids: (...,); values: (..., D).
    Cached gradients for overwritten rows are discarded (they were
    computed against stale values). Duplicate ids must carry equal values
    (the engine dedupes last-writer-wins before it gets here)."""
    flat = ids.reshape(-1).long()
    kb.version[flat] = kb.version[flat] + 1
    kb.table[flat] = values.reshape(flat.shape[0], -1).to(kb.table.dtype)
    kb.grad_sum[flat] = 0.0
    kb.grad_cnt[flat] = 0.0
    kb.grad_sqnorm[flat] = 0.0
    kb.step.add_(1)
    return kb


def lazy_grad_contribution(g, sq, ema, *, zmax: float):
    """Entry-side outlier clip of one gradient batch against the persistent
    norm EMA (shared by every backend). Returns clipped (g', sq')."""
    if zmax and zmax > 0:
        cap = zmax * torch.sqrt(torch.clamp(ema, min=1e-30))
        nrm = torch.sqrt(torch.clamp(sq, min=1e-30))
        scale = torch.where(ema > 0, torch.clamp(cap / nrm, max=1.0),
                            torch.ones_like(ema))
        g = g * scale[:, None]
        sq = sq * scale * scale
    return g, sq


def ema_step(ema, sq_sum, cnt):
    """One norm-EMA step per row per call, against the mean clipped squared
    norm of the call's contributions (``sq_sum / cnt``). Rows with no
    contribution keep their EMA. One step per CALL (not per occurrence)
    keeps the update deterministic and bounded under duplicate ids."""
    mean_sq = sq_sum / torch.clamp(cnt, min=1.0)
    return torch.where(cnt > 0,
                       torch.where(ema > 0,
                                   _EMA_DECAY * ema
                                   + (1 - _EMA_DECAY) * mean_sq,
                                   mean_sq),
                       ema)


def occurrence_rounds(ids: torch.Tensor):
    """Positions of ``ids`` split into rounds: round r holds the r-th
    occurrence of every id, so no id repeats within a round."""
    order = torch.argsort(ids, stable=True)
    _, counts = torch.unique_consecutive(ids[order], return_counts=True)
    starts = torch.repeat_interleave(torch.cumsum(counts, 0) - counts,
                                     counts)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(ids.numel(), device=ids.device) - starts
    return [torch.nonzero(rank == r).squeeze(1)
            for r in range(int(counts.max()) if counts.numel() else 0)]


def index_add_in_order(target: torch.Tensor, ids: torch.Tensor,
                       vals: torch.Tensor, rounds) -> None:
    """``target[ids[i]] += vals[i]`` for every i in order, as the JAX
    scatter-add does, without float atomics: within one of
    ``occurrence_rounds(ids)`` the ids are distinct, so a gather, an add
    and a scatter are exact, and the duplicates of an id are added one
    after another in the order they occur. The result has the same bits on
    every run (``index_add_`` on CUDA adds in whatever order its atomics
    land)."""
    for pos in rounds:
        rows = ids[pos]
        target[rows] = target[rows] + vals[pos]


def kb_lazy_grad(kb: KBState, ids: torch.Tensor, grads: torch.Tensor,
                 *, zmax: float = 0.0,
                 mask: Optional[torch.Tensor] = None) -> KBState:
    """Cache gradients w.r.t. looked-up rows. ids: (...,); grads (..., D).
    Duplicate ids accumulate (each counts as one cached gradient); the
    norm EMA advances one step per touched row per call (``ema_step``).

    Entry-side outlier detection (``zmax > 0``): each incoming gradient's
    norm is clipped at ``zmax * sqrt(norm_ema)``. ``mask`` (flat 0/1 per
    entry): entries with mask 0 contribute nothing."""
    flat = ids.reshape(-1).long()
    g = grads.reshape(flat.shape[0], -1).to(torch.float32)
    sq = torch.sum(g * g, dim=-1)
    g, sq = lazy_grad_contribution(g, sq, kb.norm_ema[flat], zmax=zmax)
    if mask is not None:
        # a masked entry adds +-0.0, which changes no sum: leave it out
        # rather than spend a round of scatters on the bucket padding
        w = mask.reshape(-1).to(sq)
        keep = torch.nonzero(w != 0).squeeze(1)
        flat, g, sq, w = flat[keep], g[keep] * w[keep, None], \
            sq[keep] * w[keep], w[keep]
    else:
        w = torch.ones_like(sq)
    if flat.numel() == 0:
        return kb
    rounds = occurrence_rounds(flat)
    index_add_in_order(kb.grad_sum, flat, g, rounds)
    index_add_in_order(kb.grad_cnt, flat, w, rounds)
    index_add_in_order(kb.grad_sqnorm, flat, sq, rounds)
    # the call's per-row totals, summed from zero as the JAX op sums them
    uniq, inv = torch.unique(flat, return_inverse=True)
    sq_sum = torch.zeros(uniq.shape, dtype=sq.dtype, device=sq.device)
    cnt_in = torch.zeros_like(sq_sum)
    index_add_in_order(sq_sum, inv, sq, rounds)
    index_add_in_order(cnt_in, inv, w, rounds)
    kb.norm_ema[uniq] = ema_step(kb.norm_ema[uniq], sq_sum, cnt_in)
    return kb


def kb_flush(kb: KBState, *, lazy_lr: float = 0.1, zmax: float = 3.0
             ) -> KBState:
    """Expiration path: apply every pending cached gradient now."""
    kb.table.add_(pending_delta(kb.grad_sum, kb.grad_cnt, kb.grad_sqnorm,
                                lazy_lr=lazy_lr, zmax=zmax))
    kb.version.add_((kb.grad_cnt > 0).to(torch.int32))
    kb.grad_sum.zero_()
    kb.grad_cnt.zero_()
    kb.grad_sqnorm.zero_()
    kb.step.add_(1)
    return kb


def topk_lowest_id(scores: torch.Tensor, k: int):
    """Top-k along the last axis, ties to the lowest index (``lax.top_k``'s
    order): a stable descending sort keeps equal scores in index order."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def kb_nn_search(kb: KBState, queries: torch.Tensor, k: int,
                 *, exclude_ids: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k maximum-inner-product search over the whole bank.

    queries: (B, D) -> (scores (B, k), ids (B, k)). ``exclude_ids`` (B, E)
    bans rows per query; -1 entries are inert."""
    scores = queries.to(torch.float32) @ kb.table.T
    if exclude_ids is not None:
        excl = exclude_ids.long()
        rows = torch.arange(excl.shape[0], device=excl.device)[:, None]
        keep = excl >= 0
        scores[rows.expand_as(excl)[keep], excl[keep]] = -torch.inf
    return topk_lowest_id(scores, k)
