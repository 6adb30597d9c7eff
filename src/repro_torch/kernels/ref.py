"""Plain PyTorch versions of the four kernels.

Each has its kernel's exact contract (the same in-place writes, the same
treatment of ids outside [0, N), the same formula), so a kernel wrapper
can run it for a tensor that lies on the CPU, the CPU tests can hold it
against the Pallas kernel it replaces, and ``chip_smoke.py`` can hold the
CUDA kernel against it on the card. Nothing on the card's serving path
calls these.
"""
from __future__ import annotations

import torch

from repro_torch.core.knowledge_bank import pending_delta, topk_lowest_id


def _valid(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    return (ids >= 0) & (ids < n_rows)


def kb_fused_lookup_ref(table, grad_sum, grad_cnt, grad_sqnorm, ids, *,
                        lazy_lr: float, zmax: float) -> torch.Tensor:
    """``kb_lookup(apply_pending=True)`` without the version bump, in
    place: each requested row gets its clipped pending delta and its three
    caches zeroed, and comes back as a (B, D) row. Ids outside [0, N)
    (the Pallas kernel's -1 padding) match no row: they read zeros and
    change nothing. Duplicates all read the same updated row."""
    ids = ids.long()
    ok = _valid(ids, table.shape[0])
    rows = ids[ok]
    new = table[rows] + pending_delta(grad_sum[rows], grad_cnt[rows],
                                      grad_sqnorm[rows], lazy_lr=lazy_lr,
                                      zmax=zmax)
    table[rows] = new
    grad_sum[rows] = 0.0
    grad_cnt[rows] = 0.0
    grad_sqnorm[rows] = 0.0
    vals = torch.zeros((ids.shape[0], table.shape[1]), dtype=torch.float32,
                       device=table.device)
    vals[ok] = new
    return vals


def kb_gather_ref(table, ids) -> torch.Tensor:
    """Rows by id, (B,) -> (B, D); ids outside [0, N) give zero rows."""
    ids = ids.long()
    ok = _valid(ids, table.shape[0])
    out = torch.zeros((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    out[ok] = table[ids[ok]]
    return out


def lazy_apply_ref(table, grad_sum, grad_cnt, grad_sqnorm, *,
                   lazy_lr: float, zmax: float) -> None:
    """``kb_flush`` on the four leaves, in place, with the Pallas kernel's
    own norm, ``sqrt(max(sum(avg²), 1e-24))`` (``lazy_apply.py:33-36``);
    ``pending_delta``'s ``max(|avg|, 1e-12)`` differs only below it."""
    cnt = torch.clamp(grad_cnt, min=1.0)[:, None]
    avg = grad_sum / cnt
    avg_norm = torch.sqrt(torch.clamp(torch.sum(avg * avg, -1, keepdim=True),
                                      min=1e-24))
    rms = torch.sqrt(grad_sqnorm[:, None] / cnt)
    cap = zmax * torch.clamp(rms, min=1e-12)
    scale = torch.clamp(cap / avg_norm, max=1.0)
    delta = -lazy_lr * avg * scale
    pending = grad_cnt > 0
    table[pending] = table[pending] + delta[pending]
    grad_sum.zero_()
    grad_cnt.zero_()
    grad_sqnorm.zero_()


def nn_search_ref(queries, bank, k: int):
    """Exact top-k MIPS, (B, D) x (N, D) -> (scores (B, k), int64 ids
    (B, k)), ties to the lowest id (the Pallas kernel's ``_merge_topk``
    order)."""
    return topk_lowest_id(queries.to(torch.float32) @ bank.T, k)
