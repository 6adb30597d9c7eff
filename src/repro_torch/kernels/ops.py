"""The kernel wrappers the engine calls: one per kernel of the slice.

Each takes its plain version (``repro_torch.kernels.ref``) for tensors
that lie on the CPU, and only then; for anything else it calls the CUDA
kernel's launcher, which launches the kernel or raises (a tensor on
another device, a failed build, a refused launch). No path gives way from
a kernel to its plain version.

``launch_counts`` reads the launch counter each launcher keeps: a run
that resets the counters before a path and reads them after it shows
which kernels that path went through.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.knowledge_bank import topk_lowest_id
from repro_torch.kernels import ref
from repro_torch.kernels.kb_fused_lookup import kb_fused_lookup_cuda
from repro_torch.kernels.kb_gather import kb_gather_cuda
from repro_torch.kernels.lazy_apply import lazy_apply_cuda
from repro_torch.kernels.nn_search import nn_search_cuda

LAUNCHERS = {
    "kb_fused_lookup": kb_fused_lookup_cuda,
    "kb_gather": kb_gather_cuda,
    "lazy_apply": lazy_apply_cuda,
    "nn_search": nn_search_cuda,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def kb_fused_lookup(table, grad_sum, grad_cnt, grad_sqnorm, ids, *,
                    lazy_lr: float, zmax: float) -> torch.Tensor:
    """Lookup with pending gradients applied, in place; (B,) -> (B, D)."""
    if _on_cpu(table):
        return ref.kb_fused_lookup_ref(table, grad_sum, grad_cnt,
                                       grad_sqnorm, ids, lazy_lr=lazy_lr,
                                       zmax=zmax)
    return kb_fused_lookup_cuda(table, grad_sum, grad_cnt, grad_sqnorm,
                                ids.long(), lazy_lr=lazy_lr, zmax=zmax)


def kb_gather(table, ids) -> torch.Tensor:
    """Rows by id, zeros for ids outside [0, N); (B,) -> (B, D)."""
    if _on_cpu(table):
        return ref.kb_gather_ref(table, ids)
    return kb_gather_cuda(table, ids.long())


def lazy_apply(table, grad_sum, grad_cnt, grad_sqnorm, *, lazy_lr: float,
               zmax: float) -> None:
    """Apply every pending gradient and zero all caches, in place."""
    if _on_cpu(table):
        ref.lazy_apply_ref(table, grad_sum, grad_cnt, grad_sqnorm,
                           lazy_lr=lazy_lr, zmax=zmax)
    else:
        lazy_apply_cuda(table, grad_sum, grad_cnt, grad_sqnorm,
                        lazy_lr=lazy_lr, zmax=zmax)


def nn_search(queries, bank, k: int):
    """Exact top-k MIPS, ties to the lowest id; -> (scores, int64 ids)."""
    if _on_cpu(bank):
        return ref.nn_search_ref(queries, bank, k)
    return nn_search_cuda(queries, bank, k)


def overfetch_exclude_topk(search, n_rows: int, k: int, exclude_ids):
    """Exclusion on top of any top-k search (``repro/kernels/nn_search.py:31``):
    over-fetch ``k + E`` candidates via ``search(kk) -> (scores, ids)``,
    mask the excluded ids (-1 entries in ``exclude_ids`` (B, E) are inert),
    and take the top k again. At most E of the k + E candidates can be
    excluded per query, so whenever the pool holds k survivors the result
    equals masking before the top-k."""
    E = exclude_ids.shape[1]
    s, i = search(min(k + E, n_rows))
    excl = exclude_ids.to(i.device).long()
    banned = ((i[:, :, None] == excl[:, None, :])
              & (excl >= 0)[:, None, :]).any(-1)
    s2, sel = topk_lowest_id(s.masked_fill(banned, -torch.inf), k)
    return s2, torch.gather(i, 1, sel)
