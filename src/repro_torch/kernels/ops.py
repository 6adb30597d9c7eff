"""The kernel wrappers the engine calls: one per kernel of the slice.

Each takes its plain version (``repro_torch.kernels.ref``) for tensors
that lie on the CPU, and only then; for anything else it calls the CUDA
kernel's launcher, which launches the kernel or raises (a tensor on
another device, a failed build, a refused launch). No path gives way from
a kernel to its plain version.

``launch_counts`` reads the launch counter each launcher keeps: a run
that resets the counters before a path and reads them after it shows
which kernels that path went through.

The three sequence kernels (flash attention, the WKV recurrence, the Mamba
scan) have backward kernels: on a CUDA tensor under autograd their
launchers run an ``autograd.Function`` whose backward launches
``<name>_bwd``; on a CPU tensor the plain forward runs, which autograd
follows.

AdamW's step (``kernels/adamw.py``) has no Pallas twin: ``AdamW.update``
calls its launcher for parameters on the card and its plain version
(``ref.adamw_ref``) for parameters on the CPU.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.knowledge_bank import topk_lowest_id
from repro_torch.kernels import ref
from repro_torch.kernels.adamw import adamw_cuda
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.ivf_stage2 import ivf_stage2_cuda, ivf_stage2_q_cuda
from repro_torch.kernels.ivf_stage2_sharded import (ivf_stage2_sharded_cuda,
                                                    ivf_stage2_sharded_q_cuda)
from repro_torch.kernels.kb_fused_lookup import kb_fused_lookup_cuda
from repro_torch.kernels.kb_fused_lookup_q import kb_fused_lookup_q_cuda
from repro_torch.kernels.kb_gather import kb_gather_cuda
from repro_torch.kernels.lazy_apply import lazy_apply_cuda
from repro_torch.kernels.mamba_scan import (mamba_scan_bwd_cuda,
                                            mamba_scan_cuda)
from repro_torch.kernels.nn_search import nn_search_cuda
from repro_torch.kernels.rwkv_wkv import rwkv_wkv_bwd_cuda, rwkv_wkv_cuda

LAUNCHERS = {
    "kb_fused_lookup": kb_fused_lookup_cuda,
    "kb_gather": kb_gather_cuda,
    "lazy_apply": lazy_apply_cuda,
    "nn_search": nn_search_cuda,
    "kb_fused_lookup_q": kb_fused_lookup_q_cuda,
    "ivf_stage2": ivf_stage2_cuda,
    "ivf_stage2_q": ivf_stage2_q_cuda,
    "flash_attention": flash_attention_cuda,
    "rwkv_wkv": rwkv_wkv_cuda,
    "ivf_stage2_sharded": ivf_stage2_sharded_cuda,
    "ivf_stage2_sharded_q": ivf_stage2_sharded_q_cuda,
    "mamba_scan": mamba_scan_cuda,
    "flash_attention_bwd": flash_attention_bwd_cuda,
    "rwkv_wkv_bwd": rwkv_wkv_bwd_cuda,
    "mamba_scan_bwd": mamba_scan_bwd_cuda,
    "adamw": adamw_cuda,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def kb_fused_lookup(table, grad_sum, grad_cnt, grad_sqnorm, ids, *,
                    lazy_lr: float, zmax: float,
                    version=None) -> torch.Tensor:
    """Lookup with pending gradients applied and, where ``version`` is
    given, the versions of the rows that had them bumped, in place;
    (B,) -> (B, D)."""
    if _on_cpu(table):
        return ref.kb_fused_lookup_ref(table, grad_sum, grad_cnt,
                                       grad_sqnorm, ids, lazy_lr=lazy_lr,
                                       zmax=zmax, version=version)
    return kb_fused_lookup_cuda(table, grad_sum, grad_cnt, grad_sqnorm,
                                ids.long(), lazy_lr=lazy_lr, zmax=zmax,
                                version=version)


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


def kb_fused_lookup_q(codes, qscale, qoffset, grad_sum, grad_cnt,
                      grad_sqnorm, ids, *, lazy_lr: float,
                      zmax: float, version=None) -> torch.Tensor:
    """int8 lookup with pending gradients applied, only those rows
    re-quantized and, where ``version`` is given, their versions bumped,
    in place; (B,) -> (B, D) dequantized rows."""
    if _on_cpu(codes):
        return ref.kb_fused_lookup_q_ref(codes, qscale, qoffset, grad_sum,
                                         grad_cnt, grad_sqnorm, ids,
                                         lazy_lr=lazy_lr, zmax=zmax,
                                         version=version)
    return kb_fused_lookup_q_cuda(codes, qscale, qoffset, grad_sum,
                                  grad_cnt, grad_sqnorm, ids.long(),
                                  lazy_lr=lazy_lr, zmax=zmax,
                                  version=version)


def ivf_stage2(packed_vecs, packed_ids, bucket_occ, queries, probes,
               k: int):
    """IVF stage 2 over fp32 rows; -> (snapshot scores, int64 ids), padded
    with (-1e30, 2**31 - 1)."""
    if _on_cpu(packed_vecs):
        return ref.ivf_stage2_ref(packed_vecs, packed_ids, bucket_occ,
                                  queries, probes, k)
    return ivf_stage2_cuda(packed_vecs, packed_ids, bucket_occ, queries,
                           probes.to(torch.int32), k)


def ivf_stage2_q(packed_codes, packed_scale, packed_offset, packed_ids,
                 bucket_occ, queries, probes, k: int):
    """IVF stage 2 over int8 rows, scored without dequantizing them."""
    if _on_cpu(packed_codes):
        return ref.ivf_stage2_q_ref(packed_codes, packed_scale,
                                    packed_offset, packed_ids, bucket_occ,
                                    queries, probes, k)
    return ivf_stage2_q_cuda(packed_codes, packed_scale, packed_offset,
                             packed_ids, bucket_occ, queries,
                             probes.to(torch.int32), k)


def ivf_stage2_sharded(packed_vecs, packed_ids, bucket_occ, queries, probes,
                       k: int):
    """Sharded IVF stage 2 over fp32 rows: probes (B, S, nprobe) local
    bucket ids -> per-(query, shard) (snapshot scores, int64 ids), each
    (B, S, k), padded with (-1e30, 2**31 - 1)."""
    if _on_cpu(packed_vecs):
        return ref.ivf_stage2_sharded_ref(packed_vecs, packed_ids,
                                          bucket_occ, queries, probes, k)
    return ivf_stage2_sharded_cuda(packed_vecs, packed_ids, bucket_occ,
                                   queries, probes.to(torch.int32), k)


def ivf_stage2_sharded_q(packed_codes, packed_scale, packed_offset,
                         packed_ids, bucket_occ, queries, probes, k: int):
    """Sharded IVF stage 2 over int8 rows, scored without dequantizing
    them."""
    if _on_cpu(packed_codes):
        return ref.ivf_stage2_sharded_q_ref(packed_codes, packed_scale,
                                            packed_offset, packed_ids,
                                            bucket_occ, queries, probes, k)
    return ivf_stage2_sharded_q_cuda(packed_codes, packed_scale,
                                     packed_offset, packed_ids, bucket_occ,
                                     queries, probes.to(torch.int32), k)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention with an online softmax in the JAX layout: q (B, S, H, d),
    k/v (B, S, KV, d) -> (B, S, H, d) in q's dtype."""
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, softcap=softcap)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap)


def rwkv_wkv(r, k, v, w, u):
    """The RWKV6 WKV recurrence from a zero state: r/k/v/w (B, S, H, d),
    u (H, d) -> (y (B, S, H, d), state after the last step (B, H, d, d)),
    both fp32."""
    if _on_cpu(r):
        return ref.rwkv_wkv_ref(r, k, v, w, u)
    return rwkv_wkv_cuda(r, k, v, w, u)


def mamba_scan(delta, bm, cm, x, A):
    """The Mamba selective scan from a zero state: delta, x (B, S, di),
    bm, cm (B, S, ds), A (di, ds) -> (y (B, S, di) before the D skip and
    the gate, state after the last step (B, di, ds)), both fp32."""
    if _on_cpu(delta):
        return ref.mamba_scan_ref(delta, bm, cm, x, A)
    return mamba_scan_cuda(delta, bm, cm, x, A)


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
