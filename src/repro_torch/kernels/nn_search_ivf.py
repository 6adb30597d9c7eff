"""Two-stage IVF nn_search: the host half of ``repro.kernels.nn_search_ivf``.

Stage 1 scores the queries against the ``C`` k-means centroids of an
index from ``repro_torch.core.ann_index`` and keeps the ``nprobe`` best
buckets per query (``ivf_probes``, a plain product and top-k). Stage 2
scores each query only against the occupied rows of its probed buckets
in the packed (C·cap, D) layout and keeps a running top-k: on the card
that is the CUDA kernel ``csrc/ivf_stage2.cu`` (int8 twin:
``csrc/ivf_stage2_q.cu``), reached through ``repro_torch.kernels.ops``;
its plain version (``repro_torch.kernels.ref.ivf_stage2_ref``) walks the
Pallas kernel's own schedule, ``ivf_chunk_plan``. The k winners are then
re-scored against the LIVE table (``_rerank_live``), so the scores
returned are exact for the rows found even when the index has gone
stale: staleness costs recall, never score accuracy.

``ivf_search_ref`` and ``ivf_search_quantized_ref`` are the plain
two-stage searches of the JAX package's oracles (``ivf_search_jnp``,
``ivf_search_quantized_jnp``), term for term: the ``DenseBackend`` IVF
path.
"""
from __future__ import annotations

import torch

from repro_torch.core.knowledge_bank import topk_lowest_id

NEG = -1e30                 # score of a padding slot (the Pallas NEG)
IMAX = 2 ** 31 - 1          # id of an empty top-k entry (the Pallas _IMAX)
STAGE2_BLOCK = 256          # the Pallas stage-2 kernels' default block


def _chunk_rows(bucket_cap: int, block: int) -> int:
    """Stage-2 chunk size: buckets are pow2 (< 128) or multiples of 128;
    the largest 128-multiple divisor of the capacity that fits
    ``block``."""
    if bucket_cap < 128:
        return bucket_cap
    m = bucket_cap // 128
    return 128 * max((d for d in range(1, m + 1)
                      if m % d == 0 and 128 * d <= block), default=1)


def ivf_chunk_plan(probes, bucket_occ, cpb: int, lb: int):
    """Per-query chunk schedule of the stage-2 grid.

    probes: (B, nprobe) bucket ids; bucket_occ: (C,) rows packed into each
    bucket (None: every bucket full). Returns ``(sel (B, nprobe*cpb)
    int32, nvalid (B,) int32)``: each query's occupied chunk indices
    compacted to the front, the tail repeating the last valid one, and how
    many entries to merge. Dropped chunks hold only -1-id padding."""
    B, nprobe = probes.shape
    n_chunks = nprobe * cpb
    dev = probes.device
    arange = torch.arange(cpb, dtype=torch.int32, device=dev)
    cand = (probes.to(torch.int32)[:, :, None] * cpb
            + arange[None, None, :]).reshape(B, n_chunks)
    if bucket_occ is None:
        return cand, torch.full((B,), n_chunks, dtype=torch.int32,
                                device=dev)
    occ = bucket_occ.to(torch.int32)[probes.long()]          # (B, nprobe)
    nch = torch.clamp(torch.div(occ + lb - 1, lb, rounding_mode="floor"),
                      max=cpb)
    valid = (arange[None, None, :] < nch[:, :, None]).reshape(B, n_chunks)
    order = torch.argsort(torch.where(valid, 0, 1), dim=1, stable=True)
    sel = torch.gather(cand, 1, order)
    nvalid = valid.sum(dim=1).to(torch.int32)
    last = torch.gather(sel, 1, torch.clamp(nvalid - 1, min=0)[:, None]
                        .long())
    j = torch.arange(n_chunks, device=dev)[None, :]
    sel = torch.where(j < nvalid[:, None], sel, last)
    return sel.to(torch.int32), nvalid


def ivf_probes(queries, centroids, nprobe: int) -> torch.Tensor:
    """Top-``nprobe`` buckets per query by centroid inner product, ties to
    the lowest bucket. (B, D) x (C, D) -> (B, min(nprobe, C)) int32."""
    nprobe = min(nprobe, centroids.shape[0])
    scores = queries.to(torch.float32) @ centroids.to(torch.float32).T
    return topk_lowest_id(scores, nprobe)[1].to(torch.int32)


def _rerank(rows, queries, ids, valid):
    s = torch.einsum("bd,bkd->bk", queries.to(torch.float32), rows)
    s = torch.where(valid, s, -torch.inf)
    s, order = torch.sort(s, dim=-1, descending=True, stable=True)
    return s, torch.gather(torch.where(valid, ids, -1), 1, order)


def _rerank_live(table, queries, ids):
    """Re-score candidate ids against the live table and sort descending.
    Invalid candidates (padding) come back as (-inf, -1)."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(valid, ids, 0)].to(torch.float32)
    return _rerank(rows, queries, ids, valid)


def _rerank_live_q(codes, qscale, qoffset, queries, ids):
    """``_rerank_live`` when the live bank is int8-coded: the winners'
    codes are dequantized, so the scores are exact with respect to the
    quantized live values."""
    ids = ids.long()
    valid = (ids >= 0) & (ids < codes.shape[0])
    safe = torch.where(valid, ids, 0)
    rows = (codes[safe].to(torch.float32) * qscale[safe][..., None]
            + qoffset[safe][..., None])
    return _rerank(rows, queries, ids, valid)


def _shortlist(scores, cand_i, k: int):
    """``ivf_search_jnp``'s stage-2 tail: padding scores NEG, ``L < k``
    padded with (NEG, -1), top-k by candidate position on ties."""
    scores = torch.where(cand_i >= 0, scores, NEG)
    L = cand_i.shape[1]
    if L < k:
        pad = k - L
        scores = torch.nn.functional.pad(scores, (0, pad), value=NEG)
        cand_i = torch.nn.functional.pad(cand_i, (0, pad), value=-1)
    _, sel = topk_lowest_id(scores, k)
    return torch.gather(cand_i, 1, sel)


def ivf_search_ref(table, centroids, packed_vecs, packed_ids, queries,
                   k: int, nprobe: int):
    """The plain two-stage search (``ivf_search_jnp``): (B, D) queries ->
    live (scores (B, k), ids (B, k)); padding entries are (-inf, -1)."""
    C = centroids.shape[0]
    cap = packed_vecs.shape[0] // C
    B, D = queries.shape
    probes = ivf_probes(queries, centroids, nprobe).long()
    cand_v = packed_vecs.reshape(C, cap, D)[probes].reshape(B, -1, D)
    cand_i = packed_ids.reshape(C, cap)[probes].reshape(B, -1).long()
    s = torch.einsum("bd,bld->bl", queries.to(torch.float32),
                     cand_v.to(torch.float32))
    return _rerank_live(table, queries, _shortlist(s, cand_i, k))


def ivf_search_quantized_ref(table_codes, qscale, qoffset, centroids,
                             packed_codes, packed_scale, packed_offset,
                             packed_ids, queries, k: int, nprobe: int):
    """The plain fully-quantized two-stage search
    (``ivf_search_quantized_jnp``): int8 snapshot scored by the
    decomposition, live re-rank against the int8 bank."""
    C = centroids.shape[0]
    cap = packed_codes.shape[0] // C
    B, D = queries.shape
    qf = queries.to(torch.float32)
    probes = ivf_probes(queries, centroids, nprobe).long()
    cand_v = packed_codes.reshape(C, cap, D)[probes].reshape(B, -1, D)
    cand_i = packed_ids.reshape(C, cap)[probes].reshape(B, -1).long()
    cand_s = packed_scale.reshape(C, cap)[probes].reshape(B, -1)
    cand_o = packed_offset.reshape(C, cap)[probes].reshape(B, -1)
    s = torch.einsum("bd,bld->bl", qf, cand_v.to(torch.float32))
    s = s * cand_s + torch.sum(qf, -1, keepdim=True) * cand_o
    return _rerank_live_q(table_codes, qscale, qoffset, queries,
                          _shortlist(s, cand_i, k))
