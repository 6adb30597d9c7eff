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

Sharded indexes (``repro_torch.core.ann_index.ShardedIVFIndex``): stage 1
probes each shard's own centroids (``sharded_probes``), stage 2 keeps a
top-k per (query, shard), and the (B, S, k) shortlists meet in a
shard-major merge and the live re-rank. ``ivf_search_sharded`` runs stage
2 on the card in one launch for every shard (``csrc/ivf_stage2_sharded.cu``,
the port of ``ivf_search_sharded_pallas``); ``ivf_search_sharded_ref`` is
the meshless oracle ``ivf_search_sharded_jnp``, term for term.
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


# ---------------------------------------------------------------------------
# sharded indexes: per-shard probes and shortlists, shard-major merge
# ---------------------------------------------------------------------------

def sharded_probes(queries, centroids, n_shards: int, nprobe: int):
    """Each shard's top-``nprobe`` buckets among its own C centroids, ties
    to the lowest bucket: (B, D) x (S*C, D) -> (B, S, min(nprobe, C))
    int32 LOCAL bucket ids."""
    B = queries.shape[0]
    C = centroids.shape[0] // n_shards
    scores = (queries.to(torch.float32) @ centroids.to(torch.float32).T
              ).reshape(B, n_shards, C)
    return topk_lowest_id(scores, min(nprobe, C))[1].to(
        torch.int32).contiguous()


def global_probes(probes, n_buckets: int):
    """(B, S, nprobe) local bucket ids of S shards with ``n_buckets // S``
    buckets each -> (B, S * nprobe) global ids ``s * nlist + b``,
    shard-major, as ``ivf_stage2_sharded_pallas`` makes them
    (``nn_search_ivf.py:409-411``); a local id outside [0, nlist) becomes
    -1, which names no bucket."""
    B, S, nprobe = probes.shape
    nlist = n_buckets // S
    off = nlist * torch.arange(S, dtype=probes.dtype, device=probes.device)
    ok = (probes >= 0) & (probes < nlist)
    return torch.where(ok, probes + off[:, None], -1).reshape(B, S * nprobe)


def _merge_shards(ls, li, k: int):
    """(B, S, kk) per-shard shortlists -> the k best ids of their
    shard-major concatenation, ties to the earlier position (the JAX
    all-gather order and ``lax.top_k``)."""
    B = ls.shape[0]
    _, sel = topk_lowest_id(ls.reshape(B, -1), k)
    return torch.gather(li.reshape(B, -1), 1, sel)


def ivf_search_sharded(table, centroids, packed_vecs, packed_ids, queries,
                       k: int, nprobe: int, *, n_shards: int, bucket_occ,
                       packed_scale=None, packed_offset=None):
    """``ivf_search_sharded_pallas``: per-shard stage 1, ONE stage-2 call
    for every shard's shortlist (the kernel on the card, its plain version
    for CPU tensors), the shard-major merge, and the re-rank against the
    live fp32 ``table``. With ``packed_scale`` / ``packed_offset``,
    ``packed_vecs`` holds int8 codes scored ``s (q.c) + o sum(q)``. ->
    (scores (B, k), ids (B, k)), padding (-inf, -1)."""
    # imported here: ops imports this module's plain helpers through ref
    from repro_torch.kernels import ops
    probes = sharded_probes(queries, centroids, n_shards, nprobe)
    q = queries.to(torch.float32)
    if packed_scale is None:
        ls, li = ops.ivf_stage2_sharded(packed_vecs, packed_ids, bucket_occ,
                                        q, probes, k)
    else:
        ls, li = ops.ivf_stage2_sharded_q(packed_vecs, packed_scale,
                                          packed_offset, packed_ids,
                                          bucket_occ, q, probes, k)
    # IMAX fill ids score NEG and fall to _rerank_live's invalid branch
    return _rerank_live(table, queries, _merge_shards(ls, li, k))


def ivf_search_sharded_ref(table, centroids, packed_vecs, packed_ids,
                           queries, k: int, nprobe: int, *, n_shards: int,
                           packed_scale=None, packed_offset=None):
    """The meshless oracle of the sharded search
    (``ivf_search_sharded_jnp``): gather each shard's probed buckets,
    score them (int8 codes by the decomposition when ``packed_scale`` /
    ``packed_offset`` are given), each shard's top-k by candidate position
    padded with (NEG, -1), the shard-major merge and the live re-rank."""
    S = n_shards
    SC, D = centroids.shape
    C = SC // S
    cap = packed_vecs.shape[0] // SC
    B = queries.shape[0]
    qf = queries.to(torch.float32)
    probes = sharded_probes(queries, centroids, S, nprobe).long()
    nprobe = probes.shape[2]
    sidx = torch.arange(S, device=queries.device)[None, :, None]
    cv = packed_vecs.reshape(S, C, cap, D)[sidx, probes]
    ci = packed_ids.reshape(S, C, cap)[sidx, probes].reshape(B, S, -1).long()
    s = torch.einsum("bd,bsld->bsl", qf,
                     cv.reshape(B, S, nprobe * cap, D).to(torch.float32))
    if packed_scale is not None:
        cs = packed_scale.reshape(S, C, cap)[sidx, probes].reshape(B, S, -1)
        co = packed_offset.reshape(S, C, cap)[sidx, probes].reshape(B, S, -1)
        s = s * cs + torch.sum(qf, -1)[:, None, None] * co
    s = torch.where(ci >= 0, s, NEG)
    kk = min(k, nprobe * cap)
    ls, sel = topk_lowest_id(s, kk)
    li = torch.gather(ci, 2, sel)
    if kk < k:                  # tiny sub-index: pad per shard
        ls = torch.nn.functional.pad(ls, (0, k - kk), value=NEG)
        li = torch.nn.functional.pad(li, (0, k - kk), value=-1)
    return _rerank_live(table, queries, _merge_shards(ls, li, k))
