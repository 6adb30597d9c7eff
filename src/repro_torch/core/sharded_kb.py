"""Sharded Knowledge Bank on one device: the searches of
``repro.core.sharded_kb`` over S logical shards.

The JAX module runs each op under ``shard_map`` over a mesh, one shard per
device. Here the S owner ranges of ``OwnerShard`` (shard s owns the rows
``[s*N/S, (s+1)*N/S)``, the JAX module's rule) lie in one table on one
device, and the ops that the ownership changes are the searches:

- ``sharded_kb_nn_search``: each shard's exact top-k over its own row
  range (on the card, the exact MIPS kernel over the shard's row view, S
  launches), then the shard-major merge and a re-top-k, as the JAX op's
  all-gather and ``lax.top_k`` do;
- ``sharded_kb_nn_search_ivf``: each shard probes its own sub-index of a
  ``ShardedIVFIndex`` and keeps a top-k shortlist (on the card, every
  shard in one launch of the sharded stage-2 kernel), the shortlists meet
  in the same merge, and the winners are re-ranked against the live
  table. An int8 sub-index (``QuantizedShardedIVFIndex``) shortlists 4k
  per shard, as the JAX op does, so the live fp32 re-rank can recover
  near-ties that the int8 scores mis-ordered.

The row ops need nothing of this module on one device: each id has one
owner, so the JAX lookup's psum adds zeros to one value and its
owner-masked scatters drop nothing that belongs to the bank; the port's
``ShardedBackend`` runs ``CudaBackend``'s row ops as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.knowledge_bank import topk_lowest_id
from repro_torch.kernels import ops
from repro_torch.kernels.nn_search_ivf import ivf_search_sharded


class OwnerShard:
    """The owner ranges of a bank of ``n_rows`` over ``n_shards``: shard
    s owns the contiguous rows ``[s*n_local, (s+1)*n_local)``."""

    def __init__(self, n_rows: int, n_shards: int):
        if n_shards < 1 or n_rows % n_shards:
            raise ValueError(f"bank rows {n_rows} not divisible by "
                             f"{n_shards} shards")
        self.n_shards = n_shards
        self.n_local = n_rows // n_shards

    def rows(self, s: int) -> slice:
        return slice(s * self.n_local, (s + 1) * self.n_local)

    def count(self, ids: np.ndarray) -> np.ndarray:
        """Ids per owning shard, (n_shards,) int64; ids lie in the bank."""
        return np.bincount(np.asarray(ids) // self.n_local,
                           minlength=self.n_shards).astype(np.int64)


def sharded_kb_nn_search(table, queries, k: int, n_shards: int):
    """(B, D) queries -> (scores (B, k), ids (B, k)): each shard's top-k
    over its own rows, ids offset to the bank's, merged shard-major. Ties
    go to the lowest id, as in the dense search."""
    own = OwnerShard(table.shape[0], n_shards)
    kk = min(k, own.n_local)
    ls, li = zip(*(ops.nn_search(queries, table[own.rows(s)], kk)
                   for s in range(n_shards)))
    li = torch.cat([i + s * own.n_local for s, i in enumerate(li)], 1)
    gs, sel = topk_lowest_id(torch.cat(ls, 1), k)
    return gs, torch.gather(li, 1, sel)


def sharded_kb_nn_search_ivf(table, index, queries, k: int, nprobe: int):
    """Top-k through a ``ShardedIVFIndex`` or ``QuantizedShardedIVFIndex``
    of ``table`` (the live fp32 bank): (scores (B, k), ids (B, k)), exact
    live scores for the ids found, padding (-inf, -1)."""
    S = getattr(index, "n_shards", 1)
    if hasattr(index, "packed_codes"):
        rows, kq = index.packed_codes, 4 * k
        extra = dict(packed_scale=index.packed_scale,
                     packed_offset=index.packed_offset)
    else:
        rows, kq, extra = index.packed_vecs, k, {}
    s, i = ivf_search_sharded(table, index.centroids, rows,
                              index.packed_ids, queries, kq, nprobe,
                              n_shards=S, bucket_occ=index.bucket_occ,
                              **extra)
    return s[:, :k], i[:, :k]
