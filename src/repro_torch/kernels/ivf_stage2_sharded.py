"""IVF stage 2 of a sharded index on the card (``csrc/ivf_stage2_sharded.cu``).

The Hopper kernel in place of ``repro/kernels/nn_search_ivf.py:381``
(``ivf_stage2_sharded_pallas``): over a ``ShardedIVFIndex``'s shard-major
rows, each query's top-k within each shard, from that shard's own probed
buckets, (B, S, k) in the Pallas kernel's (score descending, id
ascending) order with (-1e30, 2**31 - 1) padding. The probes are made
global here (shard s's bucket b is s * nlist + b), and the pass of
``csrc/ivf_stage2.cuh`` runs with one group of probes per shard: bound by
the bytes of the probed buckets in fp32, by its work per byte in int8,
it streams each probed bucket once per tile of 32 queries through a TMA
ring, scores 4 queries a warp in registers and filters each (score, id)
against its (query, shard)'s k-th, in the lists' order, before the lists;
the merge keeps one top-k per (query, shard). The int8 entry does the same over a ``QuantizedShardedIVFIndex``'s
codes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import require_cuda
from repro_torch.kernels.ivf_stage2 import stage2
from repro_torch.kernels.nn_search_ivf import global_probes


def _global_probes(probes, bucket_occ):
    require_cuda(probes, "probes", torch.int32, 3)
    return global_probes(probes, bucket_occ.shape[0]), probes.shape[1]


def ivf_stage2_sharded_cuda(packed_vecs, packed_ids, bucket_occ, queries,
                            probes, k: int):
    """packed_vecs (S*C*cap, D) f32, packed_ids (S*C*cap,) int32 global
    ids, bucket_occ (S*C,) int32, queries (B, D) f32, probes (B, S,
    nprobe) int32 LOCAL bucket ids -> (scores (B, S, k) f32, ids (B, S,
    k) int64), snapshot scores. Takes 1 <= k <= 128, D % 4 == 0,
    S*C <= 65535, cap % 4 == 0, and raises on anything else."""
    require_cuda(packed_vecs, "packed_vecs", torch.float32, 2)
    flat, S = _global_probes(probes, bucket_occ)
    out = stage2("ivf_stage2_sharded", packed_vecs, (), packed_ids,
                 bucket_occ, queries, flat, k, 4, groups=S)
    ivf_stage2_sharded_cuda.launches += 1
    return out


def ivf_stage2_sharded_q_cuda(packed_codes, packed_scale, packed_offset,
                              packed_ids, bucket_occ, queries, probes,
                              k: int):
    """``ivf_stage2_sharded_cuda`` over int8 rows: packed_codes
    (S*C*cap, D) int8, packed_scale / packed_offset (S*C*cap,) f32; scores
    ``scale * (q . c) + sum(q) * offset``. Takes D % 16 == 0."""
    require_cuda(packed_codes, "packed_codes", torch.int8, 2)
    for t, what in ((packed_scale, "packed_scale"),
                    (packed_offset, "packed_offset")):
        require_cuda(t, what, torch.float32, 1)
        if t.shape[0] != packed_codes.shape[0]:
            raise ValueError(f"{what} {tuple(t.shape)} does not match "
                             f"packed_codes {tuple(packed_codes.shape)}")
    flat, S = _global_probes(probes, bucket_occ)
    out = stage2("ivf_stage2_sharded", packed_codes,
                 (packed_scale, packed_offset), packed_ids, bucket_occ,
                 queries, flat, k, 16, symbol="ivf_stage2_sharded_q_launch",
                 groups=S)
    ivf_stage2_sharded_q_cuda.launches += 1
    return out


ivf_stage2_sharded_cuda.launches = 0
ivf_stage2_sharded_q_cuda.launches = 0
