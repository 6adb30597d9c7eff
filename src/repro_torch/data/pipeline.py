"""Synthetic data substrate.

CARLS's claims are about *system* behaviour on graph-structured /
semi-supervised / paired-modality data, so the pipeline generates corpora
with exactly that structure, deterministically from a seed:

- ``SyntheticGraphCorpus``: N nodes in latent clusters. A node's token
  sequence is drawn from its cluster's token range (plus shared vocabulary),
  neighbors are same-cluster nodes (so the graph regularizer has signal, and
  a good model embeds neighbors nearby). A configurable fraction of nodes is
  labeled (cluster id = class label) for the SSL / curriculum experiments,
  and labels can be corrupted for the online-label-mining experiment.
- ``PairedCorpus``: two "modalities" (disjoint vocab halves) per underlying
  concept, for the two-tower contrastive paradigm (§4.3).

Token generation is hash-based (stateless): any node's sequence can be
materialized on demand — the property a real distributed pipeline has, and
what lets knowledge makers re-encode arbitrary node slices.

The port's copy of ``repro/data/pipeline.py``, which is numpy only: the
same code, so that both packages draw the same batches from one seed. The
batches are numpy arrays; the trainer moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


def _hash2(a: np.ndarray, b: np.ndarray, seed: int) -> np.ndarray:
    """Vectorized deterministic integer hash."""
    x = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         ^ b.astype(np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
         ^ np.uint64((seed * 0x94D049BB133111EB) % (1 << 64)))
    x ^= x >> np.uint64(31)
    x *= np.uint64(0xD6E8FEB86659FD93)
    x ^= x >> np.uint64(27)
    return x


@dataclass
class SyntheticGraphCorpus:
    num_nodes: int = 4096
    vocab_size: int = 512
    seq_len: int = 32
    num_clusters: int = 8
    neighbors_per_node: int = 8
    labeled_frac: float = 0.1
    label_noise: float = 0.0
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.clusters = rng.integers(0, self.num_clusters, self.num_nodes)
        self._rng = np.random.default_rng(self.seed + 1)
        n_lab = max(1, int(self.labeled_frac * self.num_nodes))
        self.labeled_ids = rng.choice(self.num_nodes, n_lab, replace=False)
        self.true_labels = self.clusters.copy()
        self.noisy_labels = self.true_labels.copy()
        if self.label_noise > 0:
            flip = rng.random(self.num_nodes) < self.label_noise
            self.noisy_labels[flip] = rng.integers(
                0, self.num_clusters, flip.sum())
        # static neighbor table: same-cluster nodes
        order = np.argsort(self.clusters, kind="stable")
        self._by_cluster = {c: order[self.clusters[order] == c]
                            for c in range(self.num_clusters)}
        nbr = np.full((self.num_nodes, self.neighbors_per_node), -1, np.int32)
        for i in range(self.num_nodes):
            pool = self._by_cluster[self.clusters[i]]
            if len(pool) > 1:
                cand = pool[_hash2(np.full(self.neighbors_per_node, i),
                                   np.arange(self.neighbors_per_node),
                                   self.seed + 7) % len(pool)]
                cand = np.where(cand == i, pool[0], cand)
                nbr[i] = cand
        self.neighbor_table = nbr
        self.neighbor_weights = (nbr >= 0).astype(np.float32)

    # ------------------------------------------------------------------
    def node_tokens(self, ids: np.ndarray) -> np.ndarray:
        """ids: (...,) -> tokens (..., seq_len). Half the positions come from
        the node's cluster-specific vocab range, half from shared vocab."""
        ids = np.asarray(ids)
        S = self.seq_len
        pos = np.arange(S)
        h = _hash2(ids[..., None].astype(np.int64),
                   np.broadcast_to(pos, ids.shape + (S,)).astype(np.int64),
                   self.seed + 13)
        cluster = self.clusters[ids][..., None]
        per_cluster = max(self.vocab_size // (2 * self.num_clusters), 1)
        cluster_tok = (self.vocab_size // 2 + cluster * per_cluster
                       + (h % per_cluster)).astype(np.int64)
        shared_tok = (h % (self.vocab_size // 2)).astype(np.int64)
        use_cluster = (pos % 2 == 0)
        return np.where(use_cluster, cluster_tok, shared_tok).astype(np.int32)

    def batch(self, rng: np.random.Generator, batch_size: int,
              labeled_only: bool = False) -> Dict[str, np.ndarray]:
        pool = self.labeled_ids if labeled_only else np.arange(self.num_nodes)
        ids = rng.choice(pool, batch_size, replace=batch_size > len(pool))
        toks = self.node_tokens(ids)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((batch_size, self.seq_len - 1), np.float32),
            "sample_ids": ids.astype(np.int32),
            "neighbor_ids": self.neighbor_table[ids],
            "neighbor_weights": self.neighbor_weights[ids],
            "class_labels": self.noisy_labels[ids].astype(np.int32),
            "true_class_labels": self.true_labels[ids].astype(np.int32),
        }

    def neighbor_tokens(self, nbr_ids: np.ndarray) -> np.ndarray:
        """(B, K) -> (B, K, seq_len-1) tokens for the inline baseline."""
        return self.node_tokens(np.maximum(nbr_ids, 0))[..., :-1]


@dataclass
class PairedCorpus:
    """Two-modality pairs for the §4.3 two-tower experiments."""
    num_pairs: int = 4096
    vocab_size: int = 512
    seq_len: int = 16
    num_concepts: int = 64
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.concepts = rng.integers(0, self.num_concepts, self.num_pairs)

    def _tokens(self, ids, modality: int):
        ids = np.asarray(ids)
        S = self.seq_len
        pos = np.arange(S)
        h = _hash2(ids[..., None].astype(np.int64) * 2 + modality,
                   np.broadcast_to(pos, ids.shape + (S,)).astype(np.int64),
                   self.seed + 29)
        half = self.vocab_size // 2
        per_c = max(half // self.num_concepts, 1)
        base = modality * half
        concept = self.concepts[ids][..., None]
        # even positions: concept-specific tokens; odd: modality noise
        ct = base + (concept * per_c + h % per_c) % half
        nt = base + h % half
        return np.where(pos % 2 == 0, ct, nt).astype(np.int32)

    def batch(self, rng, batch_size: int):
        ids = rng.choice(self.num_pairs, batch_size, replace=False)
        return {"ids": ids.astype(np.int32),
                "tokens_a": self._tokens(ids, 0),
                "tokens_b": self._tokens(ids, 1),
                "concepts": self.concepts[ids].astype(np.int32)}
