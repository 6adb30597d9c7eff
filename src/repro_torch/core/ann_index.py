"""Asynchronously-clustered IVF index for the Knowledge Bank (§3.1, §3.2):
the single-shard half of ``repro.core.ann_index``.

A background ``IVFRefresher`` thread snapshots the bank, k-means
partitions it into ``nlist`` buckets and publishes the new index into the
engine; serving never waits on the clustering. Queries probe ``nprobe``
buckets and stage 2 (``repro_torch.kernels.nn_search_ivf``) scores only
their rows.

Index layout, as in the JAX package:

- ``centroids``   : (C, D) f32, the coarse quantizer;
- ``packed_vecs`` : (C*cap, D) f32, the snapshot's rows grouped by bucket,
  every bucket padded to the common capacity ``cap``;
- ``packed_ids``  : (C*cap,) int32, the bank row of each slot, -1 in the
  padding;
- ``bucket_occ``  : (C,) int32, rows per bucket; each bucket is filled from
  its start, so its occupied slots are its first ``bucket_occ[b]``.

Differences of form from the JAX module:

- the arrays are torch tensors on the device of the table the index was
  built from, and the build runs there (on the card at serving scale);
- the k-means sums per cluster are a one-hot product over fixed chunks of
  rows, never a scatter-add with float atomics, so two builds of one
  snapshot give identical arrays on the card, as they do in JAX;
- ``QuantizedIVFIndex`` keeps no fp32 copy of the packed rows (the JAX one
  keeps its ``base`` for the sharded partial rebuilds, which are not
  ported), so an int8 bank's index holds no fp32 copy of the bank;
- ``IVFRefresher`` takes an optional lock that the server's dispatcher
  holds per op, and the engine takes its snapshot under it: the port's
  state is updated in place, so a snapshot taken while an op runs could
  tear (``KBEngine.rebuild_ann_index``).

``ShardedIVFIndex`` and its builders wait for the sharded backend
(ROADMAP Q1 item 6).
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.core.knowledge_bank import quantize_rows, topk_lowest_id

_CHUNK_ROWS = 1 << 18       # rows per k-means chunk (bounds the temporaries)


def clustered_bank(n: int, dim: int, n_centers: int, *, noise: float = 0.15,
                   seed: int = 0) -> np.ndarray:
    """Mixture-of-Gaussians bank, the workload IVF targets, drawn with
    numpy from ``seed`` (the same distribution as the JAX package's
    ``clustered_bank``, not the same draw)."""
    rng = np.random.default_rng(seed)
    centers = 2.0 * rng.standard_normal((n_centers, dim))
    assign = rng.integers(0, n_centers, n)
    return (centers[assign]
            + noise * rng.standard_normal((n, dim))).astype(np.float32)


def _bucket_occupancy_stats(packed_ids, nlist: int, cap: int) -> dict:
    """Bucket-skew summary: ``skew`` is capacity over mean occupancy (1.0 =
    balanced), ``headroom`` how many rows the fullest bucket can still
    take."""
    occ = (np.asarray(packed_ids.cpu()).reshape(nlist, cap) >= 0).sum(1)
    mean = float(occ.mean())
    return {"nlist": nlist, "bucket_cap": cap, "mean_occupancy": mean,
            "max_occupancy": int(occ.max()),
            "skew": float(cap / max(mean, 1e-9)),
            "headroom": int(cap - occ.max())}


class IVFIndex:
    """Clustered snapshot of a bank table; never changed after the build
    (a rebuild makes a new one)."""

    __slots__ = ("centroids", "packed_vecs", "packed_ids", "nlist",
                 "bucket_cap", "n_rows", "bucket_occ")

    def __init__(self, centroids, packed_vecs, packed_ids, *, nlist: int,
                 bucket_cap: int, n_rows: int, bucket_occ=None):
        self.centroids = centroids
        self.packed_vecs = packed_vecs
        self.packed_ids = packed_ids
        self.nlist = nlist
        self.bucket_cap = bucket_cap
        self.n_rows = n_rows
        if bucket_occ is None:          # derive from the packed layout
            bucket_occ = (packed_ids.reshape(nlist, bucket_cap) >= 0).sum(
                1).to(torch.int32)
        self.bucket_occ = bucket_occ

    def bucket_stats(self) -> dict:
        return _bucket_occupancy_stats(self.packed_ids, self.nlist,
                                       self.bucket_cap)

    def tensors(self):
        return (self.centroids, self.packed_vecs, self.packed_ids,
                self.bucket_occ)


def _chunks(n: int):
    return [(lo, min(lo + _CHUNK_ROWS, n)) for lo in range(0, n, _CHUNK_ROWS)]


def _lloyd_step(table, centroids):
    """One k-means step: L2 assignment (argmax of x.c - |c|^2/2, the first
    on ties), then the mean of each cluster. Empty clusters are reseeded
    with the rows that fit worst. The sums per cluster are one-hot
    products over fixed chunks of rows: the same bits on every run."""
    C = centroids.shape[0]
    cn = torch.sum(centroids * centroids, dim=1)
    arange = torch.arange(C, device=table.device)
    assign = torch.empty((table.shape[0],), dtype=torch.int64,
                         device=table.device)
    best = torch.empty((table.shape[0],), dtype=torch.float32,
                       device=table.device)
    sums = torch.zeros_like(centroids)
    for lo, hi in _chunks(table.shape[0]):
        rows = table[lo:hi]
        logits = rows @ centroids.T - 0.5 * cn[None, :]
        a = torch.argmax(logits, dim=1)
        assign[lo:hi] = a
        best[lo:hi] = torch.gather(logits, 1, a[:, None])[:, 0]
        sums += (a[:, None] == arange[None, :]).to(torch.float32).T @ rows
    cnts = torch.bincount(assign, minlength=C).to(torch.float32)
    new = sums / torch.clamp(cnts, min=1.0)[:, None]
    if bool((cnts == 0).any()):
        # badness = 0.5 |x - c|^2 for the assigned centroid; the C worst
        # rows become the reseed pool
        badness = 0.5 * torch.sum(table * table, dim=1) - best
        worst = topk_lowest_id(badness, C)[1]
        new = torch.where((cnts > 0)[:, None], new, table[worst])
    return new, assign


def _maxmin_init(table, nlist: int):
    """Greedy farthest-point seeding from row 0: every well-separated
    cluster gets one seed. Deterministic."""
    sq = torch.sum(table * table, dim=1)
    c = table[0]
    mind = sq - 2.0 * (table @ c) + torch.sum(c * c)
    cents = torch.zeros((nlist, table.shape[1]), dtype=torch.float32,
                        device=table.device)
    cents[0] = c
    for i in range(1, nlist):
        c = table[torch.argmax(mind)]
        cents[i] = c
        mind = torch.minimum(mind, sq - 2.0 * (table @ c) + torch.sum(c * c))
    return cents


def _centroid_shift(new, old) -> float:
    """Largest squared centroid movement relative to the mean squared
    centroid norm."""
    num = torch.max(torch.sum((new - old) ** 2, dim=1))
    den = torch.mean(torch.sum(old * old, dim=1)) + 1e-12
    return float(num / den)


def kmeans(table, nlist: int, *, iters: int = 8, tol: float = 1e-4):
    """Lloyd's algorithm from the farthest-point seeds. table: (N, D) ->
    (centroids (C, D) f32, assign (N,) int64). ``iters`` is a ceiling:
    the loop stops once the largest relative centroid movement per step
    is at most ``tol`` (``tol=0``: always ``iters`` steps)."""
    table = table.to(torch.float32)
    C = max(1, min(nlist, table.shape[0]))
    centroids = _maxmin_init(table, C)
    for _ in range(max(1, iters)):
        prev = centroids
        centroids, _ = _lloyd_step(table, prev)
        if tol and _centroid_shift(centroids, prev) <= tol * tol:
            break
    # the final assignment against the centroids returned
    _, assign = _lloyd_step(table, centroids)
    return centroids, assign


def _round_capacity(biggest: int) -> int:
    """Common bucket capacity >= the largest bucket: a power of two up to
    128, else the next multiple of 128."""
    biggest = max(biggest, 8)
    if biggest <= 128:
        return 1 << (biggest - 1).bit_length()
    return -(-biggest // 128) * 128


def _pack_buckets(tbl, assign, C: int, cap: int):
    """Group the rows of ``tbl`` by bucket into the padded layout, each
    bucket from its start in row order, -1 ids in the padding."""
    N, D = tbl.shape
    dev = tbl.device
    order = torch.argsort(assign, stable=True)
    sa = assign[order]
    start = torch.searchsorted(sa, torch.arange(C, device=dev))
    slots = sa * cap + (torch.arange(N, device=dev) - start[sa])
    packed_ids = torch.full((C * cap,), -1, dtype=torch.int32, device=dev)
    packed_ids[slots] = order.to(torch.int32)
    packed_vecs = torch.zeros((C * cap, D), dtype=torch.float32, device=dev)
    packed_vecs[slots] = tbl[order]
    return packed_vecs, packed_ids


def build_ivf_index(table, *, nlist: int = 64, iters: int = 8,
                    tol: float = 1e-4) -> IVFIndex:
    """Cluster a table snapshot (N, D) and pack it, on the table's device
    and the caller's thread and stream. The same snapshot always gives
    the same index."""
    tbl = table.to(torch.float32)
    centroids, assign = kmeans(tbl, nlist, iters=iters, tol=tol)
    C = centroids.shape[0]
    occ = torch.bincount(assign, minlength=C).to(torch.int32)
    cap = _round_capacity(int(occ.max()))
    packed_vecs, packed_ids = _pack_buckets(tbl, assign, C, cap)
    return IVFIndex(centroids, packed_vecs, packed_ids, nlist=C,
                    bucket_cap=cap, n_rows=tbl.shape[0], bucket_occ=occ)


class QuantizedIVFIndex:
    """An ``IVFIndex`` whose packed rows are int8 codes with a per-slot
    (scale, offset), by ``quantize_rows``'s rule: padding slots are zero
    rows and code as (0, scale 1, offset 0). ``quantized`` gives the
    (codes, scale, offset) arrays directly (an index carried over from
    the JAX package); by default the base's rows are quantized and the
    base's fp32 rows are not kept."""

    __slots__ = ("centroids", "packed_codes", "packed_scale",
                 "packed_offset", "packed_ids", "nlist", "bucket_cap",
                 "n_rows", "bucket_occ")

    def __init__(self, base: IVFIndex, quantized=None):
        codes, scale, offset = (quantize_rows(base.packed_vecs)
                                if quantized is None else quantized)
        self.centroids = base.centroids
        self.packed_codes = codes
        self.packed_scale = scale
        self.packed_offset = offset
        self.packed_ids = base.packed_ids
        self.nlist = base.nlist
        self.bucket_cap = base.bucket_cap
        self.n_rows = base.n_rows
        self.bucket_occ = base.bucket_occ

    def bucket_stats(self) -> dict:
        return _bucket_occupancy_stats(self.packed_ids, self.nlist,
                                       self.bucket_cap)

    def tensors(self):
        return (self.centroids, self.packed_codes, self.packed_scale,
                self.packed_offset, self.packed_ids, self.bucket_occ)


class IVFRefresher(threading.Thread):
    """Background index maker: polls the engine's write counters and
    rebuilds the index whenever ``rebuild_rows`` rows were written since
    the last build, or no index exists yet. ``lock`` (the server's engine
    lock) is held while the engine takes its snapshot, and only then.
    ``rebuilds`` counts published indexes; ``last_error`` keeps the last
    build's exception (the thread lives on)."""

    def __init__(self, engine, *, rebuild_rows: Optional[int] = None,
                 iters: int = 8, min_period_s: float = 0.01, lock=None,
                 name: str = "ann-refresher"):
        super().__init__(daemon=True, name=name)
        self.engine = engine
        self.rebuild_rows = (max(1, engine.num_entries // 4)
                             if rebuild_rows is None else rebuild_rows)
        self.iters = iters
        self.min_period_s = min_period_s
        self.lock = lock
        self.stop_event = threading.Event()
        self.rebuilds = 0
        self.shard_rebuilds = 0
        self.last_error: Optional[BaseException] = None

    def stale(self) -> bool:
        return (self.engine.ann_index is None
                or self.engine.ann_staleness_rows >= self.rebuild_rows)

    def run(self):
        while not self.stop_event.is_set():
            if self.stale():
                try:
                    self.shard_rebuilds += self.engine.rebuild_ann_index(
                        iters=self.iters, lock=self.lock)
                    self.rebuilds += 1
                    self.last_error = None
                except Exception as e:   # keep the maker alive; a dead
                    self.last_error = e  # refresher would freeze the index
            self.stop_event.wait(self.min_period_s)

    def stop(self, timeout_s: float = 30.0):
        self.stop_event.set()
        self.join(timeout=timeout_s)
