"""Asynchronously-clustered IVF index for the Knowledge Bank (§3.1, §3.2):
the port of ``repro.core.ann_index``.

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

Sharded banks (``ShardedIVFIndex``): shard ``s`` owns the rows
``[s*N/S, (s+1)*N/S)`` and has a sub-index of its own, clustered over only
those rows, with ``nlist`` buckets; every array is shard-major, so shard
s's slice of each is its complete sub-index, and the packed ids are
global. ``build_sharded_ivf_index(base=, shards=)`` re-clusters only the
listed shards and copies the others from ``base`` bit for bit (a full
repack when a rebuilt shard outgrows the common capacity), and the
refresher rebuilds exactly the shards whose own write clock crossed its
budget.

Differences of form from the JAX module:

- the arrays are torch tensors on the device of the table the index was
  built from, and the build runs there (on the card at serving scale),
  one shard after another for a sharded index;
- the k-means sums per cluster are a one-hot product over fixed chunks of
  rows, never a scatter-add with float atomics, so two builds of one
  snapshot give identical arrays on the card, as they do in JAX;
- ``QuantizedIVFIndex`` keeps no fp32 copy of the packed rows, so an int8
  bank's index holds no fp32 copy of the bank; ``QuantizedShardedIVFIndex``
  keeps its fp32 ``base``, as the JAX one does, because a partial rebuild
  copies the untouched shards from it;
- ``IVFRefresher`` takes an optional lock that the server's dispatcher
  holds per op, and the engine takes its snapshot under it: the port's
  state is updated in place, so a snapshot taken while an op runs could
  tear (``KBEngine.rebuild_ann_index``).
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

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


def _pack_buckets(tbl, assign, C: int, cap: int, *, id_offset: int = 0):
    """Group the rows of ``tbl`` by bucket into the padded layout, each
    bucket from its start in row order, -1 ids in the padding.
    ``id_offset`` turns row positions into bank ids (shard s of a sharded
    build packs its slice with offset s * N / S)."""
    N, D = tbl.shape
    dev = tbl.device
    order = torch.argsort(assign, stable=True)
    sa = assign[order]
    start = torch.searchsorted(sa, torch.arange(C, device=dev))
    slots = sa * cap + (torch.arange(N, device=dev) - start[sa])
    packed_ids = torch.full((C * cap,), -1, dtype=torch.int32, device=dev)
    packed_ids[slots] = (order + id_offset).to(torch.int32)
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


class ShardedIVFIndex:
    """Per-shard sub-indexes of a row-sharded bank in one set of
    shard-major arrays: shard s's centroids are rows ``[s*C, (s+1)*C)``,
    its buckets the slots ``[s*C*cap, (s+1)*C*cap)`` (``cap`` common to
    every shard), ``bucket_occ`` (S*C,) in the same global bucket order,
    and ``packed_ids`` global bank ids. ``nlist`` is per shard."""

    __slots__ = ("centroids", "packed_vecs", "packed_ids", "n_shards",
                 "nlist", "bucket_cap", "n_rows", "bucket_occ")

    def __init__(self, centroids, packed_vecs, packed_ids, *, n_shards: int,
                 nlist: int, bucket_cap: int, n_rows: int, bucket_occ=None):
        self.centroids = centroids
        self.packed_vecs = packed_vecs
        self.packed_ids = packed_ids
        self.n_shards = n_shards
        self.nlist = nlist
        self.bucket_cap = bucket_cap
        self.n_rows = n_rows
        if bucket_occ is None:          # derive from the packed layout
            bucket_occ = (packed_ids.reshape(n_shards * nlist, bucket_cap)
                          >= 0).sum(1).to(torch.int32)
        self.bucket_occ = bucket_occ

    def shard_stats(self) -> list:
        """Each shard's bucket-occupancy summary, with its ``shard`` id. The
        capacity is common, so a shard whose ``headroom`` nears 0 is the
        one whose next rebuild forces a full repack."""
        pid = self.packed_ids.reshape(self.n_shards, -1)
        return [dict(_bucket_occupancy_stats(pid[s], self.nlist,
                                             self.bucket_cap), shard=s)
                for s in range(self.n_shards)]

    def tensors(self):
        return (self.centroids, self.packed_vecs, self.packed_ids,
                self.bucket_occ)


def build_sharded_ivf_index(table, n_shards: int, *, nlist: int = 64,
                            iters: int = 8, tol: float = 1e-4,
                            base: Optional[ShardedIVFIndex] = None,
                            shards: Optional[Sequence[int]] = None
                            ) -> ShardedIVFIndex:
    """Cluster each shard's rows of a table snapshot (N, D) into its own
    sub-index, one shard after another, on the table's device and the
    caller's stream.

    With ``base`` and ``shards``, only the listed shards are re-clustered
    and every other shard's arrays are copied from ``base`` bit for bit;
    an empty list returns ``base`` itself. If a rebuilt shard's largest
    bucket outgrows ``base.bucket_cap``, every shard is re-clustered and
    repacked at the larger capacity (the caller sees
    ``result.bucket_cap != base.bucket_cap``). Raises for a bank that
    ``n_shards`` does not divide and for shard ids outside
    ``[0, n_shards)``. The same snapshot and shard list always give the
    same index."""
    tbl = table.to(torch.float32)
    N, D = tbl.shape
    if N % n_shards:
        raise ValueError(f"bank rows {N} not divisible by {n_shards} shards")
    n_local = N // n_shards
    C = max(1, min(nlist, n_local))
    if base is not None and (base.n_shards != n_shards or base.nlist != C):
        base = None                     # shape changed: full rebuild
    if shards is not None:
        bad = [int(s) for s in shards if not 0 <= int(s) < n_shards]
        if bad:
            raise ValueError(f"shard ids {bad} out of range "
                             f"[0, {n_shards})")
    rebuild = (range(n_shards) if base is None or shards is None
               else sorted({int(s) for s in shards}))
    if base is not None and not rebuild:
        return base                     # empty shard list: no-op

    def rows(s):
        return tbl[s * n_local:(s + 1) * n_local]

    def cluster(s):
        return kmeans(rows(s), C, iters=iters, tol=tol)

    def biggest():
        return max(int(torch.bincount(a, minlength=C).max())
                   for _, a in built.values())

    built = {s: cluster(s) for s in rebuild}
    cap = _round_capacity(biggest())
    if base is not None and cap <= base.bucket_cap:
        cap = base.bucket_cap           # partial rebuild keeps the layout
    elif base is not None:              # capacity grew: repack every shard
        base = None
        built.update({s: cluster(s) for s in range(n_shards)
                      if s not in built})
        cap = _round_capacity(biggest())
    dev = tbl.device
    if base is None:
        cent = torch.zeros((n_shards * C, D), dtype=torch.float32, device=dev)
        vecs = torch.zeros((n_shards * C * cap, D), dtype=torch.float32,
                           device=dev)
        ids = torch.full((n_shards * C * cap,), -1, dtype=torch.int32,
                         device=dev)
        occ = torch.zeros((n_shards * C,), dtype=torch.int32, device=dev)
    else:                               # untouched shards: base verbatim
        cent, vecs, ids, occ = (t.clone() for t in base.tensors())
    for s, (centroids, assign) in built.items():
        lo, hi = s * C * cap, (s + 1) * C * cap
        vecs[lo:hi], ids[lo:hi] = _pack_buckets(rows(s), assign, C, cap,
                                                id_offset=s * n_local)
        cent[s * C:(s + 1) * C] = centroids
        occ[s * C:(s + 1) * C] = torch.bincount(assign, minlength=C)
    return ShardedIVFIndex(cent, vecs, ids, n_shards=n_shards, nlist=C,
                           bucket_cap=cap, n_rows=N, bucket_occ=occ)


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


class QuantizedShardedIVFIndex:
    """A ``ShardedIVFIndex`` whose packed rows are int8 codes with a
    per-slot (scale, offset), by ``quantize_rows``'s rule. It keeps its
    fp32 ``base``, which the next partial rebuild copies the untouched
    shards from. ``quantized`` gives the (codes, scale, offset) arrays
    directly (an index carried over from the JAX package)."""

    __slots__ = ("centroids", "packed_codes", "packed_scale",
                 "packed_offset", "packed_ids", "n_shards", "nlist",
                 "bucket_cap", "n_rows", "bucket_occ", "base")

    def __init__(self, base: ShardedIVFIndex, quantized=None):
        codes, scale, offset = (quantize_rows(base.packed_vecs)
                                if quantized is None else quantized)
        self.centroids = base.centroids
        self.packed_codes = codes
        self.packed_scale = scale
        self.packed_offset = offset
        self.packed_ids = base.packed_ids
        self.n_shards = base.n_shards
        self.nlist = base.nlist
        self.bucket_cap = base.bucket_cap
        self.n_rows = base.n_rows
        self.bucket_occ = base.bucket_occ
        self.base = base

    def shard_stats(self) -> list:
        return self.base.shard_stats()

    def tensors(self):
        return (self.centroids, self.packed_codes, self.packed_scale,
                self.packed_offset, self.packed_ids, self.bucket_occ)


class IVFRefresher(threading.Thread):
    """Background index maker: polls the engine's write clocks and
    rebuilds whenever an index is missing or a shard's rows written since
    its own last build reached ``rebuild_shard_rows``, that is
    ``rebuild_rows // engine.ann_shards`` (one shard on the single-index
    engines, where it is ``rebuild_rows``). Only those shards are
    re-clustered. ``lock`` (the server's engine lock) is held while the
    engine takes its snapshot, and only then. ``rebuilds`` counts
    published indexes, ``shard_rebuilds`` the sub-indexes re-clustered
    (the engine reports a full repack as every shard), ``last_build_s``
    the last rebuild's seconds, snapshot to publication; ``last_error``
    keeps the last build's exception (the thread lives on)."""

    def __init__(self, engine, *, rebuild_rows: Optional[int] = None,
                 iters: int = 8, min_period_s: float = 0.01, lock=None,
                 name: str = "ann-refresher"):
        super().__init__(daemon=True, name=name)
        self.engine = engine
        self.rebuild_rows = (max(1, engine.num_entries // 4)
                             if rebuild_rows is None else rebuild_rows)
        self.rebuild_shard_rows = max(1, self.rebuild_rows
                                      // engine.ann_shards)
        self.iters = iters
        self.min_period_s = min_period_s
        self.lock = lock
        self.stop_event = threading.Event()
        self.rebuilds = 0
        self.shard_rebuilds = 0
        self.last_build_s: Optional[float] = None
        self.last_error: Optional[BaseException] = None

    def stale_shards(self) -> list:
        """Shard ids past their budget (every shard while no index
        exists)."""
        if self.engine.ann_index is None:
            return list(range(self.engine.ann_shards))
        per_shard = self.engine.ann_shard_staleness_rows
        return np.flatnonzero(per_shard >= self.rebuild_shard_rows).tolist()

    def run(self):
        while not self.stop_event.is_set():
            stale = self.stale_shards()
            if stale:
                try:
                    t0 = time.perf_counter()
                    self.shard_rebuilds += self.engine.rebuild_ann_index(
                        iters=self.iters, shards=stale, lock=self.lock)
                    self.last_build_s = time.perf_counter() - t0
                    self.rebuilds += 1
                    self.last_error = None
                except Exception as e:   # keep the maker alive; a dead
                    self.last_error = e  # refresher would freeze the index
            self.stop_event.wait(self.min_period_s)

    def stop(self, timeout_s: float = 30.0):
        self.stop_event.set()
        self.join(timeout=timeout_s)
