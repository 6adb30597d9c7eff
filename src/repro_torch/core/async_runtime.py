"""Asynchronous host runtime: the request-coalescing Knowledge-Bank
server, the knowledge makers as paced background clients of it, and the
trainer loop that drives both; the port of ``repro.core.async_runtime``.

Concurrent callers do not each pay a locked device round-trip: every call
enqueues an (op, ids, payload) request, and a dispatcher thread drains the
queue and executes ONE batched engine op per maximal FIFO run of same-op
requests. Set ``coalesce=False`` for the per-call locked baseline.

Why coalescing is legal: the engine's batched ops are deterministic under
duplicate ids, version counters bump once per touched row per call, and a
client blocks on its request before issuing its next one, so per-client
program order holds. nn_search requests merge only with the same k, mode
and exclusion width, and the search is a pure function of the state. A
merged run equals a serial interleaving of its requests for lookup,
update, flush and nn_search, and for lazy_grad with entry-side clipping
off (cache adds commute). With entry-side clipping on, a merged lazy_grad
run clips every contribution against the pre-drain norm EMA and advances
the EMA one step on the pooled mean, the paper's own model (§3.2 caches
trainer gradients with no ordering guarantee). FIFO's merge of consecutive
requests is that contract. The reordering dispatcher (``reorder=True``)
moves a lazy_grad across, or into the run of, another lazy_grad only
where their ids are disjoint, so its schedule gives FIFO's results bit for
bit; the JAX dispatcher lets any two lazy_grads commute, which calls two
lazy_grads on one row as one (ROADMAP Q3 item 10).

``start_ann_refresher`` registers the IVF index maker
(``repro_torch.core.ann_index.IVFRefresher``), which takes its snapshots
under the engine lock that the dispatcher holds for every op; on the
sharded backend (pass ``backend=ShardedBackend(S)``) it rebuilds each
shard's sub-index on its own clock.

``MakerRuntime`` and ``MakerJob`` run the paper's four knowledge makers
(``embedding_refresh``, ``label_mining``, ``graph_agreement``,
``graph_builder``) as independently paced threads, each a client of one
server; label and graph knowledge lands in a lock-protected
``SharedFeatureStore``. ``run_async_training`` is the trainer loop of the
paper's Figure 1 on one device: each step it looks the neighbour rows up
through the server, runs the train core, hands their gradient back to the
server's lazy cache and, every ``ckpt_period`` steps, publishes a
checkpoint for the makers.

Differences of form from JAX: the trainer's AdamW updates the parameters
in place, so a published checkpoint is a COPY (a maker must never read
weights that change under it), and the jobs of one runtime share one
cached checkpoint; every thread launches its kernels on the device's
default stream, where they run in the order they were queued; the
shared feature store lives on the host, where its numpy traffic is.

Under ``torch.profiler`` the trainer's core runs in the range
``carls.train_core`` and a checkpoint's copy in ``carls.publish``. The
profiler records the host ops of the thread that started it (and of
autograd's, which runs the backward); the makers' and the dispatcher's
threads show only as their kernels.

Everything here takes the ``KBClient`` duck-type
(``repro_torch.core.kb_protocol``), never the server class:
``MakerRuntime`` and ``run_async_training(kb_client=)`` run unchanged
against a ``RemoteKnowledgeBank`` (a bank in another process) or a
``KBRouter`` (a partitioned fleet). ``KnowledgeBankServer.stats()`` also
reports its process's kernel launches and peak device memory
(``"device"``), so that a client reads them over the wire.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.checkpoint import MemoryCheckpointStore
from repro_torch.core.ann_index import IVFRefresher
from repro_torch.core.kb_engine import KBEngine
from repro_torch.core.kb_protocol import KBClient
from repro_torch.core.knowledge_bank import (feature_store_create,
                                             fs_update_labels,
                                             fs_update_neighbors)
from repro_torch.core.knowledge_maker import vote_agreement_labels
from repro_torch.core.trainer import make_async_train_fns
from repro_torch.data import SyntheticGraphCorpus
from repro_torch.env import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.model import LM
from repro_torch.optim import AdamW, constant_lr
from repro_torch.tree import tree_map


class KBServerClosedError(RuntimeError):
    """Raised by requests submitted after ``KnowledgeBankServer.close()``
    began: fail fast instead of hanging in ``_Request.wait()`` behind a
    dispatcher that is (or has finished) draining."""


class _Request:
    """One queued client call; ``event`` fires when ``result`` is ready.
    ``meta`` carries the op's step tag (lookup: trainer_step; update:
    src_step) so staleness accounting happens in execution order."""

    __slots__ = ("op", "ids", "payload", "k", "mode", "excl", "shape",
                 "meta", "event", "result", "error", "_callbacks")

    def __init__(self, op, ids=None, payload=None, k=None, mode=None,
                 excl=None, shape=None, meta=0):
        self.op, self.ids, self.payload, self.k = op, ids, payload, k
        self.mode, self.excl, self.shape, self.meta = mode, excl, shape, meta
        self.event = threading.Event()
        self.result = None
        self.error = None
        self._callbacks: list = []

    def wait(self):
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self.result

    def add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` once ``result`` or ``error`` is set, at once
        if it already is. The wire transport's out-of-order completion
        hook (protocol v4): a connection queues the response frame the
        moment the dispatcher finishes THIS request, instead of parking a
        thread in ``wait()`` per request in flight. Callbacks run on the
        completing thread (the dispatcher), where the result is already a
        host array, and must be cheap and never block. Each registered
        callback fires exactly once."""
        self._callbacks.append(fn)
        if self.event.is_set():
            self._fire_callbacks()

    def _fire_callbacks(self) -> None:
        # list.pop is atomic under the GIL: when registration races
        # completion, each callback is popped, and so fired, exactly once,
        # by whichever side wins. A callback's error never reaches the
        # dispatcher (deliver, don't kill)
        while self._callbacks:
            try:
                cb = self._callbacks.pop()
            except IndexError:
                return
            try:
                cb(self)
            except Exception:
                pass


def _mergeable(prev: _Request, r: _Request) -> bool:
    """Can ``r`` join the run started by ``prev`` as one batched op?"""
    if prev.op != r.op:
        return False
    if r.op in ("lookup", "update", "lazy_grad"):
        return True
    if r.op != "nn" or prev.k != r.k or prev.mode != r.mode:
        return False
    # exclusion lists concatenate row-aligned with the queries, so merged
    # requests must agree on the per-query exclusion width (incl. "none")
    pw = None if prev.excl is None else prev.excl.shape[1]
    rw = None if r.excl is None else r.excl.shape[1]
    return pw == rw


def _commutes(a: _Request, b: _Request) -> bool:
    """May ``a`` execute before ``b`` even though ``b`` was queued first?

    - lookup/lookup, nn/nn: always (lookups apply and clear pending caches
      idempotently, searches are pure);
    - any other pair within {lookup, update, lazy_grad}, two lazy_grads
      included: only when the id sets are DISJOINT (a lazy_grad call clips
      each contribution against its row's norm EMA and then steps that
      EMA once, so two calls on one row are not one call);
    - flush / barrier / nn-vs-write: never.
    """
    if a.op == b.op and a.op in ("lookup", "nn"):
        return True
    if (a.op in ("lookup", "update", "lazy_grad")
            and b.op in ("lookup", "update", "lazy_grad")):
        return not bool(np.isin(a.ids, b.ids).any())
    return False


class KnowledgeBankServer:
    """Thread-safe KB server with request coalescing over a ``KBEngine``
    (by default on the CUDA kernel backend, on ``device="cuda"``)."""

    def __init__(self, num_entries: Optional[int] = None,
                 dim: Optional[int] = None, *,
                 engine: Optional[KBEngine] = None, backend="cuda",
                 lazy_lr: float = 0.1, zmax: float = 3.0,
                 lazy_update: bool = True, coalesce: bool = True,
                 coalesce_window_s: float = 0.0, max_coalesce: int = 256,
                 reorder: bool = False, reorder_window: int = 8,
                 search_mode: str = "exact", ann_nlist: int = 64,
                 ann_nprobe: int = 8, ann_stale_rows: Optional[int] = None,
                 storage: str = "fp32", cache_rows: int = 0,
                 resident_rows: Optional[int] = None,
                 cold_after_rows: Optional[int] = None,
                 cold_dir: Optional[str] = None, device="cuda"):
        if engine is None:
            engine = KBEngine(num_entries, dim, backend=backend,
                              lazy_lr=lazy_lr, zmax=zmax,
                              lazy_update=lazy_update,
                              search_mode=search_mode, ann_nlist=ann_nlist,
                              ann_nprobe=ann_nprobe,
                              ann_stale_rows=ann_stale_rows, storage=storage,
                              resident_rows=resident_rows,
                              cold_after_rows=cold_after_rows,
                              cold_dir=cold_dir, device=device)
        self.engine = engine
        self.coalesce = coalesce
        self.coalesce_window_s = coalesce_window_s
        self.max_coalesce = max_coalesce
        # cross-op reordering (off by default: FIFO run formation is the
        # bit-exact baseline): a request may hop over up to reorder_window
        # earlier runs it commutes with (see _commutes) to join a mergeable
        # run
        self.reorder = reorder
        self.reorder_window = reorder_window
        # row -> trainer step of the checkpoint that produced the row
        self._row_src_step = np.full((engine.num_entries,), -1, np.int64)
        # hot-id LRU in front of the engine (cache_rows = 0 disables).
        # Legal because the engine's lookup is idempotent between writes
        # and every write invalidates the ids it touches (flush clears all)
        self.cache_rows = cache_rows
        self._row_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.metrics = {"lookups": 0, "updates": 0, "lazy_grads": 0,
                        "rows_served": 0, "stale_rows_served": 0,
                        "staleness_sum": 0.0,
                        "requests": 0, "dispatches": 0, "max_run": 0,
                        "reorders": 0, "cache_hits": 0, "cache_misses": 0}
        self._mlock = threading.Lock()      # metrics + row_src_step
        self._elock = threading.Lock()      # engine state (direct path)
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._dispatcher = None
        self._ann_refresher = None
        self._ann_closed_counts = {"rebuilds": 0, "shard_rebuilds": 0}
        self._maker_runtime = None
        if coalesce:
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True, name="kb-dispatch")
            self._dispatcher.start()

    # -- client API --------------------------------------------------------

    def lookup(self, ids: np.ndarray, *, trainer_step: int = 0) -> np.ndarray:
        """Fetch rows, applying pending lazy gradients first. Blocking; the
        result equals a serial execution at this request's queue position.
        ``trainer_step`` tags the call for staleness accounting."""
        ids = np.asarray(ids)
        return self._submit(_Request("lookup", ids.reshape(-1),
                                     shape=ids.shape, meta=trainer_step))

    def update(self, ids, values, *, src_step: int = 0) -> None:
        """Direct write (maker push); last-writer-wins on duplicate ids,
        within one call and within a merged run (requests concatenate in
        FIFO order and the engine keeps the final occurrence)."""
        ids = np.asarray(ids)
        self._submit(_Request("update", ids.reshape(-1),
                              np.asarray(values).reshape(ids.size, -1),
                              meta=src_step))

    def lazy_grad(self, ids, grads) -> None:
        """Cache gradients for lazy application on next lookup/flush."""
        ids = np.asarray(ids)
        self._submit(_Request("lazy_grad", ids.reshape(-1),
                              np.asarray(grads, np.float32).reshape(
                                  ids.size, -1)))

    def flush(self) -> None:
        """Apply every pending cached gradient now (expiration path)."""
        self._submit(_Request("flush"))

    def nn_search(self, queries, k: int, *, mode: Optional[str] = None,
                  exclude_ids=None):
        """Top-k MIPS over the bank; only same-(k, mode, exclusion-width)
        searches coalesce. ``exclude_ids`` (B, E), -1 = no-op, bans rows
        per query."""
        queries = np.asarray(queries)
        excl = (None if exclude_ids is None
                else np.asarray(exclude_ids,
                                np.int64).reshape(queries.shape[0], -1))
        return self._submit(_Request("nn", payload=queries, k=k, mode=mode,
                                     excl=excl))

    def table_snapshot(self) -> np.ndarray:
        """Consistent snapshot: barriers behind every queued write first.
        Still legal after a CLEAN close: the drain emptied the queue."""
        if not (self._closed and self._dispatcher is None):
            self._submit(_Request("barrier"))
        with self._elock:
            return self.engine.table_snapshot()

    def export_rows(self, ids) -> dict:
        """Full per-row engine state for ``ids`` (every leaf, raw dtypes;
        see ``KBEngine.export_rows``). Barriers behind queued writes
        first, as ``table_snapshot`` does, so the rows reflect everything
        acknowledged before this call: the replica warm-fill and reshard
        read primitive."""
        if not (self._closed and self._dispatcher is None):
            self._submit(_Request("barrier"))
        with self._elock:
            return self.engine.export_rows(ids)

    def import_rows(self, ids, leaves: dict) -> None:
        """Scatter exported rows into the engine (standby fill, reshard
        landing), bit-identically. Runs behind a barrier and under the
        engine lock like any write; the touched ids leave the hot-id
        cache."""
        if not (self._closed and self._dispatcher is None):
            self._submit(_Request("barrier"))
        with self._elock:
            self.engine.import_rows(ids, leaves)
            self._invalidate_cache(np.asarray(ids).reshape(-1))

    def warmup(self, max_batch: int = 256) -> None:
        """Build and load every kernel before the first request (the
        engine warms up on a scratch state)."""
        with self._elock:
            self.engine.warmup(max_batch)

    @property
    def coalescing_factor(self) -> float:
        """Mean requests per device dispatch (1.0 = no coalescing won)."""
        return self.metrics["requests"] / max(self.metrics["dispatches"], 1)

    @property
    def mean_staleness(self) -> float:
        return self.metrics["staleness_sum"] / max(
            self.metrics["rows_served"], 1)

    @property
    def num_entries(self) -> int:
        """The bank's rows (the engine's), part of the client surface."""
        return self.engine.num_entries

    @property
    def dim(self) -> int:
        return self.engine.dim

    def attach_maker_runtime(self, runtime) -> None:
        """Register the ``MakerRuntime`` that serves this bank, so that its
        per-maker counters are read from the server (``maker_stats``).
        Only for reading: the runtime's owner starts and stops it."""
        self._maker_runtime = runtime

    @property
    def maker_stats(self) -> Dict[str, Dict]:
        """Per-maker ``{name: {maker_steps, rows_written,
        ckpt_version_lag, ...}}`` of the attached runtime ({} without
        one)."""
        if self._maker_runtime is None:
            return {}
        return self._maker_runtime.stats()

    def stats(self) -> dict:
        """Server metrics, the derived staleness and coalescing ratios, the
        engine's search counters and storage accounting, in the JAX
        server's keys, the attached maker runtime's ``maker_stats``, the
        index maker's ``rebuilds`` (indexes published) and
        ``shard_rebuilds`` (sub-indexes re-clustered), 0 without one, and
        under ``"device"`` the engine's device type, this process's
        kernel launches (``ops.launch_counts``) and its peak device
        memory in bytes (0 on the CPU)."""
        with self._mlock:
            m = dict(self.metrics)
        storage = self.engine.storage_stats()
        m["tier_faults"] = storage["tier_faults"]
        m["tier_spills"] = storage["tier_spills"]
        return {"metrics": m,
                "mean_staleness": float(self.mean_staleness),
                "coalescing_factor": float(self.coalescing_factor),
                "search_stats": dict(self.engine.search_stats),
                "backend": self.engine.backend.name,
                "num_entries": int(self.engine.num_entries),
                "dim": int(self.engine.dim),
                "storage": storage, "maker_stats": self.maker_stats,
                **self._ann_counts(), "device": self._device_stats()}

    def _device_stats(self) -> dict:
        dev = self.engine.device
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        return {"type": dev.type, "launches": ops.launch_counts(),
                "peak_bytes": int(peak)}

    def _ann_counts(self) -> dict:
        """The index maker's counters (its last ones once closed)."""
        r = self._ann_refresher
        if r is None:
            return dict(self._ann_closed_counts)
        return {"rebuilds": r.rebuilds, "shard_rebuilds": r.shard_rebuilds}

    def start_ann_refresher(self, **kwargs) -> IVFRefresher:
        """Start the IVF index maker: a daemon thread that rebuilds the
        engine's index off the serving path, taking each snapshot under
        the engine lock; on the sharded backend only the shards with
        ``rebuild_rows // S`` rows written since their last build. Stopped
        by ``close``. Returns the thread (its ``rebuilds`` and
        ``shard_rebuilds`` counters and ``last_error`` are the hooks)."""
        if self._ann_refresher is None:
            self._ann_refresher = IVFRefresher(self.engine, lock=self._elock,
                                               **kwargs)
            self._ann_refresher.start()
        return self._ann_refresher

    def close(self, timeout_s: float = 60.0) -> None:
        """Stop the index maker, then the dispatcher after draining every
        already-queued request. The moment close() begins, NEW submissions
        fail fast with ``KBServerClosedError``. Raises if the drain does not
        finish within ``timeout_s``; requests still stranded in the queue
        at that point are failed with the same error, never left
        hanging."""
        if self._ann_refresher is not None:
            self._ann_refresher.stop()
            self._ann_closed_counts = self._ann_counts()
            self._ann_refresher = None
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._dispatcher is None:
            return
        self._dispatcher.join(timeout=timeout_s)
        if self._dispatcher.is_alive():
            with self._cond:
                stranded = list(self._queue)
                self._queue.clear()
            err = KBServerClosedError(
                f"request abandoned: KB dispatcher did not drain within "
                f"{timeout_s}s of close()")
            for r in stranded:
                r.error = err
                r.event.set()
                r._fire_callbacks()
            raise RuntimeError(
                f"KB dispatcher did not drain within {timeout_s}s "
                f"({len(stranded)} stranded requests failed)")
        self._dispatcher = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- execution ---------------------------------------------------------

    def enqueue_op(self, op: str, *, ids=None, payload=None, k=None,
                   mode=None, excl=None, shape=None, meta: int = 0):
        """Queue one client op WITHOUT waiting and return the pending
        request (call ``.wait()`` for the result), so that a caller can put
        several ops in the same coalescing window. Raises
        ``KBServerClosedError`` once close() has begun."""
        return self._submit_nowait(_Request(op, ids, payload, k=k,
                                            mode=mode, excl=excl,
                                            shape=shape, meta=meta))

    def _submit_nowait(self, req: _Request) -> _Request:
        # refuse out-of-range ids here, in the caller's thread, so that a
        # bad request never joins (and fails) a merged run of good ones
        if req.ids is not None:
            self.engine.check_ids(req.ids, req.op)
        if req.excl is not None:
            self.engine.check_ids(req.excl, "nn_search exclude_ids", low=-1)
        if self.coalesce:
            with self._cond:
                if self._closed:
                    raise KBServerClosedError(
                        "KnowledgeBankServer is closed: request submitted "
                        "after close() began")
                if req.op != "barrier":     # barriers never dispatch; keep
                    with self._mlock:       # coalescing_factor honest
                        self.metrics["requests"] += 1
                self._queue.append(req)
                self._cond.notify()
            return req
        # per-call locked baseline (coalesce=False)
        if self._closed:
            raise KBServerClosedError(
                "KnowledgeBankServer is closed: request submitted after "
                "close() began")
        if req.op != "barrier":
            with self._mlock:
                self.metrics["requests"] += 1
        with self._elock:
            self._execute_run([req])
        return req

    def _submit(self, req: _Request):
        return self._submit_nowait(req).wait()

    def _dispatch_loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed and not self._queue:
                    return
            if self.coalesce_window_s:
                time.sleep(self.coalesce_window_s)   # let the queue fill
            with self._cond:
                batch = [self._queue.popleft()
                         for _ in range(min(len(self._queue),
                                            self.max_coalesce))]
            for run in self._form_runs(batch):
                with self._elock:
                    self._execute_run(run)

    def _form_runs(self, batch: List[_Request]) -> List[List[_Request]]:
        """Group a popped batch into runs, each one batched engine op.

        FIFO mode (default): maximal runs of consecutive same-op requests.
        With ``reorder=True`` a request that can't extend the tail run may
        instead hop backwards over up to ``reorder_window`` earlier runs and
        join the nearest mergeable one, PROVIDED it commutes with every
        request it crosses (``_commutes``): the reordered schedule is then a
        series of transpositions of commuting pairs away from FIFO, so the
        results equal the FIFO schedule's. A lazy_grad joins a run (the
        tail one included) only where each member is of its own FIFO run
        or shares no id with it: FIFO calls two lazy_grads on one row apart
        whenever another op lies between them."""
        runs: List[List[_Request]] = []
        fifo_run = {}                    # id(request) -> its FIFO run
        first = None
        hoisted = 0

        def joins(run, r) -> bool:
            if not _mergeable(run[0], r):
                return False
            return r.op != "lazy_grad" or all(
                fifo_run[id(q)] == fifo_run[id(r)] or _commutes(r, q)
                for q in run)

        for r in batch:
            if first is None or not _mergeable(first, r):
                first = r
            fifo_run[id(r)] = id(first)
            if runs and joins(runs[-1], r):
                runs[-1].append(r)
                continue
            if self.reorder and runs:
                target = None
                i = len(runs) - 1
                hops = 0
                while i >= 0 and hops < self.reorder_window:
                    if not all(_commutes(r, q) for q in runs[i]):
                        break
                    i -= 1
                    hops += 1
                    if i >= 0 and joins(runs[i], r):
                        target = i
                        break
                if target is not None:
                    runs[target].append(r)
                    hoisted += 1
                    continue
            runs.append([r])
        if hoisted:
            with self._mlock:
                self.metrics["reorders"] += hoisted
        return runs

    def _execute_run(self, run: List[_Request]):
        op = run[0].op
        try:
            before = self.engine.dispatches
            if op == "lookup":
                ids = np.concatenate([r.ids for r in run])
                vals = (self._cached_lookup(ids) if self.cache_rows > 0
                        else self.engine.lookup(ids))
                off = 0
                for r in run:
                    n = r.ids.size
                    r.result = vals[off:off + n].reshape(*r.shape, -1)
                    off += n
                # staleness is accounted HERE, in execution order
                with self._mlock:
                    for r in run:
                        src = self._row_src_step[r.ids]
                        known = src >= 0
                        self.metrics["lookups"] += 1
                        self.metrics["rows_served"] += r.ids.size
                        self.metrics["stale_rows_served"] += int(
                            (known & (src < r.meta)).sum())
                        self.metrics["staleness_sum"] += float(
                            np.maximum(r.meta - src[known], 0).sum())
            elif op == "update":
                w_ids = np.concatenate([r.ids for r in run])
                self.engine.update(w_ids,
                                   np.concatenate([r.payload for r in run]))
                self._invalidate_cache(w_ids)
                with self._mlock:
                    for r in run:
                        self._row_src_step[r.ids] = r.meta
                        self.metrics["updates"] += 1
            elif op == "lazy_grad":
                w_ids = np.concatenate([r.ids for r in run])
                self.engine.lazy_grad(
                    w_ids, np.concatenate([r.payload for r in run]))
                self._invalidate_cache(w_ids)
                with self._mlock:
                    self.metrics["lazy_grads"] += len(run)
            elif op == "flush":
                self.engine.flush()
                self._row_cache.clear()
            elif op == "nn":
                sizes = [r.payload.shape[0] for r in run]
                excl = (None if run[0].excl is None
                        else np.concatenate([r.excl for r in run]))
                scores, ids = self.engine.nn_search(
                    np.concatenate([r.payload for r in run]), run[0].k,
                    mode=run[0].mode, exclude_ids=excl)
                off = 0
                for r, n in zip(run, sizes):
                    r.result = (scores[off:off + n], ids[off:off + n])
                    off += n
            elif op != "barrier":
                raise ValueError(f"unknown KB op {op!r}")
            with self._mlock:
                self.metrics["dispatches"] += self.engine.dispatches - before
                self.metrics["max_run"] = max(self.metrics["max_run"],
                                              len(run))
        except Exception as e:          # deliver, don't kill the dispatcher
            for r in run:
                r.error = e
        finally:
            for r in run:
                r.event.set()
                r._fire_callbacks()

    def _cached_lookup(self, ids: np.ndarray) -> np.ndarray:
        """Hot-id LRU read path: serve repeats from host RAM, engine-lookup
        only the distinct missing ids, refresh the cache with what came
        back. Runs under ``_elock`` like every other engine touch."""
        flat = ids.reshape(-1)
        out = np.empty((flat.size, self.engine.dim), np.float32)
        cache = self._row_cache
        miss_pos = []
        hits = 0
        for i in range(flat.size):
            row = cache.get(int(flat[i]))
            if row is None:
                miss_pos.append(i)
            else:
                cache.move_to_end(int(flat[i]))
                out[i] = row
                hits += 1
        if miss_pos:
            uniq, inv = np.unique(flat[miss_pos], return_inverse=True)
            vals = self.engine.lookup(uniq)
            out[miss_pos] = vals[inv]
            for j in range(uniq.size):
                cache[int(uniq[j])] = vals[j]
            while len(cache) > self.cache_rows:
                cache.popitem(last=False)
        with self._mlock:
            self.metrics["cache_hits"] += hits
            self.metrics["cache_misses"] += len(miss_pos)
        return out

    def _invalidate_cache(self, ids: np.ndarray) -> None:
        """Drop written rows from the hot-id cache."""
        if self._row_cache:
            for g in np.unique(ids):
                self._row_cache.pop(int(g), None)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SharedFeatureStore:
    """Host-side ``FeatureStore`` shared by concurrent maker jobs.

    The fs ops stay the one source of label and graph semantics (the
    confidence gate lives in ``fs_update_labels``); this wrapper adds a
    lock around each read-modify-write and returns write counts, so that
    makers report ``rows_written`` honestly (a label the gate rejects is
    not a write). The store's tensors lie on the CPU and are updated in
    place, so ``snapshot`` and ``labels`` return copies."""

    def __init__(self, num_entries: int, max_neighbors: int = 8):
        self._lock = threading.Lock()
        self.fs = feature_store_create(num_entries, max_neighbors,
                                       device="cpu")

    def snapshot(self):
        with self._lock:
            return self.fs._replace(**{n: t.clone() for n, t in
                                       self.fs._asdict().items()})

    def labels(self) -> np.ndarray:
        with self._lock:
            return self.fs.labels.numpy().copy()

    def labeled_ids(self, cap: Optional[int] = None) -> np.ndarray:
        """The labeled node ids; ``cap`` takes an evenly strided subsample
        of them, so that callers see a bounded batch."""
        lab = np.flatnonzero(self.labels() >= 0)
        if cap is not None and lab.size > cap:
            lab = lab[np.linspace(0, lab.size - 1, cap).astype(np.int64)]
        return lab

    def update_labels(self, ids, labels, conf) -> int:
        """Confidence-gated label write; returns how many labels the gate
        accepted."""
        ids = torch.as_tensor(np.asarray(ids)).long()
        conf = torch.as_tensor(np.asarray(conf, np.float32))
        with self._lock:
            accepted = int((conf > self.fs.label_conf[ids]).sum())
            fs_update_labels(self.fs, ids,
                             torch.as_tensor(np.asarray(labels)), conf)
            return accepted

    def update_neighbors(self, ids, nbr_ids, nbr_weights) -> int:
        ids = np.asarray(ids)
        nbr_ids = np.asarray(nbr_ids)
        nbr_weights = np.asarray(nbr_weights, np.float32)
        width = int(self.fs.nbr_ids.shape[1])
        if nbr_ids.shape[1] > width:
            raise ValueError(f"{nbr_ids.shape[1]} neighbors per node won't "
                             f"fit this store's width {width}")
        if nbr_ids.shape[1] < width:    # a narrower writer pads with the
            pad = width - nbr_ids.shape[1]      # store's missing marker
            nbr_ids = np.concatenate(
                [nbr_ids, np.full((len(ids), pad), -1, nbr_ids.dtype)], 1)
            nbr_weights = np.concatenate(
                [nbr_weights, np.zeros((len(ids), pad), np.float32)], 1)
        with self._lock:
            fs_update_neighbors(self.fs, torch.as_tensor(ids),
                                torch.as_tensor(nbr_ids),
                                torch.as_tensor(nbr_weights))
            return int(ids.size)


class MakerJob(threading.Thread):
    """One independently paced knowledge maker: load the latest trainer
    checkpoint, compute one batch of knowledge over a round-robin slice of
    nodes, push it through the coalescing server, repeat.

    Every push is tagged with the checkpoint step the job loaded
    (``src_step``), so the server's staleness accounting, and this job's
    ``ckpt_version_lag`` counters, measure data freshness per maker. A
    failing step records ``last_error``, counts under ``errors`` (never
    as a maker step) and keeps the thread alive."""

    def __init__(self, runtime: "MakerRuntime", name: str, kind: str,
                 step_fn: Callable, nodes: np.ndarray, *,
                 batch_size: int = 64, min_period_s: float = 0.0,
                 needs_ckpt: bool = True):
        super().__init__(daemon=True, name=name)
        self.runtime, self.kind, self.step_fn = runtime, kind, step_fn
        self.nodes = np.asarray(nodes)
        self.batch_size = batch_size
        self.min_period_s = min_period_s
        self.needs_ckpt = needs_ckpt
        self.stop_event = threading.Event()
        self.steps = 0
        self.rows_written = 0
        self.lag_sum = 0
        self.last_lag = 0
        self.errors = 0
        # bounded: recent history is all that tests and diagnostics read
        self.ckpt_steps_used: deque = deque(maxlen=4096)
        self.last_error: Optional[BaseException] = None
        self._cursor = 0

    def _next_ids(self) -> np.ndarray:
        ids = self.nodes[np.arange(self._cursor,
                                   self._cursor + self.batch_size)
                         % len(self.nodes)]
        self._cursor = (self._cursor + self.batch_size) % len(self.nodes)
        return ids

    def run(self):
        rt = self.runtime
        # idle and error cycles keep the job's pacing floor too (never
        # faster than a 5 ms poll): a crashing maker must not flood the
        # server that the pacing protects
        backoff = max(self.min_period_s, 0.005)
        while not self.stop_event.is_set():
            try:
                step, params = rt.load_ckpt()
                if self.needs_ckpt and params is None:
                    self.stop_event.wait(backoff)   # nothing published yet
                    continue
                step = 0 if step is None else int(step)
                rows = self.step_fn(params, step, self._next_ids())
                self.last_error = None
            except Exception as e:      # record, back off, stay alive
                self.last_error = e
                self.errors += 1
                self.stop_event.wait(backoff)
                continue
            if rows is None:            # idle: preconditions not met
                self.stop_event.wait(backoff)
                continue
            self.steps += 1
            self.rows_written += int(rows)
            # the trainer's clock less the checkpoint this batch used
            lag = max(rt.trainer_step - step, 0)
            self.last_lag = lag
            self.lag_sum += lag
            self.ckpt_steps_used.append(step)
            if self.min_period_s:
                self.stop_event.wait(self.min_period_s)

    def stop(self, timeout_s: float = 30.0):
        self.stop_event.set()
        self.join(timeout=timeout_s)


class MakerRuntime:
    """Registry and lifecycle of the paper's knowledge makers, all clients
    of ONE knowledge bank: any ``KBClient``, the in-process
    ``KnowledgeBankServer`` or a ``RemoteKnowledgeBank`` / ``KBRouter``
    whose bank lives in other processes (each step's lookups, searches and
    writes go through the client's numpy surface).

    ``register(kind)`` makes one of the four maker kinds a ``MakerJob``
    with its own batch size, pacing (``min_period_s``) and node slice;
    ``start()`` / ``stop()`` run the fleet. The runtime owns the
    ``SharedFeatureStore`` the label and graph makers write, and the
    trainer publishes its step on ``trainer_step`` so that every job's
    ``ckpt_version_lag`` is measured against the live trainer clock.

    - ``embedding_refresh``: re-encode node tokens with the latest
      checkpoint and ``server.update`` the bank (needs ``ckpts`` and
      ``embed_fn``).
    - ``label_mining``: embed a node batch and classify it against
      per-class centroids of the labeled bank rows (read back through
      ``server.lookup``), then gate-write the labels.
    - ``graph_agreement``: embed a node batch, fetch its nearest bank rows
      through ``server.nn_search`` and gate-write the labeled neighbours'
      weighted vote.
    - ``graph_builder``: read rows through ``server.lookup``, find their
      top-k neighbours through ``server.nn_search`` and write the graph.
      It needs no checkpoint, so it also runs beside a serving bank.

    The jobs share one cached checkpoint (``load_ckpt``), re-read only
    when the published step moves. Node tokens go to ``device``, where
    ``embed_fn`` runs."""

    MAKER_KINDS = ("embedding_refresh", "label_mining", "graph_agreement",
                   "graph_builder")

    def __init__(self, server: KBClient,
                 corpus: Optional[SyntheticGraphCorpus] = None, *,
                 num_entries: Optional[int] = None,
                 ckpts: Optional[MemoryCheckpointStore] = None,
                 embed_fn: Optional[Callable] = None,
                 feature_store: Optional[SharedFeatureStore] = None,
                 num_classes: Optional[int] = None,
                 conf_threshold: float = 0.6, label_temp: float = 20.0,
                 agreement_k: int = 8, agreement_overfetch: int = 4,
                 builder_k: int = 8, centroid_sample: int = 256,
                 seed_labels: bool = True, seed_conf: float = 0.5,
                 device="cuda"):
        self.server, self.corpus = server, corpus
        self.ckpts, self.embed_fn = ckpts, embed_fn
        self.device = resolve_device(device)
        if corpus is None and num_entries is None:
            num_entries = getattr(server, "num_entries", None)
        if corpus is None and num_entries is None:
            raise ValueError("MakerRuntime needs a corpus or num_entries "
                             "(trainer-less serving runs only the "
                             "checkpoint-free makers)")
        self.num_nodes = (corpus.num_nodes if corpus is not None
                          else num_entries)
        self.num_classes = (num_classes if num_classes is not None
                            else corpus.num_clusters if corpus is not None
                            else 1)
        self.conf_threshold = conf_threshold
        self.label_temp = label_temp
        self.agreement_k = agreement_k
        self.agreement_overfetch = agreement_overfetch
        self.builder_k = builder_k
        self.centroid_sample = centroid_sample
        self.feature_store = feature_store or SharedFeatureStore(
            self.num_nodes,
            max(builder_k, corpus.neighbors_per_node
                if corpus is not None else builder_k))
        if seed_labels and feature_store is None and corpus is not None:
            # the semi-supervised ground state (§4.2): the corpus's noisy
            # labeled subset at a low confidence, which makers can out-vote
            lab = np.asarray(corpus.labeled_ids)
            if lab.size:
                self.feature_store.update_labels(
                    lab, corpus.noisy_labels[lab].astype(np.int32),
                    np.full(lab.size, seed_conf, np.float32))
        self.trainer_step = 0           # published by the trainer loop
        self._ckpt_lock = threading.Lock()
        self._ckpt_cache: Optional[tuple] = None     # (step, params)
        # label_mining's per-class centroids, cached until the loaded
        # checkpoint changes; the hit counter is the observability hook
        self._centroid_cache: Optional[tuple] = None
        self.centroid_cache_hits = 0
        self.jobs: List[MakerJob] = []
        server.attach_maker_runtime(self)

    def load_ckpt(self):
        """(step, params) of the latest checkpoint, (None, None) before
        the first: one copy for every job, re-read only when the
        published step moved."""
        if self.ckpts is None:
            return None, None
        with self._ckpt_lock:
            latest = self.ckpts.latest_step()
            if latest is None:
                return None, None
            if self._ckpt_cache is None or self._ckpt_cache[0] != latest:
                self._ckpt_cache = self.ckpts.load_latest()
            return self._ckpt_cache

    # -- the four maker steps: (params, ckpt_step, ids) -> rows -----------

    def _node_tokens(self, ids: np.ndarray) -> torch.Tensor:
        if self.corpus is None:
            raise ValueError("this maker kind needs a corpus")
        toks = self.corpus.node_tokens(ids)[:, :-1]
        return torch.from_numpy(np.ascontiguousarray(toks)).to(self.device)

    def _embed(self, params, ids: np.ndarray) -> np.ndarray:
        if self.embed_fn is None:
            raise ValueError("this maker kind needs embed_fn (and ckpts)")
        return _host(self.embed_fn(params, self._node_tokens(ids)))

    def _embedding_refresh_step(self, params, step: int, ids) -> int:
        self.server.update(ids, self._embed(params, ids), src_step=step)
        return ids.size

    def _label_mining_step(self, params, step: int, ids) -> Optional[int]:
        """§4.2.1 online label mining, asynchronous form: the class
        read-out is the labeled-centroid classifier over the bank's rows,
        fetched through the server. The centroids are cached and
        recomputed only when the loaded checkpoint step changes: the
        read-back is a ``centroid_sample``-row lookup, paid once per
        published checkpoint (``centroid_cache_hits`` counts those
        saved)."""
        fs = self.feature_store
        cached = self._centroid_cache
        if cached is not None and cached[0] == step:
            cent = cached[1]
            self.centroid_cache_hits += 1
        else:
            lab = fs.labeled_ids(cap=self.centroid_sample)
            if lab.size == 0:
                return None             # idle: nothing to calibrate against
            lab_emb = self.server.lookup(lab,
                                         trainer_step=self.trainer_step)
            lab_cls = fs.labels()[lab]
            cent = np.zeros((self.num_classes, lab_emb.shape[1]),
                            np.float32)
            for c in range(self.num_classes):
                m = lab_cls == c
                if m.any():
                    cent[c] = lab_emb[m].mean(0)
            self._centroid_cache = (step, cent)
        emb = self._embed(params, ids)
        probs = torch.softmax(torch.from_numpy(
            np.ascontiguousarray(emb @ cent.T * self.label_temp)),
            dim=-1).numpy()
        conf = probs.max(-1)
        pred = probs.argmax(-1).astype(np.int32)
        conf = np.where(conf >= self.conf_threshold, conf, 0.0)
        return fs.update_labels(ids, pred, conf)

    def _graph_agreement_step(self, params, step: int, ids
                              ) -> Optional[int]:
        """§4.2.2, asynchronous form: candidates from the server's
        nn_search over the live bank (over-fetched, so that enough LABELED
        ones survive the mask), the vote from the shared feature store."""
        labels = self.feature_store.labels()    # one snapshot a step
        if not (labels >= 0).any():
            return None                 # idle: an unlabeled bank can't vote
        emb = self._embed(params, ids)
        kfetch = self.agreement_k * self.agreement_overfetch
        scores, nids = self.server.nn_search(emb, k=kfetch)
        nbr_labels = labels[np.maximum(nids, 0)]
        ok = ((nids >= 0) & (nbr_labels >= 0)
              & (nids != np.asarray(ids)[:, None]))
        # the electorate: the agreement_k NEAREST labeled survivors (the
        # lists are sorted); the over-fetch only buys labeled candidates
        ok &= np.cumsum(ok, axis=1) <= self.agreement_k
        pred, conf = vote_agreement_labels(
            scores, nids, np.where(ok, nbr_labels, -1),
            num_classes=self.num_classes)
        return self.feature_store.update_labels(ids, _host(pred),
                                                _host(conf))

    def _graph_builder_step(self, params, step: int, ids) -> int:
        """Dynamic graph discovery over the live bank; needs no
        checkpoint. Self-exclusion rides the server's exclude_ids path."""
        q = self.server.lookup(ids, trainer_step=self.trainer_step)
        scores, nids = self.server.nn_search(
            q, k=self.builder_k, exclude_ids=np.asarray(ids)[:, None])
        return self.feature_store.update_neighbors(
            ids, nids, np.maximum(scores, 0.0))

    # -- registry and lifecycle --------------------------------------------

    def register(self, kind: str, *, batch_size: int = 64,
                 min_period_s: float = 0.0,
                 node_slice: Optional[np.ndarray] = None,
                 name: Optional[str] = None) -> MakerJob:
        """One maker job (not started). ``node_slice`` splits a node range
        across several jobs of one kind; ``min_period_s`` paces this job
        on its own."""
        if kind not in self.MAKER_KINDS:
            raise ValueError(f"unknown maker kind {kind!r} "
                             f"(want one of {self.MAKER_KINDS})")
        step_fn = getattr(self, f"_{kind}_step")
        needs_ckpt = kind != "graph_builder"
        if needs_ckpt and (self.ckpts is None or self.embed_fn is None):
            raise ValueError(f"maker {kind!r} needs ckpts and embed_fn")
        nodes = (np.arange(self.num_nodes) if node_slice is None
                 else np.asarray(node_slice))
        if nodes.size == 0:
            raise ValueError(f"maker {kind!r} got an empty node slice "
                             "(more jobs than nodes?)")
        job = MakerJob(self, name or f"{kind}{len(self.jobs)}", kind,
                       step_fn, nodes, batch_size=batch_size,
                       min_period_s=min_period_s, needs_ckpt=needs_ckpt)
        self.jobs.append(job)
        return job

    def start(self) -> "MakerRuntime":
        for j in self.jobs:
            if not j.is_alive():
                j.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        for j in self.jobs:
            j.stop_event.set()
        for j in self.jobs:
            j.join(timeout=timeout_s)

    def stats(self) -> Dict[str, Dict]:
        """Per-maker counters by job name: ``maker_steps`` (batches
        computed; crashed ones count under ``errors``), ``rows_written``
        (writes the gate accepted), and the checkpoint staleness:
        ``ckpt_version_lag`` (trainer steps of lag summed over the run),
        ``ckpt_version_lag_last`` and ``last_ckpt_step``."""
        out = {}
        for j in self.jobs:
            out[j.name] = {
                "kind": j.kind,
                "maker_steps": j.steps,
                "rows_written": j.rows_written,
                "ckpt_version_lag": j.lag_sum,
                "ckpt_version_lag_last": j.last_lag,
                "last_ckpt_step": (j.ckpt_steps_used[-1]
                                   if j.ckpt_steps_used else -1),
                "errors": j.errors,
                "error": repr(j.last_error) if j.last_error else None,
            }
        return out


def format_maker_stats(stats: Dict[str, Dict]) -> List[str]:
    """One printable line per maker, the one formatter every entry point
    shares, so that a crashing maker shows wherever its counters do."""
    lines = []
    for name, s in stats.items():
        line = (f"maker {name}: steps={s['maker_steps']} "
                f"rows_written={s['rows_written']} "
                f"ckpt_version_lag={s['ckpt_version_lag']} "
                f"(last={s['ckpt_version_lag_last']}, "
                f"ckpt={s['last_ckpt_step']})")
        if s.get("errors"):
            line += f" ERRORS={s['errors']} last={s['error']}"
        lines.append(line)
    return lines


@dataclass
class AsyncRunResult:
    """What ``run_async_training`` returns. ``step_times``: the train
    core's seconds a step, ending in a device sync (JAX's);
    ``loop_times``: each whole loop step's, the server's lookup, lazy
    gradient and push included."""
    losses: List[float]
    reg_losses: List[float]
    step_times: List[float]
    maker_refreshes: int
    mean_staleness: float
    final_params: dict = field(repr=False, default=None)
    server: KBClient = field(repr=False, default=None)
    maker_stats: Dict[str, Dict] = field(default_factory=dict)
    runtime: "MakerRuntime" = field(repr=False, default=None)
    loop_times: List[float] = field(default_factory=list)


def _publish(ckpts: MemoryCheckpointStore, step: int, params) -> None:
    """Save a copy of ``params``: the optimizer updates them in place, and
    a maker must read weights that do not change under it."""
    ckpts.save(step, tree_map(lambda p: p.detach().clone(), params))


def run_async_training(model: LM, corpus: SyntheticGraphCorpus, *,
                       steps: int = 50, batch_size: int = 16,
                       num_makers: int = 1, maker_batch: int = 64,
                       ckpt_period: int = 5, lr: float = 1e-3,
                       reg_weight: Optional[float] = None,
                       lazy_update: bool = True,
                       use_makers: bool = True,
                       makers: Optional[Sequence[str]] = None,
                       maker_period_s: float = 0.0,
                       trainer_push: bool = False,
                       kb_backend: str = "cuda",
                       coalesce: bool = True,
                       kb_client: Optional[KBClient] = None,
                       seed: int = 0, device="cuda") -> AsyncRunResult:
    """Asynchronous CARLS training on one device: the trainer loop and a
    ``MakerRuntime`` fleet, all clients of one coalescing server whose
    bank (``corpus.num_nodes`` x d_model, zeros) runs on ``kb_backend``
    (``cuda``, the kernels; ``dense``; ``sharded``, one logical shard).

    ``makers`` selects maker kinds by name (each registered once, paced by
    ``maker_period_s``); by default ``num_makers`` embedding-refresh jobs
    over disjoint node slices. ``trainer_push=True`` also pushes the
    trainer's pooled sample embeddings to the bank each step. Parameters
    come from ``model.init`` on a generator seeded ``seed``; AdamW at a
    constant ``lr``, no weight decay.

    ``kb_client``: an already-connected bank client, typically a
    ``RemoteKnowledgeBank`` or ``KBRouter`` (``launch/train.py
    --kb-connect``), used INSTEAD of an in-process server: every trainer
    and maker bank call then goes over that client's transport, and the
    final close() drops only this process's connection, never the remote
    bank. Its rows must cover the corpus and its width be d_model."""
    dev = resolve_device(device)
    cfg = model.cfg
    opt = AdamW(lr=constant_lr(lr), weight_decay=0.0)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    opt_state = opt.init(params)
    train_core, embed_fn = make_async_train_fns(model, opt,
                                                reg_weight=reg_weight)
    if kb_client is not None:
        if kb_client.num_entries < corpus.num_nodes:
            raise ValueError(
                f"remote bank holds {kb_client.num_entries} entries but the "
                f"corpus has {corpus.num_nodes} nodes")
        if kb_client.dim != cfg.d_model:
            raise ValueError(f"remote bank dim {kb_client.dim} != model "
                             f"d_model {cfg.d_model}")
        server = kb_client
    else:
        server = KnowledgeBankServer(
            corpus.num_nodes, cfg.d_model, backend=kb_backend,
            lazy_lr=cfg.carls.lazy_lr, zmax=cfg.carls.outlier_zmax,
            lazy_update=lazy_update, coalesce=coalesce, device=dev)
    ckpts = MemoryCheckpointStore()
    _publish(ckpts, 0, params)
    runtime = None
    if use_makers:
        runtime = MakerRuntime(server, corpus, ckpts=ckpts,
                               embed_fn=embed_fn, device=dev)
        if makers is None:
            for i, s in enumerate(np.array_split(
                    np.arange(corpus.num_nodes), num_makers)):
                runtime.register("embedding_refresh", batch_size=maker_batch,
                                 node_slice=s, name=f"maker{i}",
                                 min_period_s=maker_period_s)
        else:
            for kind in makers:
                runtime.register(kind, batch_size=maker_batch,
                                 min_period_s=maker_period_s)
        runtime.start()

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(seed + 1)
    losses, regs, times, loop_times = [], [], [], []
    try:
        for step in range(steps):
            t_loop = time.perf_counter()
            if runtime is not None:
                runtime.trainer_step = step
            batch = corpus.batch(rng, batch_size)
            nbr_emb = server.lookup(batch["neighbor_ids"], trainer_step=step)
            tb = {k: tensor(v) for k, v in batch.items()}
            nbr = tensor(nbr_emb)
            sync()
            t0 = time.perf_counter()
            with record_function("carls.train_core"):
                params, opt_state, pooled, gn, metrics = train_core(
                    params, opt_state, tb, nbr)
                sync()
            times.append(time.perf_counter() - t0)
            server.lazy_grad(batch["neighbor_ids"], _host(gn))
            if trainer_push:
                server.update(batch["sample_ids"], _host(pooled),
                              src_step=step)
            losses.append(float(metrics["loss"]))
            regs.append(float(metrics.get("graph_reg", 0.0)))
            if (step + 1) % ckpt_period == 0:
                with record_function("carls.publish"):
                    _publish(ckpts, step + 1, params)
            loop_times.append(time.perf_counter() - t_loop)
    finally:        # a failed step must not leak maker or server threads
        if runtime is not None:
            runtime.stop(timeout_s=5.0)
        server.close()
    return AsyncRunResult(
        losses=losses, reg_losses=regs, step_times=times,
        maker_refreshes=(sum(j.steps for j in runtime.jobs)
                         if runtime else 0),
        mean_staleness=server.mean_staleness,
        final_params=params, server=server,
        maker_stats=runtime.stats() if runtime else {},
        runtime=runtime, loop_times=loop_times)
