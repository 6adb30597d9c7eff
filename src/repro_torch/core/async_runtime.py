"""Request-coalescing Knowledge-Bank server: the server side of
``repro.core.async_runtime`` (``:84-680``).

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
trainer gradients with no ordering guarantee).

``start_ann_refresher`` registers the IVF index maker
(``repro_torch.core.ann_index.IVFRefresher``), which takes its snapshots
under the engine lock that the dispatcher holds for every op; on the
sharded backend (pass ``backend=ShardedBackend(S)``) it rebuilds each
shard's sub-index on its own clock.

Not ported yet (ROADMAP Q1 items 2 and 3): the maker runtime and the row
export/import of the wire fleet.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import List, Optional

import numpy as np

from repro_torch.core.ann_index import IVFRefresher
from repro_torch.core.kb_engine import KBEngine


class KBServerClosedError(RuntimeError):
    """Raised by requests submitted after ``KnowledgeBankServer.close()``
    began: fail fast instead of hanging in ``_Request.wait()`` behind a
    dispatcher that is (or has finished) draining."""


class _Request:
    """One queued client call; ``event`` fires when ``result`` is ready.
    ``meta`` carries the op's step tag (lookup: trainer_step; update:
    src_step) so staleness accounting happens in execution order."""

    __slots__ = ("op", "ids", "payload", "k", "mode", "excl", "shape",
                 "meta", "event", "result", "error")

    def __init__(self, op, ids=None, payload=None, k=None, mode=None,
                 excl=None, shape=None, meta=0):
        self.op, self.ids, self.payload, self.k = op, ids, payload, k
        self.mode, self.excl, self.shape, self.meta = mode, excl, shape, meta
        self.event = threading.Event()
        self.result = None
        self.error = None

    def wait(self):
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self.result


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

    - lookup/lookup, lazy_grad/lazy_grad, nn/nn: always (lookups apply and
      clear pending caches idempotently, cache adds commute, searches are
      pure);
    - any other pair within {lookup, update, lazy_grad}: only when the id
      sets are DISJOINT;
    - flush / barrier / nn-vs-write: never.
    """
    if a.op == b.op and a.op in ("lookup", "lazy_grad", "nn"):
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
                 resident_rows: Optional[int] = None, device="cuda"):
        if engine is None:
            engine = KBEngine(num_entries, dim, backend=backend,
                              lazy_lr=lazy_lr, zmax=zmax,
                              lazy_update=lazy_update,
                              search_mode=search_mode, ann_nlist=ann_nlist,
                              ann_nprobe=ann_nprobe,
                              ann_stale_rows=ann_stale_rows, storage=storage,
                              resident_rows=resident_rows, device=device)
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

    def stats(self) -> dict:
        """Server metrics, the derived staleness and coalescing ratios, the
        engine's search counters and storage accounting, in the JAX
        server's keys (``maker_stats`` stays empty: no maker runtime
        yet), and the index maker's ``rebuilds`` (indexes published) and
        ``shard_rebuilds`` (sub-indexes re-clustered), 0 without one."""
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
                "storage": storage, "maker_stats": {},
                **self._ann_counts()}

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
            raise RuntimeError(
                f"KB dispatcher did not drain within {timeout_s}s "
                f"({len(stranded)} stranded requests failed)")
        self._dispatcher = None

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
        results equal the FIFO schedule's."""
        runs: List[List[_Request]] = []
        hoisted = 0
        for r in batch:
            if runs and _mergeable(runs[-1][0], r):
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
                    if i >= 0 and _mergeable(runs[i][0], r):
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
