"""Scale-out Knowledge-Bank serving: a consistent-hash partitioned fleet of
bank servers behind one ``KBClient``-shaped router — now self-healing.

A copy of ``repro.core.kb_router`` (numpy only), so that the port runs
without the JAX package. The ring is the JAX package's bit for bit, its
placement of ids ``0 .. vnodes - 1`` on partition 0 included, so that a
fleet mixing members and routers of both packages routes every id alike.

After the transport layer (``kb_protocol`` / ``kb_transport``) every
deployment still funneled all traffic into ONE ``KnowledgeBankServer``, so
aggregate QPS was capped by a single dispatcher and a single device's
memory. This module is the paper's "millions of users" shape (§2: bank
services scale horizontally like DynamicEmbedding's sharded servers): the
id space is split across N independent partition servers and a ``KBRouter``
— the same duck-type as the concrete server — fans every client call out
over the existing ``Transport`` seam, so trainers and makers scale out
without a code change:

- ``PartitionMap``: a consistent-hash ring (``vnodes`` virtual nodes per
  partition, splitmix64 point hashing — deterministic across processes, no
  ``PYTHONHASHSEED`` anywhere) assigns every global id an owning partition
  plus a dense LOCAL rank within it, so partition ``p`` hosts a bank of
  exactly ``counts[p]`` rows. Ring stability is the reason for the ring:
  adding/removing a partition moves only ~1/P of the ids, and every moved
  id lands on the added partition (tests/test_kb_router.py and
  tests/test_torch_router.py prove both).
- ``KBRouter``: point ops (lookup / update / lazy_grad) split each batch by
  owning partition, issue the per-partition sub-requests concurrently, and
  re-assemble results in caller order — a batch that lands wholly in one
  partition takes a no-copy fast path. ``nn_search`` fans out to ALL
  partitions with per-partition ``k``-shortlists and merges hierarchically
  (the ``ShardedIVFIndex`` math one level up). ``stats`` /
  ``table_snapshot`` aggregate.

Fleet operations (fail-over + live resharding) sit on two invariants:

1. **Every state-changing op is teed to the partition's standby under a
   per-partition slot lock, AFTER the primary acknowledged it.** "State-
   changing" includes ``lookup`` — a bank lookup applies and clears pending
   lazy-grad caches, so a standby that skipped lookups would diverge.
   The slot lock makes the standby's write tail a prefix of the primary's
   arrival order, so at promotion the standby holds exactly the
   acknowledged history (an op whose primary ack was lost was never teed
   and is re-issued by the client's at-least-once retry — the same
   duplication contract ``SocketTransport`` reconnects already impose).
   Promotion (``_promote_locked``) drains the tail, swaps the standby in,
   stamps it with ``PromoteRequest`` so its handshake label matches its
   new role, and re-issues the failed request once. Partitions can also
   hold a pool of COLD spares (``add_spare``): the moment a promotion
   empties the standby slot, the next spare is filled from the new
   primary (still under the slot lock) and attached as the fresh standby,
   so the fleet heals back to primary+standby and survives a SECOND
   failure without an operator in the loop.
2. **Resharding never renumbers a live member's physical rows.** Growing
   P -> P+1 ( ``reshard`` ) moves only the ids the ring moves — all onto
   the new member — by streaming every per-row leaf (fp32 table, version,
   grad accumulators, EMA, int8 scale/offset side-cars) bit-identically
   through ``ExportRows``/``ImportRows``. Old members keep serving reads
   from the frozen routing snapshot throughout the copy; writes mark a
   dirty mask; cutover takes ALL slot locks, re-copies dirty∩moved, and
   atomically swaps in a new ``_Routing``. Moved rows stay physically
   present ("retired") in their old member — ``nn_search`` over-fetches by
   the retired count and masks winners the routing no longer assigns
   there, so results stay bit-compatible with a single server.

Fail-fast remains the no-standby behavior: a dead partition without a
standby raises ``KBPartitionDownError`` naming it — but ONLY for requests
owning rows there; the rest of the fleet keeps serving.

``connect_kb`` is the launcher entry point: a single ``host:port`` gives a
plain ``RemoteKnowledgeBank``, a comma list gives a router over one
``SocketTransport`` per partition (handshake-verified: each server's
advertised partition label and row count must match the ring's), and a
``host:port|sbhost:sbport`` element attaches a standby to that partition.
"""
from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.kb_protocol import (AttachSpareRequest,
                                          ExportRowsRequest, FlushRequest,
                                          ImportRowsRequest, LazyGradRequest,
                                          LookupRequest, NNSearchRequest,
                                          PromoteRequest, ProtocolError,
                                          RemoteKBError, SnapshotRequest,
                                          StatsRequest, Transport,
                                          UpdateRequest)


class KBPartitionDownError(RuntimeError):
    """A partition's transport failed mid-request and no standby could take
    over. Carries ``partition`` (its index) so supervisors can restart
    exactly the dead member; other partitions are unaffected and the
    router keeps serving ids they own."""

    def __init__(self, partition: int, message: str):
        super().__init__(f"kb partition {partition} is down: {message}")
        self.partition = partition


def _mix64(x) -> np.ndarray:
    """splitmix64 finalizer over uint64 — the ring's point hash. Pure
    integer mixing with numpy wraparound semantics, so every process (and
    every run) agrees on id placement; Python's ``hash`` would not."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x


class PartitionMap:
    """Deterministic id-space partitioning via a consistent-hash ring.

    Every global id ``g`` hashes to a point; the first partition vnode
    clockwise owns it. ``owner[g]`` / ``local[g]`` are precomputed dense
    arrays so the router's per-batch split is two gathers, and
    ``global_ids(p)`` inverts the mapping for snapshot re-assembly and
    nn-result translation. Stability: partitions project ``vnodes`` points
    each from hashes of ``(p, v)`` only, so growing P -> P+1 adds points
    without moving the existing ones — ids change owner only where a new
    point cut an arc, i.e. ~1/(P+1) of them, all onto the new partition."""

    def __init__(self, num_entries: int, num_partitions: int, *,
                 vnodes: int = 64):
        if num_entries <= 0 or num_partitions <= 0:
            raise ValueError("num_entries and num_partitions must be >= 1")
        self.num_entries = int(num_entries)
        self.num_partitions = int(num_partitions)
        self.vnodes = int(vnodes)
        pv = np.arange(num_partitions * vnodes, dtype=np.uint64)
        # point hash of (partition, vnode); partitions claim disjoint id
        # ranges of the mix input so their point sets are independent
        points = _mix64((pv // np.uint64(vnodes)) << np.uint64(32)
                        | (pv % np.uint64(vnodes)))
        order = np.argsort(points, kind="stable")
        self._points = points[order]
        self._point_owner = (pv // np.uint64(vnodes)).astype(np.int32)[order]
        idh = _mix64(np.arange(num_entries, dtype=np.uint64))
        idx = np.searchsorted(self._points, idh, side="left")
        self.owner = self._point_owner[idx % len(self._points)]
        self.counts = np.bincount(self.owner,
                                  minlength=num_partitions).astype(np.int64)
        if (self.counts == 0).any():
            empty = int(np.flatnonzero(self.counts == 0)[0])
            raise ValueError(
                f"partition {empty} owns 0 of {num_entries} ids — too many "
                f"partitions (or too few vnodes) for this bank size")
        # dense local rank: partition p's rows are its global ids in
        # ascending order, so a partition bank holds exactly counts[p] rows
        self.local = np.zeros(num_entries, dtype=np.int64)
        self._global_ids: List[np.ndarray] = []
        for p in range(num_partitions):
            g = np.flatnonzero(self.owner == p)
            self.local[g] = np.arange(g.size, dtype=np.int64)
            self._global_ids.append(g)

    def global_ids(self, p: int) -> np.ndarray:
        """Ascending global ids owned by partition ``p`` (its local id
        ``i`` is row ``global_ids(p)[i]``)."""
        return self._global_ids[p]

    def owner_of(self, ids) -> np.ndarray:
        ids = np.asarray(ids).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_entries):
            raise ValueError(
                f"ids outside [0, {self.num_entries}) cannot be routed")
        return self.owner[ids]

    def to_local(self, ids) -> np.ndarray:
        return self.local[np.asarray(ids).reshape(-1)]


class _Routing(NamedTuple):
    """One immutable routing snapshot. Readers grab ``router._routing``
    ONCE per op and never see a half-applied reshard; the cutover swaps
    the whole object under every slot lock. ``members`` is the only
    element mutated in place (standby promotion replaces one entry, under
    that slot's lock) — geometry arrays never change after construction.

    ``member_gids[p]`` is member ``p``'s FIXED physical layout: global id
    of each of its rows, set at the member's birth and never renumbered.
    ``retired[p]`` lists global ids member ``p`` still physically holds
    but no longer owns (they moved to a later member in a reshard)."""

    owner: np.ndarray           # (num_entries,) owning member per global id
    local: np.ndarray           # (num_entries,) physical row in the owner
    members: List[Transport]    # live primary transport per member
    member_gids: Tuple[np.ndarray, ...]   # physical row -> global id
    retired: Tuple[np.ndarray, ...]       # held-but-unowned global ids


class _RoutingChanged(Exception):
    """A mutating sub-request observed that the routing snapshot it was
    built against has been swapped (reshard cutover won the race). The op
    retries wholesale against the fresh snapshot — partial re-execution is
    at-least-once, the same contract transport reconnects already have."""


class _ReshardState:
    """Dirty tracking for the concurrent phase of a reshard: mutating ops
    flag the global ids they touched so cutover re-copies exactly the
    moved rows written after (or during) the bulk copy."""

    def __init__(self, num_entries: int, moved: np.ndarray):
        self.moved_mask = np.zeros(num_entries, dtype=bool)
        self.moved_mask[moved] = True
        self.dirty = np.zeros(num_entries, dtype=bool)


class KBRouter:
    """``KBClient`` over N partition servers reached through ``Transport``s.

    ``transports[p]`` must be partition ``p`` of the ring: its advertised
    ``num_entries`` must equal ``counts[p]``, and when the handshake
    carries a partition label (``serve.py --kb-join p/N`` sets one) it must
    read ``"p/N"`` — a shuffled endpoint list fails construction instead of
    silently serving every row from the wrong partition.

    Standbys attach after construction (``attach_standby``); resharding
    (``reshard``) grows the fleet by one member under live traffic."""

    def __init__(self, transports: Sequence[Transport], *,
                 pmap: Optional[PartitionMap] = None, vnodes: int = 64):
        members = list(transports)
        if not members:
            raise ValueError("KBRouter needs at least one partition")
        P = len(members)
        total = sum(int(t.num_entries) for t in members)
        self.pmap = pmap or PartitionMap(total, P, vnodes=vnodes)
        if self.pmap.num_partitions != P:
            raise ValueError(f"PartitionMap has {self.pmap.num_partitions} "
                             f"partitions, got {P} transports")
        for p, t in enumerate(members):
            want = int(self.pmap.counts[p])
            if int(t.num_entries) != want:
                raise ValueError(
                    f"partition {p} serves {t.num_entries} rows, ring "
                    f"assigns {want} — endpoint list out of order, or the "
                    f"server was sized without this ring?")
            label = getattr(t, "partition", "")
            if label and label != f"{p}/{P}":
                raise ValueError(
                    f"endpoint {p} identifies as partition {label!r}, "
                    f"expected '{p}/{P}' — endpoint list out of order?")
        self.num_entries = self.pmap.num_entries
        self.dim = int(members[0].dim)
        for p, t in enumerate(members):
            if int(t.dim) != self.dim:
                raise ValueError(f"partition {p} dim {t.dim} != {self.dim}")
        empty = np.empty(0, dtype=np.int64)
        self._routing = _Routing(
            owner=self.pmap.owner, local=self.pmap.local, members=members,
            member_gids=tuple(self.pmap.global_ids(p) for p in range(P)),
            retired=tuple(empty for _ in range(P)))
        self.router_metrics = {"fanouts": 0, "single_partition_fastpath": 0,
                               "partition_requests": 0, "promotions": 0,
                               "standbys_lost": 0, "spares_attached": 0,
                               "reshards": 0, "reshard_rows_moved": 0,
                               "reshard_dirty_rows": 0}
        self._mlock = threading.Lock()
        # one slot lock per member: serializes mutating ops against that
        # member so the standby tee preserves primary arrival order and a
        # reshard cutover can exclude ALL writers by taking every lock
        self._slot_locks = [threading.Lock() for _ in range(P)]
        self._standbys: List[Optional[Transport]] = [None] * P
        # cold spares per member, attached-and-filled on promotion
        self._spares: List[deque] = [deque() for _ in range(P)]
        self._tails: List[deque] = [deque() for _ in range(P)]
        self._seqs = [0] * P
        self._reshard_lock = threading.Lock()
        self._reshard_state: Optional[_ReshardState] = None
        self._pool = (ThreadPoolExecutor(max_workers=P,
                                         thread_name_prefix="kb-router")
                      if P > 1 else None)
        self._maker_runtime = None
        self._final_stats: Optional[dict] = None
        self._closed = False

    @property
    def _transports(self) -> List[Transport]:
        """Live primary transports (back-compat accessor)."""
        return self._routing.members

    # -- fail-over plumbing ------------------------------------------------

    def _bump(self, key: str, n: int = 1) -> None:
        with self._mlock:
            self.router_metrics[key] += n

    def _drain_tail_locked(self, p: int) -> bool:
        """Replay the sequence-numbered write tail onto ``p``'s standby
        (slot lock held). Any standby failure demotes it — the primary is
        still healthy, so the op itself succeeds; we just lose the spare."""
        sb = self._standbys[p]
        tail = self._tails[p]
        while tail:
            _seq, msg = tail[0]
            try:
                sb.request(msg)
            except (RemoteKBError, ConnectionError, OSError,
                    RuntimeError):
                self._standbys[p] = None
                tail.clear()
                self._bump("standbys_lost")
                try:
                    sb.close()
                except Exception:
                    pass
                return False
            tail.popleft()
        return True

    def _tee_locked(self, p: int, msg) -> None:
        """Append an acknowledged mutating op to ``p``'s tail and drain it
        to the standby (slot lock held). Runs AFTER the primary ack, so
        the standby history is always a prefix of the acknowledged one."""
        if self._standbys[p] is None:
            return
        self._seqs[p] += 1
        self._tails[p].append((self._seqs[p], msg))
        self._drain_tail_locked(p)

    def _promote_locked(self, p: int, err: BaseException) -> None:
        """Slot lock held, primary just failed. Drain the tail, swap the
        standby in as the new primary, stamp its partition label, and
        close the corpse. No standby (or a standby that dies during the
        drain/stamp) -> ``KBPartitionDownError``: fail-fast is the
        fallback, not silent data loss."""
        sb = self._standbys[p]
        down = KBPartitionDownError(p, f"{type(err).__name__}: {err}")
        if sb is None:
            raise down from err
        if not self._drain_tail_locked(p):
            raise down from err
        r = self._routing
        old = r.members[p]
        r.members[p] = sb
        self._standbys[p] = None
        self._tails[p].clear()
        try:
            sb.request(PromoteRequest(f"{p}/{len(r.members)}"))
        except RemoteKBError:
            raise
        except (ConnectionError, OSError, RuntimeError) as e:
            raise KBPartitionDownError(
                p, f"standby died during promotion: "
                   f"{type(e).__name__}: {e}") from e
        self._bump("promotions")
        try:
            old.close()
        except Exception:
            pass
        self._reattach_spare_locked(p)

    def _reattach_spare_locked(self, p: int) -> None:
        """Slot lock held, the standby slot just emptied (promotion):
        fill the next cold spare from the NEW primary and install it as
        the fresh standby, so a second failure can promote again. A spare
        that dies during its fill is dropped (``standbys_lost``) and the
        next one is tried; a fill failing because the new primary is
        ALREADY dead just drains spares onto a doomed member — the next
        request discovers the corpse either way, and losing spares is
        safe where losing acknowledged writes is not."""
        while self._spares[p]:
            spare = self._spares[p].popleft()
            try:
                self._attach_standby_locked(p, spare)
            except (RemoteKBError, ConnectionError, OSError, RuntimeError):
                self._bump("standbys_lost")
                try:
                    spare.close()
                except Exception:
                    pass
                continue
            self._bump("spares_attached")
            return

    # -- fan-out plumbing --------------------------------------------------

    def _request(self, p: int, msg):
        """One READ sub-request to member ``p``; on transport failure,
        promote the standby (if any) and retry on the new primary.
        ``RemoteKBError`` means the partition is alive and EXECUTED — it
        passes through untouched."""
        for _attempt in range(4):
            t = self._routing.members[p]
            try:
                return t.request(msg)
            except RemoteKBError:
                raise
            except (ConnectionError, OSError, RuntimeError) as e:
                # TransportError is a ConnectionError; KBServerClosedError
                # (the in-process analogue of a dead peer) is a RuntimeError
                with self._slot_locks[p]:
                    if self._routing.members[p] is t:
                        self._promote_locked(p, e)
                # promoted (by us or a racing op) — loop onto new primary
                err = e
        raise KBPartitionDownError(
            p, f"still failing after promotion: "
               f"{type(err).__name__}: {err}") from err

    def _mut_request(self, p: int, msg, routing: _Routing):
        """One MUTATING sub-request to member ``p`` under its slot lock:
        primary executes and acks, THEN the op is teed to the standby and
        flagged in the reshard dirty mask. Raises ``_RoutingChanged`` if a
        reshard cutover swapped the snapshot this op was split against —
        the caller re-splits and retries against the fresh routing."""
        with self._slot_locks[p]:
            if self._routing is not routing:
                raise _RoutingChanged()
            t = routing.members[p]
            try:
                resp = t.request(msg)
            except RemoteKBError:
                raise
            except (ConnectionError, OSError, RuntimeError) as e:
                self._promote_locked(p, e)
                # at-least-once re-issue: the failed request may or may
                # not have executed on the dead primary; the promoted
                # standby never saw it (tee happens after ack)
                try:
                    resp = self._routing.members[p].request(msg)
                except RemoteKBError:
                    raise
                except (ConnectionError, OSError, RuntimeError) as e2:
                    raise KBPartitionDownError(
                        p, f"promoted standby failed too: "
                           f"{type(e2).__name__}: {e2}") from e2
            self._tee_locked(p, msg)
            rs = self._reshard_state
            if rs is not None:
                ids = getattr(msg, "ids", None)
                if ids is None:
                    # flush touches every row with pending grads — mark
                    # all moved rows dirty rather than guess which
                    rs.dirty |= rs.moved_mask
                else:
                    lids = np.asarray(ids).reshape(-1)
                    rs.dirty[routing.member_gids[p][lids]] = True
            return resp

    def _fanout_on(self, routing: _Routing, requests: Dict[int, object],
                   *, mutating: bool) -> Dict[int, object]:
        """Issue per-partition sub-requests concurrently; every sub-request
        runs to completion before the first error re-raises, so one dead
        partition never cancels writes the others already accepted.
        ``_RoutingChanged`` outranks other errors — the caller's retry
        against fresh routing subsumes them."""
        with self._mlock:
            self.router_metrics["fanouts"] += 1
            self.router_metrics["partition_requests"] += len(requests)
            if len(requests) == 1:
                self.router_metrics["single_partition_fastpath"] += 1
        if mutating:
            def call(p):
                return self._mut_request(p, requests[p], routing)
        else:
            def call(p):
                return self._request(p, requests[p])
        parts = sorted(requests)
        if self._pool is None or len(parts) == 1:
            return {p: call(p) for p in parts}
        futs = {p: self._pool.submit(call, p) for p in parts}
        out, first_err, rechanged = {}, None, None
        for p in parts:
            try:
                out[p] = futs[p].result()
            except _RoutingChanged as e:
                rechanged = e
            except Exception as e:
                if first_err is None:
                    first_err = e
        if rechanged is not None:
            raise rechanged
        if first_err is not None:
            raise first_err
        return out

    def _split_on(self, routing: _Routing, flat_ids: np.ndarray):
        """(member -> positions into ``flat_ids``) for one batch."""
        if flat_ids.size and (int(flat_ids.min()) < 0
                              or int(flat_ids.max()) >= self.num_entries):
            raise ValueError(
                f"ids outside [0, {self.num_entries}) cannot be routed")
        owner = routing.owner[flat_ids]
        return {int(p): np.flatnonzero(owner == p)
                for p in np.unique(owner)}

    # -- the five KB ops ---------------------------------------------------

    def lookup(self, ids, *, trainer_step: int = 0) -> np.ndarray:
        # lookup MUTATES the bank (applies + clears pending lazy grads),
        # so it rides the mutating path: slot-locked, teed, retried on
        # reshard cutover
        ids = np.asarray(ids)
        flat = ids.reshape(-1)
        while True:
            r = self._routing
            split = self._split_on(r, flat)
            reqs = {p: LookupRequest(r.local[flat[pos]], int(trainer_step))
                    for p, pos in split.items()}
            try:
                resps = self._fanout_on(r, reqs, mutating=True)
            except _RoutingChanged:
                continue
            break
        if len(split) == 1:
            (p,) = split
            return resps[p].values.reshape(*ids.shape, -1)
        out = np.empty((flat.size, self.dim), np.float32)
        for p, pos in split.items():
            out[pos] = resps[p].values
        return out.reshape(*ids.shape, -1)

    def update(self, ids, values, *, src_step: int = 0) -> None:
        ids = np.asarray(ids)
        flat = ids.reshape(-1)
        values = np.asarray(values).reshape(flat.size, -1)
        while True:
            r = self._routing
            split = self._split_on(r, flat)
            try:
                self._fanout_on(
                    r, {p: UpdateRequest(r.local[flat[pos]], values[pos],
                                         int(src_step))
                        for p, pos in split.items()}, mutating=True)
                return
            except _RoutingChanged:
                continue

    def lazy_grad(self, ids, grads) -> None:
        ids = np.asarray(ids)
        flat = ids.reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(flat.size, -1)
        while True:
            r = self._routing
            split = self._split_on(r, flat)
            try:
                self._fanout_on(
                    r, {p: LazyGradRequest(r.local[flat[pos]], grads[pos])
                        for p, pos in split.items()}, mutating=True)
                return
            except _RoutingChanged:
                continue

    def flush(self) -> None:
        while True:
            r = self._routing
            try:
                self._fanout_on(r, {p: FlushRequest()
                                    for p in range(len(r.members))},
                                mutating=True)
                return
            except _RoutingChanged:
                continue

    def nn_search(self, queries, k: int, *, mode: Optional[str] = None,
                  exclude_ids=None) -> Tuple[np.ndarray, np.ndarray]:
        """Hierarchical top-k over all members. Each member answers its
        local top-``min(k+E+retired_p, rows_p)`` WITHOUT any exclusion
        pushed down (exclusions are global ids; members know local ones);
        the over-fetch covers both banned ids (E) and retired rows the
        member still physically holds — masking both post-merge and
        taking a stable top-k reproduces single-server exclude semantics
        across partition boundaries."""
        queries = np.asarray(queries)
        B = queries.shape[0]
        excl = (None if exclude_ids is None
                else np.asarray(exclude_ids, np.int32).reshape(B, -1))
        E = 0 if excl is None else excl.shape[1]
        r = self._routing
        reqs = {p: NNSearchRequest(
                    queries,
                    min(int(k) + E + len(r.retired[p]),
                        len(r.member_gids[p])),
                    mode, None)
                for p in range(len(r.members))}
        resps = self._fanout_on(r, reqs, mutating=False)
        all_scores, all_ids = [], []
        for p in sorted(resps):
            resp = resps[p]
            gl = r.member_gids[p]
            lids = np.asarray(resp.ids)
            gids = np.where(lids >= 0, gl[np.clip(lids, 0, None)], -1)
            scores = np.asarray(resp.scores)
            if len(r.retired[p]):
                # rows this member holds but no longer owns: their live
                # copy is on a later member, so drop the stale one here
                stale = ((gids >= 0)
                         & (r.owner[np.clip(gids, 0, None)] != p))
                scores = np.where(stale, -np.inf, scores)
                gids = np.where(stale, -1, gids)
            all_scores.append(scores)
            all_ids.append(gids)
        scores = np.concatenate(all_scores, axis=1)
        gids = np.concatenate(all_ids, axis=1)
        if excl is not None:
            banned = ((gids[:, :, None] == excl[:, None, :])
                      & (excl[:, None, :] >= 0)).any(-1)
            scores = np.where(banned, -np.inf, scores)
            gids = np.where(banned, -1, gids)
        # stable sort keeps partition-0-first order on ties, matching the
        # engine's own stable top-k tie-break discipline
        order = np.argsort(-scores, axis=1, kind="stable")[:, :int(k)]
        return (np.take_along_axis(scores, order, axis=1),
                np.take_along_axis(gids, order, axis=1))

    # -- fleet operations --------------------------------------------------

    def _check_standby_geometry(self, p: int, transport: Transport,
                                role: str) -> None:
        """Shared admission checks for standbys and spares: partition
        exists, row count matches the primary's physical layout, dim
        matches, and any handshake label agrees with the slot."""
        r = self._routing
        P = len(r.members)
        if not 0 <= p < P:
            raise ValueError(f"no partition {p} in a {P}-member fleet")
        rows = len(r.member_gids[p])
        if int(transport.num_entries) != rows:
            raise ValueError(
                f"{role} for partition {p} serves {transport.num_entries} "
                f"rows, primary holds {rows}")
        if int(transport.dim) != self.dim:
            raise ValueError(
                f"{role} dim {transport.dim} != {self.dim}")
        label = getattr(transport, "partition", "")
        if label and label != f"{p}/{P}":
            raise ValueError(
                f"{role} identifies as partition {label!r}, "
                f"expected '{p}/{P}' (or unlabeled)")

    def _attach_standby_locked(self, p: int, transport: Transport, *,
                               fill: bool = True,
                               chunk_rows: int = 1024) -> None:
        """Install ``transport`` as ``p``'s standby (slot lock HELD).
        With ``fill`` the standby is first made bit-identical by
        streaming every row's leaves from the current primary — the held
        slot lock guarantees no write slips between the fill and the
        first tee."""
        rows = len(self._routing.member_gids[p])
        if fill:
            primary = self._routing.members[p]
            for lo in range(0, rows, chunk_rows):
                lids = np.arange(lo, min(lo + chunk_rows, rows),
                                 dtype=np.int64)
                leaves = primary.request(ExportRowsRequest(lids)).leaves
                transport.request(ImportRowsRequest(lids, leaves))
        self._tails[p] = deque()
        self._seqs[p] = 0
        self._standbys[p] = transport

    def attach_standby(self, p: int, transport: Transport, *,
                       fill: bool = True, chunk_rows: int = 1024) -> None:
        """Attach ``transport`` as partition ``p``'s standby. With
        ``fill`` (the default) the standby is first made bit-identical to
        the primary by streaming every row's full leaf state through
        ``ExportRows``/``ImportRows`` — under the slot lock, so no write
        can slip between the fill and the first tee. A ``--replica-of``
        standby arrives pre-filled from its own boot copy; the re-fill
        closes the gap between its boot and this attach."""
        self._check_standby_geometry(p, transport, "standby")
        with self._slot_locks[p]:
            if self._standbys[p] is not None:
                raise ValueError(f"partition {p} already has a standby")
            self._attach_standby_locked(p, transport, fill=fill,
                                        chunk_rows=chunk_rows)

    def add_spare(self, p: int, transport: Transport) -> None:
        """Queue ``transport`` in partition ``p``'s COLD spare pool.
        Spares receive no fill and no tee while queued; the router fills
        one (from the then-current primary, under the slot lock) the
        moment a promotion empties the standby slot — see
        ``_reattach_spare_locked``. Geometry is validated on admission so
        a mis-sized spare fails here, not during an emergency. Admission
        also stakes a claim on the spare itself (the v4 ``AttachSpare``
        record — works identically over TCP and in-process): the server
        remembers which slot reserved it, so a second router claiming the
        same bank for a DIFFERENT slot is refused here rather than
        discovering the double-booking during a promotion."""
        self._check_standby_geometry(p, transport, "spare")
        claim = f"{p}/{len(self._routing.members)}"
        try:
            transport.request(AttachSpareRequest(claim))
        except (RemoteKBError, ProtocolError) as e:
            raise ValueError(f"spare for partition {p} refused the "
                             f"claim: {e}") from e
        with self._slot_locks[p]:
            self._spares[p].append(transport)

    def standby_status(self) -> List[bool]:
        """Which members currently have a live standby attached."""
        return [sb is not None for sb in self._standbys]

    def spare_status(self) -> List[int]:
        """Cold (queued, unattached) spares per member."""
        return [len(q) for q in self._spares]

    def reshard(self, new_transport: Transport, *,
                chunk_rows: int = 1024) -> dict:
        """Grow the fleet P -> P+1 under live traffic. The ring moves
        ~1/(P+1) of the ids, all onto the new member (``PartitionMap``'s
        stability property); this streams exactly those rows — every leaf,
        bit-identically — in two phases:

        1. CONCURRENT bulk copy: reads keep serving from the frozen old
           routing; mutating ops proceed and mark a dirty mask.
        2. EXCLUSIVE cutover: take ALL slot locks (no writer in flight),
           re-copy dirty∩moved, swap in the new ``_Routing`` atomically.
           In-flight mutating ops that split against the old snapshot see
           ``_RoutingChanged`` and retry against the new one.

        Old members keep their physical layout; moved rows are merely
        "retired" there (held, not owned). The new member must be sized
        exactly for the moved id set — boot it like a fresh fleet member
        with ``serve.py --kb-join P/(P+1)``."""
        with self._reshard_lock:
            r0 = self._routing
            P = len(r0.members)
            new_pmap = PartitionMap(self.num_entries, P + 1,
                                    vnodes=self.pmap.vnodes)
            moved = np.flatnonzero(new_pmap.owner != r0.owner)
            if not (new_pmap.owner[moved] == P).all():
                raise RuntimeError(
                    "ring stability violated: an id moved between "
                    "existing partitions during grow-by-one")
            if int(new_transport.num_entries) != moved.size:
                raise ValueError(
                    f"new member serves {new_transport.num_entries} rows, "
                    f"ring moves {moved.size} — size it with "
                    f"--kb-join {P}/{P + 1}")
            if int(new_transport.dim) != self.dim:
                raise ValueError(
                    f"new member dim {new_transport.dim} != {self.dim}")
            label = getattr(new_transport, "partition", "")
            if label and label != f"{P}/{P + 1}":
                raise ValueError(
                    f"new member identifies as partition {label!r}, "
                    f"expected '{P}/{P + 1}' (or unlabeled)")
            # dirty tracking on BEFORE the first export: any write landing
            # after this line is either seen by the copy or re-copied
            self._reshard_state = _ReshardState(self.num_entries, moved)
            dirty_recopied = 0
            try:
                new_local = new_pmap.local[moved]
                self._copy_moved(r0, moved, new_local, new_transport,
                                 chunk_rows, exclusive=False)
                # take every slot lock in index order (the one global
                # order all lock takers share — no deadlock)
                ordered = list(range(P))
                for p in ordered:
                    self._slot_locks[p].acquire()
                try:
                    rs = self._reshard_state
                    dirty = np.flatnonzero(rs.dirty & rs.moved_mask)
                    if dirty.size:
                        self._copy_moved(r0, dirty, new_pmap.local[dirty],
                                         new_transport, chunk_rows,
                                         exclusive=True)
                        dirty_recopied = int(dirty.size)
                    # new routing: moved ids re-home; everyone else keeps
                    # their old PHYSICAL rank (never bulk-assign local
                    # from new_pmap — it renumbers survivors)
                    owner = new_pmap.owner
                    local = r0.local.copy()
                    local[moved] = new_local
                    retired = tuple(
                        np.concatenate(
                            [r0.retired[p], moved[r0.owner[moved] == p]])
                        for p in range(P)) + (np.empty(0, np.int64),)
                    self._slot_locks.append(threading.Lock())
                    self._standbys.append(None)
                    self._spares.append(deque())
                    self._tails.append(deque())
                    self._seqs.append(0)
                    if self._pool is None:
                        self._pool = ThreadPoolExecutor(
                            max_workers=P + 1,
                            thread_name_prefix="kb-router")
                    self.pmap = new_pmap
                    self._routing = _Routing(
                        owner=owner, local=local,
                        members=list(r0.members) + [new_transport],
                        member_gids=r0.member_gids + (moved,),
                        retired=retired)
                finally:
                    for p in reversed(ordered):
                        self._slot_locks[p].release()
            finally:
                self._reshard_state = None
            self._bump("reshards")
            self._bump("reshard_rows_moved", int(moved.size))
            self._bump("reshard_dirty_rows", dirty_recopied)
            return {"moved": int(moved.size),
                    "dirty_recopied": dirty_recopied,
                    "partitions": P + 1}

    def _copy_moved(self, r0: _Routing, gids: np.ndarray,
                    dst_local: np.ndarray, new_transport: Transport,
                    chunk_rows: int, *, exclusive: bool) -> None:
        """Stream rows ``gids`` (with destination rows ``dst_local``) from
        their current owners into the new member, every leaf verbatim.
        In the exclusive phase we hold every slot lock, so exports go
        straight to the member transport — ``_request``'s promote path
        would deadlock on the lock we hold; a member dying inside the
        cutover window aborts the reshard instead."""
        src_owner = r0.owner[gids]
        for p in range(len(r0.members)):
            sel = np.flatnonzero(src_owner == p)
            for lo in range(0, sel.size, chunk_rows):
                pos = sel[lo:lo + chunk_rows]
                req = ExportRowsRequest(r0.local[gids[pos]])
                if exclusive:
                    leaves = r0.members[p].request(req).leaves
                else:
                    leaves = self._request(p, req).leaves
                new_transport.request(
                    ImportRowsRequest(dst_local[pos], leaves))

    # -- introspection / lifecycle ----------------------------------------

    def table_snapshot(self) -> np.ndarray:
        r = self._routing
        resps = self._fanout_on(r, {p: SnapshotRequest()
                                    for p in range(len(r.members))},
                                mutating=False)
        out = np.zeros((self.num_entries, self.dim), np.float32)
        for p, resp in resps.items():
            gl = r.member_gids[p]
            vals = np.asarray(resp.values)
            own = r.owner[gl] == p
            out[gl[own]] = vals[own]
        return out

    def stats(self) -> dict:
        """Fleet-wide aggregate with the single-server stats shape
        (summed counters, request-weighted staleness) plus a
        ``partitions`` list of the raw per-partition dicts and the
        router's own fan-out / fail-over counters."""
        if self._final_stats is not None:
            return self._final_stats
        r = self._routing
        resps = self._fanout_on(r, {p: StatsRequest()
                                    for p in range(len(r.members))},
                                mutating=False)
        per = [resps[p].stats for p in sorted(resps)]
        metrics: Dict[str, float] = {}
        for s in per:
            for key, v in s.get("metrics", {}).items():
                if isinstance(v, (int, float)):
                    metrics[key] = metrics.get(key, 0) + v
        served = max(sum(s.get("metrics", {}).get("rows_served", 0)
                         for s in per), 1)
        stale = sum(s.get("metrics", {}).get("staleness_sum", 0.0)
                    for s in per)
        dispatches = max(metrics.get("dispatches", 0), 1)
        maker_stats: Dict[str, Dict] = {}
        for p, s in enumerate(per):
            for name, ms in s.get("maker_stats", {}).items():
                maker_stats[f"p{p}/{name}" if len(per) > 1 else name] = ms
        # storage: extensive quantities sum across the fleet; bytes_per_row
        # is intensive, so recompute it resident-row-weighted (a mixed
        # fp32/int8 fleet reports the true blended cost)
        storage: Dict[str, object] = {}
        per_storage = [s["storage"] for s in per if "storage" in s]
        if per_storage:
            for key in ("bytes_resident", "resident_rows", "total_rows",
                        "cold_rows", "master_rows", "tier_faults",
                        "tier_spills"):
                storage[key] = sum(int(d.get(key, 0)) for d in per_storage)
            rows = max(int(storage["resident_rows"]), 1)
            table_bytes = sum(int(d.get("bytes_per_row", 0))
                              * int(d.get("resident_rows", 0))
                              for d in per_storage)
            storage["bytes_per_row"] = table_bytes // rows
            modes = {str(d.get("mode", "fp32")) for d in per_storage}
            storage["mode"] = (modes.pop() if len(modes) == 1 else "mixed")
        with self._mlock:
            router = dict(self.router_metrics)
        router["partitions"] = len(per)
        router["standbys"] = sum(sb is not None for sb in self._standbys)
        router["spares"] = sum(len(q) for q in self._spares)
        return {
            "metrics": metrics,
            "mean_staleness": stale / served,
            "coalescing_factor": metrics.get("requests", 0) / dispatches,
            "num_entries": int(self.num_entries),
            "dim": int(self.dim),
            "storage": storage,
            "maker_stats": maker_stats,
            "partitions": per,
            "router": router,
        }

    @property
    def metrics(self) -> dict:
        return self.stats()["metrics"]

    @property
    def mean_staleness(self) -> float:
        return self.stats()["mean_staleness"]

    @property
    def coalescing_factor(self) -> float:
        return self.stats()["coalescing_factor"]

    @property
    def maker_stats(self) -> dict:
        if self._maker_runtime is not None:
            return self._maker_runtime.stats()
        return self.stats().get("maker_stats", {})

    def attach_maker_runtime(self, runtime) -> None:
        self._maker_runtime = runtime

    def warmup(self, max_batch: int = 256) -> None:
        """No-op: kernel warm-up belongs to the processes hosting the engines
        (``serve.py`` warms each partition server before exposing it)."""

    def partition_slices(self) -> List[np.ndarray]:
        """Global ids per member — the affinity hook: a client working
        one slice keeps every batch on a single partition (the router's
        no-copy fast path) and the fleet load-balances by construction."""
        r = self._routing
        return [np.flatnonzero(r.owner == p)
                for p in range(len(r.members))]

    def close(self) -> None:
        """Close this client's connections (the partition servers keep
        serving others). Final stats snapshot first, best-effort — some
        partitions may already be gone."""
        if self._closed:
            return
        self._closed = True
        try:
            self._final_stats = self.stats()
        except Exception:
            self._final_stats = {"metrics": {}, "mean_staleness": 0.0,
                                 "coalescing_factor": 0.0, "maker_stats": {},
                                 "partitions": [], "router": {}}
        for t in (list(self._routing.members)
                  + [sb for sb in self._standbys if sb is not None]
                  + [sp for q in self._spares for sp in q]):
            try:
                t.close()
            except Exception:
                pass
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect_kb(spec: str, **kw):
    """Dial a bank from a ``--kb-connect`` spec. ``"host:port"`` returns a
    plain ``RemoteKnowledgeBank``; ``"host:p0,host:p1,..."`` returns a
    ``KBRouter`` whose endpoint ORDER is the partition order (each
    partition server's handshake label and row count are verified against
    the ring). A ``"host:p0|host:s0"`` element attaches ``host:s0`` as
    partition 0's standby (filled on attach, then kept in sync by the
    write tee); further ``|`` legs (``"host:p0|host:s0|host:c0|..."``)
    join partition 0's COLD spare pool over the wire (v4 ``AttachSpare``
    — geometry-checked and claimed on admission, filled only when a
    promotion empties the standby slot). Any ``|`` forces the router path
    even for one endpoint. Keyword args pass through to
    ``SocketTransport``."""
    from repro_torch.core.kb_transport import (RemoteKnowledgeBank,
                                               SocketTransport,
                                               parse_hostport)
    endpoints = [e.strip() for e in spec.split(",") if e.strip()]
    if not endpoints:
        raise ValueError(f"empty --kb-connect spec {spec!r}")
    if len(endpoints) == 1 and "|" not in endpoints[0]:
        host, port = parse_hostport(endpoints[0])
        return RemoteKnowledgeBank(host, port, **kw)
    transports: list = []
    standbys: Dict[int, object] = {}
    spares: Dict[int, list] = {}
    opened: list = []
    try:
        for p, ep in enumerate(endpoints):
            legs = [x.strip() for x in ep.split("|") if x.strip()]
            host, port = parse_hostport(legs[0])
            t = SocketTransport(
                host, port, expect_partition=f"{p}/{len(endpoints)}", **kw)
            transports.append(t)
            opened.append(t)
            if len(legs) >= 2:
                sh, sp = parse_hostport(legs[1])
                # a --replica-of standby already serves its ring label;
                # a plain spare serves "" — attach_standby validates both
                sb = SocketTransport(sh, sp, **kw)
                standbys[p] = sb
                opened.append(sb)
            for leg in legs[2:]:
                ch, cp = parse_hostport(leg)
                cold = SocketTransport(ch, cp, **kw)
                spares.setdefault(p, []).append(cold)
                opened.append(cold)
        router = KBRouter(transports)
        for p, sb in standbys.items():
            router.attach_standby(p, sb, fill=True)
        for p, pool in spares.items():
            for cold in pool:
                router.add_spare(p, cold)
        return router
    except BaseException:
        for t in opened:
            try:
                t.close()
            except Exception:
                pass
        raise
