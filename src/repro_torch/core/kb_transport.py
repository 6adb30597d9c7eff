"""TCP transport for the Knowledge-Bank protocol: cross-process clients of
one coalescing ``KnowledgeBankServer``.

A copy of ``repro.core.kb_transport`` (numpy and sockets only), so that
the port runs without the JAX package. The server half drives the port's
``KnowledgeBankServer`` (its ``enqueue_op`` and
``_Request.add_done_callback``); the client half needs no device.

This is the piece that makes CARLS *cross-platform* in the paper's sense —
trainers and knowledge makers in separate OS processes (or hosts) against a
single bank — rather than threads in one interpreter. Protocol v4 makes
every connection a true multiplexed channel:

- ``KBTransportServer``: an acceptor thread plus a reader/writer/executor
  thread trio per connection. The reader decodes protocol records and FEEDS
  THE EXISTING COALESCING QUEUE (``KnowledgeBankServer.enqueue_op``)
  without waiting, so requests from different processes — and from the
  in-process clients sharing the server — merge into the same batched
  device dispatches. Responses complete OUT OF ORDER: every frame carries a
  u64 request id, each finished op queues its response the moment the
  dispatcher completes it (``_Request.add_done_callback``), and a weighted
  per-connection scheduler drains the three priority lanes
  (control > point > bulk, weights 8:4:1) so a stats poll or a reshard
  control record overtakes a bulk ``nn_search`` payload. ``max_inflight``
  credits are PER LANE (``max_inflight_control`` / ``max_inflight_bulk``
  default to the point value), so a bulk flood can't starve control of
  pipelining budget; backpressure is TCP itself (the reader stops reading).
  ``cork_us`` adds an adaptive writer-side microbatch window: when more
  responses are in flight, the writer holds a batch up to that long and
  packs the small frames into ONE ``sendall`` — amortizing syscalls at
  high client counts, complementing TCP_NODELAY. ``scheduler="fifo"``
  delivers responses in request-arrival order instead (the v3 behavior,
  kept as the benchmark ablation baseline).
- ``SocketTransport``: the client half. Thread-safe and pipelined — callers
  register their request id in a pending MAP and send under one lock; a
  receiver thread resolves futures BY ID, so several maker threads sharing
  one connection neither serialize on each other's responses nor stall
  behind a slow bulk op. Connection loss strands only the UNANSWERED ids;
  each of those is re-issued (same id) after an automatic redial with
  capped exponential backoff plus jitter, up to ``max_retries`` times —
  ``reconnects`` and ``reissued`` are surfaced in client stats. Retries
  are AT-LEAST-ONCE (see the JAX package's docs/tuning.md for the
  ``lazy_grad`` caveat).
- ``RemoteKnowledgeBank``: the client stub. Same duck-type as the concrete
  server (``repro_torch.core.kb_protocol.KBClient``), numpy in / numpy out, so
  ``MakerRuntime``, the trainer loop, and the launch layer run unmodified
  against a bank in another process. Works over ``SocketTransport`` or the
  zero-copy ``InProcessTransport``.
"""
from __future__ import annotations

import random
import socket
import threading
import time
from collections import deque
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core.kb_protocol import (
    LANE_CONTROL, LANES, PROTOCOL_VERSION, AttachSpareRequest, ErrorResponse,
    ExportRowsRequest, FlushRequest, Hello, ImportRowsRequest,
    LazyGradRequest, LookupRequest, NNSearchRequest, NNSearchResponse,
    OkResponse, PromoteRequest, ProtocolError, RemoteKBError, RowsResponse,
    SnapshotRequest, StatsRequest, StatsResponse, Transport, UpdateRequest,
    ValuesResponse, Welcome, decode_message, decode_mux, frame_message,
    frame_message_mux, lane_of, read_frame_length)


class TransportError(ConnectionError):
    """The connection died before a response arrived. The request MAY have
    executed server-side — retries are at-least-once."""


def _read_frame(sock: socket.socket) -> bytes:
    """One length-prefixed frame off a blocking socket; raises
    ``TransportError`` on EOF / reset mid-frame."""
    prefix = _recv_exact(sock, 4)
    return _recv_exact(sock, read_frame_length(prefix))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            m = sock.recv_into(view[got:], n - got)
        except OSError as e:
            raise TransportError(f"connection lost mid-frame: {e}") from e
        if m == 0:
            raise TransportError("connection closed by peer")
        got += m
    return bytes(buf)


def _configure(sock: socket.socket, sock_buf: int) -> None:
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    # accepted sockets do NOT inherit the listener's SO_REUSEADDR; without
    # it a lingering connection pins the port and blocks re-exposing the
    # bank on the same endpoint (the restart/reconnect path)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    if sock_buf:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sock_buf)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, sock_buf)


def parse_hostport(spec: str) -> Tuple[str, int]:
    """``"HOST:PORT"`` -> (host, port) — the launchers' --listen/--connect
    argument format."""
    host, sep, port = spec.rpartition(":")
    if not sep or not host:
        raise ValueError(f"expected HOST:PORT, got {spec!r}")
    return host, int(port)


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

# weighted service quota per scheduler cycle, indexed by lane
# (control, point, bulk): under contention control gets 8 frames for every
# 4 point and 1 bulk — strict enough that control-plane ops overtake bulk
# payloads, weighted (not absolute) so a control flood can't starve bulk
_LANE_WEIGHTS = (8, 4, 1)
# cap frames packed into one sendall so a corked batch stays bounded
_MAX_BATCH_FRAMES = 64


class _Conn:
    """One accepted connection: reader decodes + starts, responses complete
    out of order, writer drains the per-lane ready queues by weighted
    priority. Three threads: a slow device op never stops the READER from
    feeding further requests into the coalescing window, and a slow
    synchronous op (snapshot / export / import, run on the EXECUTOR) never
    stops the WRITER from sending responses that are already done."""

    def __init__(self, tsrv: "KBTransportServer", sock: socket.socket,
                 addr) -> None:
        self.tsrv, self.sock, self.addr = tsrv, sock, addr
        self.cond = threading.Condition()
        # completed-response queues, one per lane: (rid, resp, credited)
        self.ready = [deque() for _ in LANES]
        self.served = [0, 0, 0]             # frames sent this quota cycle
        self.fifo_order: deque = deque()    # scheduler="fifo": arrival rids
        self.fifo_done: dict = {}           # rid -> (lane, resp, credited)
        self.open = 0                       # admitted, response not sent
        self.closing = False
        self.credits = {lane: threading.Semaphore(tsrv.lane_inflight[lane])
                        for lane in LANES}
        self.exec_cond = threading.Condition()
        self.exec_q: deque = deque()        # (rid, lane, thunk) FIFO
        self.reader = threading.Thread(target=self._read_loop, daemon=True,
                                       name=f"kb-conn-r-{addr}")
        self.writer = threading.Thread(target=self._write_loop, daemon=True,
                                       name=f"kb-conn-w-{addr}")
        self.executor = threading.Thread(target=self._exec_loop, daemon=True,
                                         name=f"kb-conn-x-{addr}")
        self.reader.start()
        self.writer.start()
        self.executor.start()

    # -- reader ------------------------------------------------------------

    def _read_loop(self) -> None:
        srv = self.tsrv.server
        try:
            hello = decode_message(_read_frame(self.sock))
            if not isinstance(hello, Hello):
                raise ProtocolError(f"expected Hello, got "
                                    f"{type(hello).__name__}")
            if hello.version != PROTOCOL_VERSION:
                # the version gate's compat contract: the handshake stays
                # PLAIN-framed (no mux header), so an old client's Hello
                # decodes here and this refusal is readable by it
                self.sock.sendall(frame_message(ErrorResponse(
                    "version_mismatch",
                    f"server speaks v{PROTOCOL_VERSION}, client sent "
                    f"v{hello.version}")))
                return
            if (hello.expect_partition
                    and hello.expect_partition != self.tsrv.partition):
                # a router dialing a shuffled endpoint list must fail the
                # handshake, not silently serve another partition's rows
                self.sock.sendall(frame_message(ErrorResponse(
                    "partition_mismatch",
                    f"client expects partition "
                    f"{hello.expect_partition!r}, this bank serves "
                    f"{self.tsrv.partition!r}")))
                return
            self.sock.sendall(frame_message(Welcome(
                PROTOCOL_VERSION, srv.engine.num_entries, srv.engine.dim,
                self.tsrv.partition)))
            while not self.tsrv._stop.is_set():
                raw = _read_frame(self.sock)
                try:
                    rid, lane, msg = decode_mux(raw)
                except TransportError:
                    raise
                except Exception as e:
                    # a frame we cannot attribute to any request id:
                    # report once on the reserved id 0, then hang up
                    self._admit(0)
                    self._complete(0, LANE_CONTROL,
                                   ErrorResponse(type(e).__name__, str(e)),
                                   credited=False)
                    return
                while not self.credits[lane].acquire(timeout=1.0):
                    # per-lane pipelining credit; poll so a dead writer
                    # (whose releases will never come) can't pin this thread
                    if self.tsrv._stop.is_set() or not self.writer.is_alive():
                        raise TransportError("connection writer exited")
                self._admit(rid)
                self._start(srv, rid, lane, msg)
        except TransportError:
            pass                                # client went away: normal
        except Exception as e:                  # handshake-phase garbage:
            try:                                # tell the peer, hang up
                self.sock.sendall(frame_message(ErrorResponse(
                    type(e).__name__, str(e))))
            except OSError:
                pass
        finally:
            with self.cond:
                self.closing = True
                self.cond.notify_all()
            with self.exec_cond:
                self.exec_cond.notify_all()

    def _admit(self, rid: int) -> None:
        with self.cond:
            self.open += 1
            if self.tsrv.scheduler == "fifo":
                self.fifo_order.append(rid)

    def _complete(self, rid: int, lane: int, resp, *,
                  credited: bool = True) -> None:
        """Queue a finished response for the writer. Runs on whichever
        thread finished the op (reader, executor, or the bank's
        dispatcher via ``add_done_callback``) — never blocks, never
        raises."""
        with self.cond:
            if self.tsrv.scheduler == "fifo":
                self.fifo_done[rid] = (lane, resp, credited)
            else:
                self.ready[lane].append((rid, resp, credited))
            self.cond.notify_all()

    def _defer(self, rid: int, lane: int, thunk) -> None:
        """Hand a synchronous (non-queued) op to the executor thread, so
        a multi-second snapshot blocks neither the reader nor responses
        that are already done."""
        with self.exec_cond:
            self.exec_q.append((rid, lane, thunk))
            self.exec_cond.notify()

    def _on_done(self, rid: int, lane: int, req, build) -> None:
        """Out-of-order completion seam: queue the response frame the
        moment the dispatcher finishes ``req`` — no thread parked in
        ``wait()`` per in-flight wire request."""
        def cb(r):
            if r.error is not None:
                resp = ErrorResponse(type(r.error).__name__, str(r.error))
            else:
                try:
                    resp = build(r)
                except Exception as e:
                    resp = ErrorResponse(type(e).__name__, str(e))
            self._complete(rid, lane, resp)
        req.add_done_callback(cb)

    def _start(self, srv, rid: int, lane: int, msg) -> None:
        """Begin executing ``msg``. KB ops enqueue into the server's
        coalescing queue HERE — before earlier responses are even
        written — which is exactly how cross-process requests land in the
        same coalescing window as in-process ones. Each admitted request
        completes exactly once, via ``_complete``."""
        with self.tsrv._metrics_lock:
            self.tsrv.requests_served += 1
        try:
            if isinstance(msg, LookupRequest):
                ids = np.asarray(msg.ids).reshape(-1)
                req = srv.enqueue_op("lookup", ids=ids, shape=ids.shape,
                                     meta=int(msg.trainer_step))
                self._on_done(rid, lane, req,
                              lambda r: ValuesResponse(r.result))
            elif isinstance(msg, UpdateRequest):
                ids = np.asarray(msg.ids).reshape(-1)
                req = srv.enqueue_op(
                    "update", ids=ids,
                    payload=np.asarray(msg.values).reshape(ids.size, -1),
                    meta=int(msg.src_step))
                self._on_done(rid, lane, req, lambda r: OkResponse())
            elif isinstance(msg, LazyGradRequest):
                ids = np.asarray(msg.ids).reshape(-1)
                req = srv.enqueue_op(
                    "lazy_grad", ids=ids,
                    payload=np.asarray(msg.grads,
                                       np.float32).reshape(ids.size, -1))
                self._on_done(rid, lane, req, lambda r: OkResponse())
            elif isinstance(msg, FlushRequest):
                req = srv.enqueue_op("flush")
                self._on_done(rid, lane, req, lambda r: OkResponse())
            elif isinstance(msg, NNSearchRequest):
                q = np.asarray(msg.queries)
                excl = (None if msg.exclude_ids is None
                        else np.asarray(msg.exclude_ids,
                                        np.int32).reshape(q.shape[0], -1))
                # bulk lane runs on the EXECUTOR via the public blocking
                # API: a pipelined burst of bulk searches then holds at
                # most ONE slot in the dispatcher queue at a time, so
                # point lookups drain between bulk executions instead of
                # behind the whole burst. The cost is that same-connection
                # pipelined searches no longer coalesce with each other —
                # the latency-vs-batching call the lane split is for.
                self._defer(rid, lane,
                            lambda: NNSearchResponse(*srv.nn_search(
                                q, int(msg.k), mode=msg.mode,
                                exclude_ids=excl)))
            elif isinstance(msg, StatsRequest):
                # counters snapshot at ARRIVAL (reader thread), response
                # queued immediately on the control lane — out-of-order
                # completion replaced the v3 eager-stats special case
                # (which observed eagerly but still DELIVERED in FIFO turn)
                self._complete(rid, lane, StatsResponse(srv.stats()))
            elif isinstance(msg, SnapshotRequest):
                self._defer(rid, lane,
                            lambda: ValuesResponse(srv.table_snapshot()))
            elif isinstance(msg, ExportRowsRequest):
                ids = np.asarray(msg.ids).reshape(-1)
                self._defer(rid, lane,
                            lambda: RowsResponse(srv.export_rows(ids)))
            elif isinstance(msg, ImportRowsRequest):
                ids = np.asarray(msg.ids).reshape(-1)
                leaves = msg.leaves
                self._defer(rid, lane,
                            lambda: (srv.import_rows(ids, leaves),
                                     OkResponse())[1])
            elif isinstance(msg, PromoteRequest):
                # control-plane: adopt the ring slot the router assigned —
                # applied NOW (reader thread), so the very next handshake
                # that pins this slot already succeeds; a promoted spare
                # is a serving member, so any spare claim is released
                self.tsrv.partition = msg.partition
                self.tsrv.spare_claim = ""
                self._complete(rid, lane, OkResponse())
            elif isinstance(msg, AttachSpareRequest):
                with self.tsrv._metrics_lock:   # claim is server-global
                    claimed = self.tsrv.spare_claim
                    if claimed and claimed != msg.partition:
                        resp = ErrorResponse(
                            "spare_conflict",
                            f"already claimed as spare for {claimed!r}, "
                            f"refused claim for {msg.partition!r}")
                    else:
                        self.tsrv.spare_claim = msg.partition
                        resp = OkResponse()
                self._complete(rid, lane, resp)
            else:
                raise ProtocolError(f"{type(msg).__name__} is not a "
                                    "request record")
        except Exception as e:          # enqueue refused (server closing,
            # bad record): deliver as this request's error response
            self._complete(rid, lane,
                           ErrorResponse(type(e).__name__, str(e)))

    # -- executor (synchronous slow ops) -----------------------------------

    def _exec_loop(self) -> None:
        while True:
            with self.exec_cond:
                while not self.exec_q and not self.closing:
                    self.exec_cond.wait(0.25)
                if not self.exec_q:
                    return              # closing and drained
                rid, lane, thunk = self.exec_q.popleft()
            try:
                resp = thunk()
            except Exception as e:
                resp = ErrorResponse(type(e).__name__, str(e))
            self._complete(rid, lane, resp)

    # -- writer ------------------------------------------------------------

    def _pop_locked(self):
        """Next (rid, lane, resp, credited) per the active scheduler, or
        None. ``cond`` must be held. ``scheduler="fifo"`` reproduces the
        v3 contract (responses in request-arrival order — the benchmark
        ablation baseline); ``"lanes"`` runs weighted round-robin over
        the priority lanes, FIFO within each lane."""
        if self.tsrv.scheduler == "fifo":
            if not self.fifo_order:
                return None
            entry = self.fifo_done.pop(self.fifo_order[0], None)
            if entry is None:
                return None             # head-of-line response not ready
            rid = self.fifo_order.popleft()
            self.open -= 1
            lane, resp, credited = entry
            return rid, lane, resp, credited
        for _ in range(2):              # second pass after a quota reset
            for lane in LANES:
                q = self.ready[lane]
                if q and self.served[lane] < _LANE_WEIGHTS[lane]:
                    self.served[lane] += 1
                    self.open -= 1
                    rid, resp, credited = q.popleft()
                    return rid, lane, resp, credited
            if not any(self.ready):
                return None
            self.served = [0, 0, 0]     # all ready lanes exhausted quota
        return None

    def _collect(self):
        """Block for the next batch of completed responses; None = writer
        should exit. Drains everything already ready into one batch
        (single sendall); with ``cork_us`` and further responses in
        flight, holds the batch up to that long so they share the send."""
        cork_s = self.tsrv.cork_us / 1e6
        out = []
        with self.cond:
            while not out:
                e = self._pop_locked()
                if e is not None:
                    out.append(e)
                    break
                if self.closing and (self.open == 0
                                     or self.tsrv._stop.is_set()):
                    return None
                self.cond.wait(0.25)
            while len(out) < _MAX_BATCH_FRAMES:
                e = self._pop_locked()
                if e is None:
                    if cork_s > 0 and self.open > 0:
                        # adaptive cork: only waits when more responses
                        # are actually in flight, at most once per batch
                        self.cond.wait(cork_s)
                        cork_s = 0.0
                        continue
                    break
                out.append(e)
        return out

    def _write_loop(self) -> None:
        try:
            while True:
                batch = self._collect()
                if batch is None:
                    return
                parts = []
                for rid, lane, resp, _credited in batch:
                    try:
                        parts.append(frame_message_mux(resp, rid, lane))
                    except Exception as e:  # the response itself won't
                        # encode (e.g. a snapshot past MAX_FRAME_BYTES):
                        # report per-request, serve on — never tear down
                        # the connection for one bad response
                        parts.append(frame_message_mux(
                            ErrorResponse(type(e).__name__, str(e)),
                            rid, lane))
                self.sock.sendall(b"".join(parts))
                with self.tsrv._metrics_lock:
                    self.tsrv.frames_sent += len(batch)
                    self.tsrv.sendalls += 1
                for _rid, lane, _resp, credited in batch:
                    if credited:
                        self.credits[lane].release()
        except OSError:
            pass                        # peer gone mid-response
        finally:
            try:
                self.sock.close()
            except OSError:
                pass
            self.tsrv._forget(self)

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class KBTransportServer:
    """Host a ``KnowledgeBankServer`` on a TCP endpoint.

    ``port=0`` binds an ephemeral port (read it back from ``.port``). The
    transport owns only sockets and threads — closing it never closes the
    underlying bank, so a server can be re-exposed or serve in-process
    clients after the listener goes away.

    Knobs (the JAX package's docs/tuning.md): ``max_inflight`` pipelining
    credits per connection PER LANE — ``max_inflight_control`` /
    ``max_inflight_bulk`` override the control / bulk lanes (None = same
    as ``max_inflight``);
    ``cork_us`` microseconds of adaptive writer-side corking (0 = off);
    ``scheduler`` is ``"lanes"`` (v4 weighted priority) or ``"fifo"``
    (v3-style arrival-order delivery, the ablation baseline);
    ``sock_buf`` bytes for SO_SNDBUF/SO_RCVBUF (0 = OS default);
    ``backlog`` for pending accepts. ``partition`` labels this bank's ring
    slot ("p/N", set by ``serve.py --kb-join``): it travels in every
    Welcome, and clients that pinned a slot via ``Hello.expect_partition``
    are refused on mismatch."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0, *,
                 max_inflight: int = 32,
                 max_inflight_control: Optional[int] = None,
                 max_inflight_bulk: Optional[int] = None,
                 cork_us: int = 0, scheduler: str = "lanes",
                 sock_buf: int = 0, backlog: int = 16, partition: str = ""):
        if scheduler not in ("lanes", "fifo"):
            raise ValueError(f"scheduler must be 'lanes' or 'fifo', "
                             f"got {scheduler!r}")
        self.server = server
        self.max_inflight = max_inflight
        self.lane_inflight = (int(max_inflight_control or max_inflight),
                              int(max_inflight),
                              int(max_inflight_bulk or max_inflight))
        self.cork_us = int(cork_us)
        self.scheduler = scheduler
        self.sock_buf = sock_buf
        self.partition = partition
        self.spare_claim = ""           # "p/N" once a router claimed us
        self._stop = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._metrics_lock = threading.Lock()
        self.connections_accepted = 0
        self.requests_served = 0
        self.frames_sent = 0            # responses written
        self.sendalls = 0               # send syscalls (corking packs
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(backlog)
        self.host, self.port = self._lsock.getsockname()[:2]
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True, name="kb-accept")
        self._acceptor.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._lsock.accept()
            except OSError:
                return                  # listener closed: shutting down
            _configure(sock, self.sock_buf)
            conn = _Conn(self, sock, addr)
            with self._conns_lock:
                if self._stop.is_set():
                    conn.close()
                    continue
                self._conns.add(conn)
                self.connections_accepted += 1

    def _forget(self, conn: "_Conn") -> None:
        with self._conns_lock:
            self._conns.discard(conn)

    @property
    def active_connections(self) -> int:
        with self._conns_lock:
            return len(self._conns)

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop accepting, hang up every connection, join the threads.
        In-flight requests already fed to the bank still complete on the
        bank's dispatcher; only their responses are dropped."""
        self._stop.set()
        try:
            # shutdown (not just close) wakes the acceptor blocked in
            # accept(); a bare close leaves the kernel socket LISTENing —
            # pinned by the in-flight accept syscall — so the port could
            # never be rebound
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        self._acceptor.join(timeout=timeout_s)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        for c in conns:
            c.reader.join(timeout=timeout_s)
            c.writer.join(timeout=timeout_s)
            c.executor.join(timeout=timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

# caller-assigned request ids (FaultyTransport's keyed schedules) live in
# their own id namespace so they can never collide with the transport's
# auto-allocated ids (which count up from 1; 0 is the reserved
# connection-error id)
_EXTERNAL_RID_BASE = 1 << 48


class _Future:
    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None

    def set(self, value=None, error=None):
        self.value, self.error = value, error
        self.event.set()

    def wait(self):
        self.event.wait()
        if self.error is not None:
            raise self.error
        return self.value


class _Live:
    """One live dialed connection: socket + the pending MAP of unanswered
    request ids + the receiver thread resolving futures BY ID (v4: server
    completion order is free). ``send_lock`` serializes [register id +
    sendall] so a frame can't hit the wire after the connection was marked
    dead; the receiver takes no lock on its hot path (dict get/pop are
    atomic under the GIL), so a sender blocked mid-sendall can never stall
    response draining."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.pending: Dict[int, _Future] = {}
        self.dead = False
        self.send_lock = threading.Lock()
        self.receiver: Optional[threading.Thread] = None


class SocketTransport:
    """Client half of the TCP transport. ``request`` is thread-safe and
    pipelined; reconnection is automatic with capped exponential backoff
    plus jitter — attempt ``a`` sleeps
    ``min(cap, base * 2**(a-1)) * uniform(0.5, 1.5)`` so a restarting
    server isn't hammered at a fixed cadence and a fleet of clients
    doesn't redial in lockstep — up to ``max_retries`` redials per
    request. A connection death strands exactly the UNANSWERED request
    ids (the pending map — an id whose response already arrived is
    resolved and never re-sent); each stranded request is re-issued with
    the SAME id on the next live connection and counted in ``reissued``.
    Retries are AT-LEAST-ONCE: a request whose connection died after the
    send may have executed — idempotent ops (lookup / update / nn_search /
    flush / snapshot / stats) are safe, a retried ``lazy_grad`` can
    double-cache one gradient batch (set ``max_retries=0`` to fail
    instead). ``expect_partition`` pins the handshake to one ring slot
    (see ``KBTransportServer``)."""

    def __init__(self, host: str, port: int, *, client_name: str = "",
                 connect_timeout_s: float = 10.0, max_retries: int = 3,
                 reconnect_backoff_s: float = 0.05,
                 reconnect_backoff_cap_s: float = 2.0, sock_buf: int = 0,
                 expect_partition: str = ""):
        self.host, self.port = host, port
        self.client_name = client_name
        self.connect_timeout_s = connect_timeout_s
        self.max_retries = max_retries
        self.reconnect_backoff_s = reconnect_backoff_s
        self.reconnect_backoff_cap_s = reconnect_backoff_cap_s
        self.sock_buf = sock_buf
        self.expect_partition = expect_partition
        self.reconnects = 0
        self.reissued = 0               # unanswered ids re-sent on redial
        self.partition = ""                 # set by the first handshake
        self._lock = threading.Lock()       # connection management
        self._id_lock = threading.Lock()    # rid allocation + counters
        self._next_rid = 1                  # 0 is the reserved error id
        self._live: Optional[_Live] = None
        self._closed = False
        self.num_entries = self.dim = 0     # set by the first handshake
        with self._lock:
            self._ensure_live()             # fail fast on a bad address

    # -- connection lifecycle (all under self._lock) -----------------------

    def _ensure_live(self) -> _Live:
        if self._closed:
            raise TransportError("transport is closed")
        if self._live is not None and not self._live.dead:
            return self._live
        if self._live is not None:
            self.reconnects += 1
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout_s)
        try:
            _configure(sock, self.sock_buf)
            sock.sendall(frame_message(Hello(PROTOCOL_VERSION,
                                             self.client_name,
                                             self.expect_partition)))
            welcome = decode_message(_read_frame(sock))
            if isinstance(welcome, ErrorResponse):
                raise ProtocolError(f"server refused handshake: "
                                    f"[{welcome.kind}] {welcome.message}")
            if not isinstance(welcome, Welcome):
                raise ProtocolError(f"expected Welcome, got "
                                    f"{type(welcome).__name__}")
            sock.settimeout(None)
        except BaseException:
            sock.close()
            raise
        self.num_entries, self.dim = welcome.num_entries, welcome.dim
        self.partition = welcome.partition
        live = _Live(sock)
        live.receiver = threading.Thread(target=self._recv_loop,
                                         args=(live,), daemon=True,
                                         name="kb-client-recv")
        live.receiver.start()
        self._live = live
        return live

    def _recv_loop(self, live: _Live) -> None:
        err: Optional[Exception] = None
        try:
            while True:
                rid, _lane, msg = decode_mux(_read_frame(live.sock))
                # lock-free pop: senders register ids under live.send_lock,
                # and taking no lock here means a sender blocked
                # mid-sendall can never stop response draining
                fut = live.pending.pop(rid, None)
                if fut is None:
                    if rid == 0 and isinstance(msg, ErrorResponse):
                        # connection-level error: the server could not
                        # attribute a frame to any request id
                        raise TransportError(
                            f"server protocol error: [{msg.kind}] "
                            f"{msg.message}")
                    raise ProtocolError(
                        f"response for unknown request id {rid}")
                fut.set(value=msg)
        except Exception as e:          # ANY decode/socket failure —
            err = (e if isinstance(e, TransportError)     # struct.error,
                   else TransportError(str(e)))   # bad dtype, unicode...
        finally:
            # ...must mark the connection dead and strand every UNANSWERED
            # future: _Future.wait() has no timeout, so a skipped cleanup
            # is a caller parked forever. send_lock excludes a concurrent
            # sender: either its id is already pending (stranded here) or
            # it sees dead=True and never sends. Stranded callers re-issue
            # their ids on the next live connection — see ``_request``.
            if err is None:
                err = TransportError("receiver exited")
            with live.send_lock:
                live.dead = True
                stranded = list(live.pending.values())
                live.pending.clear()
            for fut in stranded:        # NEVER leave a caller hanging
                fut.set(error=err)
            try:
                live.sock.close()
            except OSError:
                pass

    # -- the one public verb ----------------------------------------------

    def request(self, msg) -> NamedTuple:
        with self._id_lock:
            rid = self._next_rid
            self._next_rid += 1
        return self._request(msg, rid)

    def request_with_id(self, rid: int, msg) -> NamedTuple:
        """``request`` with a caller-assigned request id (namespaced so it
        can't collide with auto-allocated ids) — ``FaultyTransport``'s
        seam for keying fault schedules by the id actually stamped into
        the wire frames."""
        return self._request(msg, _EXTERNAL_RID_BASE + int(rid))

    def _request(self, msg, rid: int) -> NamedTuple:
        lane = lane_of(msg)
        frame = frame_message_mux(msg, rid, lane)
        sent_before = False
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                # capped exponential backoff + jitter: linear backoff kept
                # clients polling a down server at a fixed aggregate rate;
                # doubling with a cap backs off fast, the jitter de-syncs
                # a fleet that lost the server at the same instant
                base = min(self.reconnect_backoff_cap_s,
                           self.reconnect_backoff_s * (2 ** (attempt - 1)))
                time.sleep(base * random.uniform(0.5, 1.5))
            try:
                with self._lock:        # connection management only — the
                    live = self._ensure_live()  # blocking send happens
                fut = _Future()                 # outside this lock
                try:
                    with live.send_lock:
                        if live.dead:
                            raise TransportError("connection lost")
                        live.pending[rid] = fut
                        live.sock.sendall(frame)
                except BaseException:
                    live.pending.pop(rid, None)
                    raise
                if sent_before:
                    # this id went out before and was never answered —
                    # the re-issue the at-least-once contract allows
                    with self._id_lock:
                        self.reissued += 1
                sent_before = True
                resp = fut.wait()
            except (TransportError, OSError) as e:
                last = e
                continue                # redial-and-retry path
            if isinstance(resp, ErrorResponse):
                # the server EXECUTED and failed — retrying won't help
                raise RemoteKBError(f"[{resp.kind}] {resp.message}")
            return resp
        raise TransportError(
            f"kb request failed after {self.max_retries + 1} attempts to "
            f"{self.host}:{self.port}") from last

    def close(self) -> None:
        with self._lock:
            self._closed = True
            live, self._live = self._live, None
        if live is not None:
            try:
                live.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                live.sock.close()
            except OSError:
                pass
            if live.receiver is not None:
                live.receiver.join(timeout=5.0)


class FaultPlan:
    """Deterministic fault schedule for ``FaultyTransport`` — the
    injectable seam that lets tests and ``chip_smoke.py`` drive
    the router's fail-over paths without sleeps or real process kills.

    Requests through the wrapped transport(s) are assigned ids 0, 1, 2, ...
    by THIS plan (share one plan across transports for a global schedule),
    and every schedule below is keyed by that request id. Over a v4
    ``SocketTransport`` the plan's id is also stamped into the wire frame
    (``request_with_id``, in its own id namespace), so the id a schedule
    names IS the id on the wire:

    - ``kill_after_requests=k``: request id ``k`` and every later one
      raise ``TransportError`` without touching the wire — the transport
      is permanently dead, the SIGKILLed-server model.
    - ``drop_requests={i, ...}``: request id ``i`` is lost on the way
      IN — it never executes, then the failure surfaces as
      ``TransportError``.
    - ``drop_responses={i, ...}``: request id ``i`` EXECUTES on the inner
      transport, then its response is dropped — the lost-ack case, which
      is exactly the at-least-once hazard the retry contract covers.
    - ``delay_s`` + ``delay_requests``: sleep before forwarding those
      request ids (widening race windows deterministically).

    ``faults`` counts injected failures; ``requests`` counts everything
    scheduled."""

    def __init__(self, *, kill_after_requests: Optional[int] = None,
                 drop_requests=(), drop_responses=(),
                 delay_s: float = 0.0, delay_requests=()):
        self.kill_after_requests = kill_after_requests
        self.drop_requests = frozenset(drop_requests)
        self.drop_responses = frozenset(drop_responses)
        self.delay_s = delay_s
        self.delay_requests = frozenset(delay_requests)
        self.requests = 0
        self.faults = 0
        self._lock = threading.Lock()

    def next_index(self) -> int:
        with self._lock:
            i = self.requests
            self.requests += 1
            return i

    def count_fault(self) -> None:
        with self._lock:
            self.faults += 1


class FaultyTransport:
    """Wrap any ``Transport`` with a ``FaultPlan``. Works identically over
    ``InProcessTransport`` and ``SocketTransport`` — the router can't tell
    an injected ``TransportError`` from a real dead connection, which is
    the point: CI exercises promotion deterministically. Over a
    ``SocketTransport`` the plan's request id is forwarded as the wire
    request id (``request_with_id``), so drop/delay schedules are keyed by
    the id that actually frames the request."""

    def __init__(self, inner, plan: FaultPlan):
        self.inner = inner
        self.plan = plan

    def request(self, msg) -> NamedTuple:
        plan = self.plan
        i = plan.next_index()
        killed = (plan.kill_after_requests is not None
                  and i >= plan.kill_after_requests)
        if killed or i in plan.drop_requests:
            plan.count_fault()
            raise TransportError(
                f"injected fault: request {i} "
                f"{'killed' if killed else 'dropped'} by FaultPlan")
        if plan.delay_s and i in plan.delay_requests:
            time.sleep(plan.delay_s)
        if hasattr(self.inner, "request_with_id"):
            resp = self.inner.request_with_id(i, msg)
        else:
            resp = self.inner.request(msg)
        if i in plan.drop_responses:
            plan.count_fault()
            raise TransportError(
                f"injected fault: response {i} dropped by FaultPlan "
                "(request already executed)")
        return resp

    def close(self) -> None:
        self.inner.close()

    def __getattr__(self, name):        # num_entries / dim / partition ...
        return getattr(self.inner, name)


class RemoteKnowledgeBank:
    """Client stub with the concrete server's duck-type
    (``repro_torch.core.kb_protocol.KBClient``): numpy in / numpy out, blocking
    calls, ``trainer_step`` / ``src_step`` tags — so ``MakerRuntime`` jobs
    and the trainer loop run against another process's bank unchanged.

    Construct from an address (``RemoteKnowledgeBank("host", port)``), or
    from any ``Transport`` — ``InProcessTransport(server)`` gives the
    zero-copy in-process case of the same interface."""

    def __init__(self, transport, port: Optional[int] = None, **kw):
        if isinstance(transport, str):
            transport = SocketTransport(transport, port, **kw)
        self._t: Transport = transport
        self.num_entries = transport.num_entries
        self.dim = transport.dim
        self._maker_runtime = None
        self._final_stats: Optional[dict] = None

    # -- the five KB ops ---------------------------------------------------

    def lookup(self, ids, *, trainer_step: int = 0) -> np.ndarray:
        ids = np.asarray(ids)
        resp = self._t.request(LookupRequest(ids.reshape(-1),
                                             int(trainer_step)))
        return resp.values.reshape(*ids.shape, -1)

    def update(self, ids, values, *, src_step: int = 0) -> None:
        ids = np.asarray(ids)
        self._t.request(UpdateRequest(
            ids.reshape(-1), np.asarray(values).reshape(ids.size, -1),
            int(src_step)))

    def lazy_grad(self, ids, grads) -> None:
        ids = np.asarray(ids)
        self._t.request(LazyGradRequest(
            ids.reshape(-1),
            np.asarray(grads, np.float32).reshape(ids.size, -1)))

    def flush(self) -> None:
        self._t.request(FlushRequest())

    def nn_search(self, queries, k: int, *, mode: Optional[str] = None,
                  exclude_ids=None) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries)
        excl = (None if exclude_ids is None
                else np.asarray(exclude_ids,
                                np.int32).reshape(queries.shape[0], -1))
        resp = self._t.request(NNSearchRequest(queries, int(k), mode, excl))
        return resp.scores, resp.ids

    # -- introspection / lifecycle ----------------------------------------

    def table_snapshot(self) -> np.ndarray:
        return self._t.request(SnapshotRequest()).values

    def export_rows(self, ids) -> dict:
        """Full per-row engine state (every leaf, raw dtypes) — the
        replica warm-fill / resharding read primitive over the wire."""
        return self._t.request(
            ExportRowsRequest(np.asarray(ids).reshape(-1))).leaves

    def import_rows(self, ids, leaves: dict) -> None:
        self._t.request(ImportRowsRequest(np.asarray(ids).reshape(-1),
                                          dict(leaves)))

    def stats(self) -> dict:
        """The server's full stats dict (metrics, staleness, search stats,
        server-side maker stats), plus this client's own transport health
        under ``"transport"`` (``reconnects`` — how many times the
        connection was redialed; ``reissued`` — how many unanswered
        request ids were re-sent after a redial). After ``close`` this
        returns the final snapshot taken at close time."""
        if self._final_stats is not None:
            return self._final_stats
        stats = self._t.request(StatsRequest()).stats
        reconnects = getattr(self._t, "reconnects", None)
        if reconnects is not None:
            stats["transport"] = {
                "reconnects": int(reconnects),
                "reissued": int(getattr(self._t, "reissued", 0)),
            }
        return stats

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
        """Stats of the LOCALLY attached ``MakerRuntime`` when this process
        owns one (the maker-worker case), else the server-side makers'."""
        if self._maker_runtime is not None:
            return self._maker_runtime.stats()
        return self.stats().get("maker_stats", {})

    def attach_maker_runtime(self, runtime) -> None:
        self._maker_runtime = runtime

    def warmup(self, max_batch: int = 256) -> None:
        """No-op: kernel warm-up belongs to the process hosting the engine."""

    def close(self) -> None:
        """Close THIS client's connection (the bank keeps serving others).
        Snapshots final stats first so post-close reads of ``metrics`` /
        ``mean_staleness`` — e.g. a result summary — still work."""
        if self._final_stats is None:
            try:
                self._final_stats = self.stats()
            except Exception:
                self._final_stats = {"metrics": {}, "mean_staleness": 0.0,
                                     "coalescing_factor": 0.0,
                                     "maker_stats": {}}
        self._t.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
