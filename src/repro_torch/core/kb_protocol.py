"""The Knowledge-Bank wire protocol: typed records, binary numpy codec,
and the ``Transport`` seam between KB clients and the server.

A copy of ``repro.core.kb_protocol`` (numpy only), so that the port runs
without the JAX package. The records, their wire codes, the value codec
and the v4 mux framing are the same byte for byte: a frame written by
either package decodes in the other, and a client of one package talks to
a server of the other.

The paper's deployment shape (§2, Fig. 1) has model trainers and knowledge
makers on DIFFERENT platforms, all talking to one knowledge-bank service.
Everything a client can ask the bank — the ``KnowledgeBankServer`` surface:
``lookup`` / ``update`` / ``lazy_grad`` / ``flush`` / ``nn_search`` plus the
``stats`` / ``table_snapshot`` introspection calls — is expressed here as an
explicit, versioned protocol so the SAME maker or trainer code runs against
an in-process bank or a bank in another OS process:

- **Typed records** (``LookupRequest`` ... ``ErrorResponse``): one NamedTuple
  per message, fields declared once in ``_WIRE_SPECS``. The record set IS
  the protocol — adding/renaming a record or field is a version bump.
- **Binary codec** (``encode_message`` / ``decode_message``): length-prefixed
  frames; numpy arrays travel as (dtype, shape, raw buffer) — NO pickle
  anywhere, so a malicious peer can at worst send garbage numbers, never
  code. Scalars/strings/dicts use a small tagged-value encoding (dicts only
  appear in ``StatsResponse``).
- **``Transport``**: the client-side seam. ``request(record) -> record`` is
  the whole interface. ``InProcessTransport`` (here) is the zero-copy fast
  case — records dispatch straight onto a live ``KnowledgeBankServer``,
  arrays pass through untouched; ``SocketTransport``
  (``repro_torch.core.kb_transport``) is the same records over TCP.

Versioning rules (documented in the JAX package's docs/architecture.md):
a connection opens with ``Hello(version) -> Welcome(version,
num_entries, dim, partition)``;
the server refuses mismatched versions with an ``ErrorResponse`` (kind
``"version_mismatch"``) before serving anything. ``PROTOCOL_VERSION`` must
be bumped whenever a record, field, or codec byte changes meaning — there
is no negotiation, equality is the contract. v2 added partition metadata
to the handshake (``Hello.expect_partition`` / ``Welcome.partition``) for
the scale-out router (``repro_torch.core.kb_router``): a partitioned fleet
member advertises which ring slot it serves, and a client that expects a
specific slot is refused (kind ``"partition_mismatch"``) instead of
silently reading another partition's rows. v3 added the fleet-operations
control records: ``ExportRowsRequest`` / ``ImportRowsRequest`` stream full
per-row engine state (every leaf, bit-identical — the replica warm-fill and
resharding primitive) and ``PromoteRequest`` re-labels a standby's serving
ring slot when the router promotes it.

v4 makes every connection a multiplexed channel. After the handshake,
every frame carries a 9-byte mux header between the u32 length prefix and
the message body: a u64 **request id** (responses echo the request's id,
so the server may complete them OUT OF ORDER and the client matches by id
instead of FIFO position) and a u8 **priority lane** (2 bits used:
control > point > bulk — see ``lane_of``; the server's response scheduler
and per-lane inflight credits live in ``repro_torch.core.kb_transport``). The
HANDSHAKE frames themselves (``Hello`` / ``Welcome`` / a pre-``Welcome``
``ErrorResponse``) intentionally keep the v3 plain framing: that is the
version gate's compat contract — an old client's ``Hello`` still decodes,
and the ``version_mismatch`` refusal it gets back is still readable, so
mixed-version fleets fail loudly instead of desynchronizing on an
unparseable mux header. v4 also added ``AttachSpareRequest``, the wire
path for ``KBRouter.add_spare``: a router claims a cold spare's host over
TCP (the server refuses a second claim for a different slot with kind
``"spare_conflict"``; promotion clears the claim).
"""
from __future__ import annotations

import struct
from typing import Dict, NamedTuple, Optional, Protocol, Tuple

import numpy as np

PROTOCOL_VERSION = 4

# refuse absurd frames before allocating: a corrupt length prefix must fail
# fast, not OOM the server. 1 GiB comfortably fits any real snapshot.
MAX_FRAME_BYTES = 1 << 30

# priority lanes (v4): a 2-bit tag in every post-handshake frame. Lower
# value = higher priority in the server's weighted response scheduler, and
# each lane holds its own inflight credits so bulk can't starve control.
LANE_CONTROL, LANE_POINT, LANE_BULK = 0, 1, 2
LANES = (LANE_CONTROL, LANE_POINT, LANE_BULK)
LANE_NAMES = ("control", "point", "bulk")


class ProtocolError(RuntimeError):
    """Malformed frame, unknown record, or version mismatch."""


class RemoteKBError(RuntimeError):
    """The server executed the request and reported a failure
    (re-raised client-side from an ``ErrorResponse``)."""


# ---------------------------------------------------------------------------
# records — the protocol surface. Field ORDER is wire format; do not reorder
# without bumping PROTOCOL_VERSION.
# ---------------------------------------------------------------------------

class Hello(NamedTuple):
    """Connection opener; ``client`` is a free-form label for server logs.
    ``expect_partition`` ("" = any) pins the connection to one ring slot —
    a router dialing partition "2/4" must not land on "3/4" because an
    endpoint list was shuffled; the server refuses the mismatch."""
    version: int
    client: str
    expect_partition: str


class Welcome(NamedTuple):
    """Handshake reply: the bank's geometry, so clients need no side-channel
    config (``RemoteKnowledgeBank.num_entries`` / ``dim`` come from here).
    ``partition`` is the serving ring slot ("p/N"; "" = unpartitioned)."""
    version: int
    num_entries: int
    dim: int
    partition: str


class LookupRequest(NamedTuple):
    ids: np.ndarray                 # flat int ids; client reshapes results
    trainer_step: int               # staleness tag (server metrics)


class UpdateRequest(NamedTuple):
    ids: np.ndarray
    values: np.ndarray              # (ids.size, dim)
    src_step: int                   # checkpoint step that produced the rows


class LazyGradRequest(NamedTuple):
    ids: np.ndarray
    grads: np.ndarray               # (ids.size, dim)


class FlushRequest(NamedTuple):
    pass


class NNSearchRequest(NamedTuple):
    queries: np.ndarray             # (B, dim)
    k: int
    mode: Optional[str]             # None = server default; "exact" | "ivf"
    exclude_ids: Optional[np.ndarray]   # (B, E) int32, -1 = no-op


class StatsRequest(NamedTuple):
    pass


class SnapshotRequest(NamedTuple):
    pass


class ExportRowsRequest(NamedTuple):
    """Read the FULL per-row state (every engine leaf, raw dtypes) for
    ``ids`` — the replica warm-fill / resharding read primitive. The reply
    is a ``RowsResponse`` whose leaves round-trip bit-identically through
    ``ImportRowsRequest`` on a same-config engine."""
    ids: np.ndarray                 # flat global ids


class ImportRowsRequest(NamedTuple):
    """Scatter previously-exported rows into the serving engine (standby
    fill, reshard landing). ``leaves`` is the ``RowsResponse.leaves`` dict
    verbatim."""
    ids: np.ndarray
    leaves: dict                    # {leaf name: np.ndarray}


class PromoteRequest(NamedTuple):
    """Control record: the router promoted this (standby) server — adopt
    ``partition`` as the serving ring slot so future handshakes that pin
    the slot succeed against it."""
    partition: str                  # "p/N" ring slot label


class AttachSpareRequest(NamedTuple):
    """Control record (v4): a router claims this server as partition
    ``partition``'s COLD spare — the wire path for ``KBRouter.add_spare``,
    so spares can join a fleet over TCP instead of only in-process.
    Geometry is validated router-side at admission (same checks as the
    in-process path); the server's job is exclusivity: a second claim for
    a DIFFERENT slot is refused (``ErrorResponse`` kind
    ``"spare_conflict"``), a re-claim of the same slot is idempotent, and
    a subsequent ``PromoteRequest`` clears the claim (the spare became a
    serving member)."""
    partition: str                  # "p/N" ring slot being claimed


class OkResponse(NamedTuple):
    pass


class RowsResponse(NamedTuple):
    leaves: dict                    # {leaf name: np.ndarray}, raw dtypes


class ValuesResponse(NamedTuple):
    values: np.ndarray              # lookup rows / table snapshot


class NNSearchResponse(NamedTuple):
    scores: np.ndarray
    ids: np.ndarray


class StatsResponse(NamedTuple):
    stats: dict                     # str keys; numbers / strings / sub-dicts


class ErrorResponse(NamedTuple):
    kind: str                       # exception class name or protocol kind
    message: str


# wire code -> record class. Codes are permanent once assigned (append-only;
# reusing a code is a silent corruption, renumbering is a version bump).
_WIRE_SPECS: Dict[int, type] = {
    1: Hello, 2: Welcome,
    10: LookupRequest, 11: UpdateRequest, 12: LazyGradRequest,
    13: FlushRequest, 14: NNSearchRequest, 15: StatsRequest,
    16: SnapshotRequest, 17: ExportRowsRequest, 18: ImportRowsRequest,
    19: PromoteRequest,
    20: OkResponse, 21: ValuesResponse, 22: NNSearchResponse,
    23: StatsResponse, 24: ErrorResponse, 25: RowsResponse,
    26: AttachSpareRequest,
}
_WIRE_CODES = {cls: code for code, cls in _WIRE_SPECS.items()}

# request record -> default priority lane. Control-plane ops (stats,
# promote/attach, the reshard export/import stream) overtake point ops,
# which overtake bulk payloads (nn fan-outs, full-table snapshots).
_LANE_OF = {
    StatsRequest: LANE_CONTROL, PromoteRequest: LANE_CONTROL,
    AttachSpareRequest: LANE_CONTROL, ExportRowsRequest: LANE_CONTROL,
    ImportRowsRequest: LANE_CONTROL,
    LookupRequest: LANE_POINT, UpdateRequest: LANE_POINT,
    LazyGradRequest: LANE_POINT, FlushRequest: LANE_POINT,
    NNSearchRequest: LANE_BULK, SnapshotRequest: LANE_BULK,
}


def lane_of(msg) -> int:
    """The priority lane a request travels (and its response returns) on.
    Unlisted records default to the point lane."""
    return _LANE_OF.get(type(msg), LANE_POINT)


# ---------------------------------------------------------------------------
# value codec — tagged, recursive, pickle-free
# ---------------------------------------------------------------------------

_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


def _enc_value(out: list, v) -> None:
    if v is None:
        out.append(b"N")
    elif isinstance(v, (bool, np.bool_)):
        out.append(b"B1" if v else b"B0")
    elif isinstance(v, (int, np.integer)):
        out.append(b"I" + _I64.pack(int(v)))
    elif isinstance(v, (float, np.floating)):
        out.append(b"F" + _F64.pack(float(v)))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.append(b"S" + _U32.pack(len(raw)) + raw)
    elif isinstance(v, np.ndarray):
        if v.dtype.hasobject:
            raise ProtocolError("object arrays are not serializable "
                                "(pickle-free protocol)")
        arr = np.ascontiguousarray(v)
        dt = arr.dtype.str.encode("ascii")      # e.g. b"<f4"
        out.append(b"A" + _U32.pack(len(dt)) + dt
                   + bytes([arr.ndim])
                   + b"".join(_I64.pack(d) for d in arr.shape))
        out.append(arr.tobytes())
    elif isinstance(v, dict):
        out.append(b"D" + _U32.pack(len(v)))
        for k, item in v.items():
            if not isinstance(k, str):
                raise ProtocolError(f"dict keys must be str, got {type(k)}")
            raw = k.encode("utf-8")
            out.append(_U32.pack(len(raw)) + raw)
            _enc_value(out, item)
    elif isinstance(v, (tuple, list)):
        out.append(b"T" + _U32.pack(len(v)))
        for item in v:
            _enc_value(out, item)
    else:
        raise ProtocolError(f"value of type {type(v).__name__} has no wire "
                            "encoding")


def _dec_value(buf: memoryview, off: int):
    tag = bytes(buf[off:off + 1])
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"B":
        return bytes(buf[off:off + 1]) == b"1", off + 1
    if tag == b"I":
        return _I64.unpack_from(buf, off)[0], off + 8
    if tag == b"F":
        return _F64.unpack_from(buf, off)[0], off + 8
    if tag == b"S":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        return bytes(buf[off:off + n]).decode("utf-8"), off + n
    if tag == b"A":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        dtype = np.dtype(bytes(buf[off:off + n]).decode("ascii"))
        off += n
        ndim = buf[off]
        off += 1
        shape = tuple(_I64.unpack_from(buf, off + 8 * i)[0]
                      for i in range(ndim))
        off += 8 * ndim
        nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        arr = np.frombuffer(buf[off:off + nbytes],
                            dtype=dtype).reshape(shape).copy()
        return arr, off + nbytes
    if tag == b"D":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        d = {}
        for _ in range(n):
            kn = _U32.unpack_from(buf, off)[0]
            off += 4
            key = bytes(buf[off:off + kn]).decode("utf-8")
            off += kn
            d[key], off = _dec_value(buf, off)
        return d, off
    if tag == b"T":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        items = []
        for _ in range(n):
            item, off = _dec_value(buf, off)
            items.append(item)
        return tuple(items), off
    raise ProtocolError(f"unknown value tag {tag!r} at offset {off - 1}")


# ---------------------------------------------------------------------------
# message codec
# ---------------------------------------------------------------------------

def encode_message(msg) -> bytes:
    """Record -> frame body (no length prefix): u16 wire code + fields in
    declared order."""
    code = _WIRE_CODES.get(type(msg))
    if code is None:
        raise ProtocolError(f"{type(msg).__name__} is not a protocol record")
    out = [struct.pack("<H", code)]
    for v in msg:
        _enc_value(out, v)
    return b"".join(out)


def decode_message(data) -> NamedTuple:
    """Frame body -> record. Raises ``ProtocolError`` on unknown codes or
    trailing garbage (a truncated field surfaces as a struct error)."""
    buf = memoryview(data)
    (code,) = struct.unpack_from("<H", buf, 0)
    cls = _WIRE_SPECS.get(code)
    if cls is None:
        raise ProtocolError(f"unknown wire code {code}")
    off = 2
    fields = []
    for _ in cls._fields:
        v, off = _dec_value(buf, off)
        fields.append(v)
    if off != len(buf):
        raise ProtocolError(f"{cls.__name__}: {len(buf) - off} trailing "
                            "bytes after last field")
    return cls(*fields)


def frame_message(msg) -> bytes:
    """Record -> u32-length-prefixed frame, ready for ``sendall``."""
    body = encode_message(msg)
    if len(body) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {len(body)} bytes exceeds "
                            f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES})")
    return _U32.pack(len(body)) + body


def read_frame_length(prefix: bytes) -> int:
    """Validated body length from a 4-byte prefix."""
    (n,) = _U32.unpack(prefix)
    if n > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame length {n} exceeds MAX_FRAME_BYTES "
                            f"({MAX_FRAME_BYTES}) — corrupt stream?")
    return n


# -- v4 multiplexed framing --------------------------------------------------
# post-handshake frame layout:
#   u32 length | u64 request id | u8 lane | u16 wire code | fields...
# The length prefix counts the mux header. Request id 0 is RESERVED for
# connection-level errors (a frame the server could not attribute to any
# request); clients allocate ids from 1.

_MUX = struct.Struct("<QB")
MUX_HEADER_BYTES = _MUX.size            # 9


def frame_message_mux(msg, req_id: int, lane: int) -> bytes:
    """Record -> length-prefixed v4 frame carrying (request id, lane)."""
    if lane not in LANES:
        raise ProtocolError(f"invalid lane {lane!r}")
    body = encode_message(msg)
    n = len(body) + MUX_HEADER_BYTES
    if n > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {n} bytes exceeds MAX_FRAME_BYTES "
                            f"({MAX_FRAME_BYTES})")
    return _U32.pack(n) + _MUX.pack(req_id, lane) + body


def decode_mux(data) -> Tuple[int, int, NamedTuple]:
    """v4 frame body (length prefix already stripped) ->
    ``(request id, lane, record)``. A malformed mux header raises before
    the message decode, so the caller can distinguish "can't even
    attribute this frame" from "request ``id`` carried a bad record"."""
    if len(data) < MUX_HEADER_BYTES:
        raise ProtocolError(f"frame of {len(data)} bytes is shorter than "
                            f"the {MUX_HEADER_BYTES}-byte mux header")
    req_id, lane = _MUX.unpack_from(data, 0)
    if lane not in LANES:
        raise ProtocolError(f"invalid lane {lane} in mux header")
    return req_id, lane, decode_message(memoryview(data)[MUX_HEADER_BYTES:])


# ---------------------------------------------------------------------------
# the transport seam
# ---------------------------------------------------------------------------

class Transport(Protocol):
    """One blocking round-trip per call; thread-safe. ``num_entries`` /
    ``dim`` come from the handshake (or the live server, in-process)."""

    num_entries: int
    dim: int

    def request(self, msg) -> NamedTuple: ...

    def close(self) -> None: ...


class KBClient(Protocol):
    """The duck-type every bank client codes against — satisfied by the
    concrete ``KnowledgeBankServer`` (the in-process zero-copy case) and by
    ``RemoteKnowledgeBank`` (any ``Transport``). ``MakerRuntime``,
    ``run_async_training``, and the launchers take THIS, never the server
    class, so a maker or trainer moves across process boundaries without a
    code change."""

    def lookup(self, ids, *, trainer_step: int = 0) -> np.ndarray: ...

    def update(self, ids, values, *, src_step: int = 0) -> None: ...

    def lazy_grad(self, ids, grads) -> None: ...

    def flush(self) -> None: ...

    def nn_search(self, queries, k: int, *, mode: Optional[str] = None,
                  exclude_ids=None) -> Tuple[np.ndarray, np.ndarray]: ...

    def table_snapshot(self) -> np.ndarray: ...

    def attach_maker_runtime(self, runtime) -> None: ...

    def close(self) -> None: ...


class InProcessTransport:
    """The zero-copy fast case of the transport interface: records dispatch
    directly onto a live ``KnowledgeBankServer`` — no serialization, arrays
    pass through by reference, exceptions propagate with their real types.
    ``RemoteKnowledgeBank`` over this transport is bit-identical to (and
    benchmarks within noise of) calling the server directly, which is what
    keeps the single-process path regression-free while every client speaks
    protocol records."""

    def __init__(self, server, *, partition: str = ""):
        self.server = server
        self.num_entries = server.engine.num_entries
        self.dim = server.engine.dim
        self.partition = partition      # ring slot label ("p/N"; "" = none)
        self.spare_claim = ""           # "p/N" once a router claimed us

    def request(self, msg) -> NamedTuple:
        srv = self.server
        if isinstance(msg, LookupRequest):
            return ValuesResponse(srv.lookup(msg.ids,
                                             trainer_step=msg.trainer_step))
        if isinstance(msg, UpdateRequest):
            srv.update(msg.ids, msg.values, src_step=msg.src_step)
            return OkResponse()
        if isinstance(msg, LazyGradRequest):
            srv.lazy_grad(msg.ids, msg.grads)
            return OkResponse()
        if isinstance(msg, FlushRequest):
            srv.flush()
            return OkResponse()
        if isinstance(msg, NNSearchRequest):
            scores, ids = srv.nn_search(msg.queries, msg.k, mode=msg.mode,
                                        exclude_ids=msg.exclude_ids)
            return NNSearchResponse(scores, ids)
        if isinstance(msg, StatsRequest):
            return StatsResponse(srv.stats())
        if isinstance(msg, SnapshotRequest):
            return ValuesResponse(srv.table_snapshot())
        if isinstance(msg, ExportRowsRequest):
            return RowsResponse(srv.export_rows(msg.ids))
        if isinstance(msg, ImportRowsRequest):
            srv.import_rows(msg.ids, msg.leaves)
            return OkResponse()
        if isinstance(msg, PromoteRequest):
            self.partition = msg.partition
            self.spare_claim = ""       # a promoted spare is a member now
            return OkResponse()
        if isinstance(msg, AttachSpareRequest):
            if self.spare_claim and self.spare_claim != msg.partition:
                raise ProtocolError(
                    f"spare_conflict: already claimed as spare for "
                    f"{self.spare_claim!r}, refused claim for "
                    f"{msg.partition!r}")
            self.spare_claim = msg.partition
            return OkResponse()
        if isinstance(msg, Hello):
            if msg.expect_partition and msg.expect_partition != self.partition:
                raise ProtocolError(
                    f"client expects partition {msg.expect_partition!r}, "
                    f"this bank serves {self.partition!r}")
            return Welcome(PROTOCOL_VERSION, self.num_entries, self.dim,
                           self.partition)
        raise ProtocolError(f"{type(msg).__name__} is not a request record")

    def close(self) -> None:
        pass                            # the server's owner closes it
