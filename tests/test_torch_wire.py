"""The port's wire layer (repro_torch.core.kb_protocol / kb_transport)
against the JAX package's, on the CPU: interop is the parity.

- Frames: every protocol record, framed by either package, decodes in the
  other to equal fields, and both frame it to identical bytes (plain and
  v4 mux framing, every lane); ``lane_of`` agrees record by record.
- A JAX ``RemoteKnowledgeBank`` over a socket to a port
  ``KBTransportServer`` gets bit for bit what the same port server returns
  in process, on the five ops, stats, snapshot, export and import; a port
  client against a JAX server likewise; and the port's results stay within
  tests/test_kb_engine.py's tolerances of the JAX package's.
- The deliberate difference: out-of-range ids are refused by the port's
  server before the engine runs, as ``KBIdError`` (an ``IndexError``),
  raised client-side as ``RemoteKBError`` naming it; the connection
  serves on. The JAX engine clamps them, and its server then fails in
  its own bookkeeping with a plain ``IndexError``.
- ``_Request.add_done_callback`` fires each callback exactly once, whether
  it is registered before or after completion, and a callback's error
  never reaches the dispatcher.

No Hypothesis: fixed inputs from seeded numpy generators. Every client
dials with a connect timeout and every raw socket has its own.
"""
import socket

import numpy as np
import pytest

import repro.core as jcore
import repro.core.kb_protocol as jkbp
import repro_torch.core as tcore
import repro_torch.core.kb_protocol as tkbp
from repro_torch.core.async_runtime import _Request

N, D = 48, 8
ATOL_ROWS = 1e-5        # tests/test_kb_engine.py: lookups and scores
ATOL_STATE = 1e-6       # tests/test_kb_engine.py: state leaves
ID_GAP = 1e-4
TIMEOUT_S = 10.0


def _table(seed=0, n=N, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def _records(kbp):
    """One instance of every record of ``kbp`` (the package's module),
    with arrays of several dtypes and a nested stats dict."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 1000, 7).astype(np.int64)
    ids[0] = 2 ** 62 + 12345
    vals = rng.normal(size=(7, 5)).astype(np.float32)
    leaves = {"table": vals, "version": np.arange(7, dtype=np.int32),
              "grad_cnt": np.ones(7, np.float32),
              "scale": np.linspace(0, 1, 7).astype(np.float64)}
    stats = {"metrics": {"requests": 12, "staleness_sum": 0.25},
             "backend": "cuda", "flag": True, "none": None,
             "shape": (3, [4, 5]), "arr": np.arange(6, dtype=np.uint32),
             "maker_stats": {"graph_builder0": {"error": None}}}
    return {
        "Hello": kbp.Hello(kbp.PROTOCOL_VERSION, "trainer", "0/2"),
        "Welcome": kbp.Welcome(kbp.PROTOCOL_VERSION, 1939743, 128, "1/2"),
        "LookupRequest": kbp.LookupRequest(ids, 3),
        "UpdateRequest": kbp.UpdateRequest(ids, vals, 2),
        "LazyGradRequest": kbp.LazyGradRequest(ids, vals),
        "FlushRequest": kbp.FlushRequest(),
        "NNSearchRequest": kbp.NNSearchRequest(
            vals, 5, "exact", rng.integers(-1, 50, (7, 2)).astype(np.int32)),
        "NNSearchRequest-plain": kbp.NNSearchRequest(vals[:0], 8, None, None),
        "StatsRequest": kbp.StatsRequest(),
        "SnapshotRequest": kbp.SnapshotRequest(),
        "ExportRowsRequest": kbp.ExportRowsRequest(ids),
        "ImportRowsRequest": kbp.ImportRowsRequest(ids, leaves),
        "PromoteRequest": kbp.PromoteRequest("1/3"),
        "AttachSpareRequest": kbp.AttachSpareRequest("0/2"),
        "OkResponse": kbp.OkResponse(),
        "RowsResponse": kbp.RowsResponse(leaves),
        "ValuesResponse": kbp.ValuesResponse(np.asfortranarray(vals)),
        "NNSearchResponse": kbp.NNSearchResponse(vals[:, :3],
                                                 ids[:6].reshape(2, 3)),
        "StatsResponse": kbp.StatsResponse(stats),
        "ErrorResponse": kbp.ErrorResponse("KBIdError", "ids [48] lie "
                                           "outside [0, 48)"),
    }


RECORDS = sorted(_records(tkbp))


def _assert_same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert type(a) is type(b) and a == b


def test_both_packages_have_the_same_record_set():
    assert tkbp.PROTOCOL_VERSION == jkbp.PROTOCOL_VERSION == 4
    assert ({c: cls.__name__ for c, cls in tkbp._WIRE_SPECS.items()}
            == {c: cls.__name__ for c, cls in jkbp._WIRE_SPECS.items()})
    for code, cls in tkbp._WIRE_SPECS.items():
        assert cls._fields == jkbp._WIRE_SPECS[code]._fields
    assert len(RECORDS) == len(tkbp._WIRE_SPECS) + 1
    assert (tkbp.LANES, tkbp.LANE_NAMES, tkbp.MAX_FRAME_BYTES,
            tkbp.MUX_HEADER_BYTES) == (jkbp.LANES, jkbp.LANE_NAMES,
                                       jkbp.MAX_FRAME_BYTES,
                                       jkbp.MUX_HEADER_BYTES)


@pytest.mark.parametrize("name", RECORDS)
def test_frames_are_byte_identical_and_decode_across(name):
    t_msg, j_msg = _records(tkbp)[name], _records(jkbp)[name]
    raw = tkbp.frame_message(t_msg)
    assert raw == jkbp.frame_message(j_msg)
    body = raw[4:]
    assert tkbp.read_frame_length(raw[:4]) == len(body)
    j_out = jkbp.decode_message(body)           # port bytes, JAX decoder
    t_out = tkbp.decode_message(jkbp.encode_message(j_msg))
    assert type(j_out).__name__ == type(t_msg).__name__
    assert type(t_out) is type(t_msg)
    _assert_same(tuple(j_out), tuple(t_msg))
    _assert_same(tuple(t_out), tuple(j_msg))
    if type(t_msg).__name__.endswith("Request"):
        assert tkbp.lane_of(t_msg) == jkbp.lane_of(j_out)


@pytest.mark.parametrize("lane", [tkbp.LANE_CONTROL, tkbp.LANE_POINT,
                                  tkbp.LANE_BULK])
def test_mux_frames_are_byte_identical_on_every_lane(lane):
    for name, rid in (("LookupRequest", 1), ("NNSearchResponse", 2 ** 48 + 5),
                      ("StatsResponse", 0)):
        t_msg, j_msg = _records(tkbp)[name], _records(jkbp)[name]
        raw = tkbp.frame_message_mux(t_msg, rid, lane)
        assert raw == jkbp.frame_message_mux(j_msg, rid, lane)
        j_rid, j_lane, j_out = jkbp.decode_mux(raw[4:])
        t_rid, t_lane, t_out = tkbp.decode_mux(raw[4:])
        assert (j_rid, j_lane, t_rid, t_lane) == (rid, lane, rid, lane)
        _assert_same(tuple(j_out), tuple(t_out))
    with pytest.raises(tkbp.ProtocolError):
        tkbp.frame_message_mux(tkbp.OkResponse(), 1, 3)
    with pytest.raises(tkbp.ProtocolError):
        tkbp.decode_mux(b"\x00" * 5)


# ---------------------------------------------------------------------------
# interop: one op stream, bit-compared
# ---------------------------------------------------------------------------

def _drive(client, tbl):
    """Every op of the client surface once or more, in one scripted order;
    returns each result for a bit-compare."""
    out = {}
    client.update(np.arange(tbl.shape[0]), tbl, src_step=1)
    out["lookup"] = client.lookup(np.array([[3, 5], [7, 9]]), trainer_step=2)
    g = np.linspace(-0.5, 0.5, 3 * D, dtype=np.float32).reshape(3, D)
    client.lazy_grad([1, 2, 2], g)
    out["lookup_pending"] = client.lookup([1, 2, 4], trainer_step=3)
    client.lazy_grad([4, 5], g[:2])
    client.flush()
    q = tbl[:6] + 0.01
    out["nn_excl"] = client.nn_search(
        q, 4, exclude_ids=np.arange(6, dtype=np.int32)[:, None])
    out["nn"] = client.nn_search(q, 5)
    out["snapshot"] = client.table_snapshot()
    out["export"] = client.export_rows([0, 5, 9])
    client.import_rows([10, 11, 12], out["export"])
    out["lookup_imported"] = client.lookup([10, 11, 12], trainer_step=4)
    out["export_after"] = client.export_rows([4, 10, 11, 12])
    out["metrics"] = client.stats()["metrics"]
    return out


def _compare_bitwise(a, b):
    for key in a:
        if key == "metrics":
            assert a[key] == b[key]
        elif key.startswith("nn"):
            for x, y in zip(a[key], b[key]):
                np.testing.assert_array_equal(x, y)
        elif key.startswith("export"):
            _assert_same(dict(a[key]), dict(b[key]))
        else:
            np.testing.assert_array_equal(a[key], b[key])


def _port_server():
    return tcore.KnowledgeBankServer(N, D, device="cpu")


def _jax_server():
    return jcore.KnowledgeBankServer(N, D)


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_a_client_of_either_package_gets_the_port_servers_answers(
        client_pkg):
    """A port KBTransportServer (on the CPU) serves a client of either
    package over a socket exactly what the same server answers in
    process."""
    tbl = _table(1)
    with _port_server() as inproc, _port_server() as served:
        want = _drive(inproc, tbl)
        with tcore.KBTransportServer(served) as wire:
            pkg = jcore if client_pkg == "jax" else tcore
            client = pkg.RemoteKnowledgeBank(
                "127.0.0.1", wire.port, connect_timeout_s=TIMEOUT_S)
            assert (client.num_entries, client.dim) == (N, D)
            got = _drive(client, tbl)
            client.close()
            assert wire.requests_served >= 14
    _compare_bitwise(got, want)
    assert got["lookup"].shape == (2, 2, D)
    assert set(got["export"]) == set(tcore.KBEngine.ROW_LEAVES)


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_a_client_of_either_package_gets_the_jax_servers_answers(
        client_pkg):
    """The reverse: a JAX KBTransportServer serves a port client (and its
    own) exactly what the same JAX server answers in process."""
    tbl = _table(2)
    with _jax_server() as inproc, _jax_server() as served:
        want = _drive(inproc, tbl)
        with jcore.KBTransportServer(served) as wire:
            pkg = jcore if client_pkg == "jax" else tcore
            client = pkg.RemoteKnowledgeBank(
                "127.0.0.1", wire.port, connect_timeout_s=TIMEOUT_S)
            got = _drive(client, tbl)
            client.close()
    _compare_bitwise(got, want)


def test_port_server_results_within_the_engine_tolerances_of_jax():
    """The same op stream on a port server and on a JAX server, both in
    process: rows and scores within 1e-5, state leaves within 1e-6,
    versions exact, nn ids exact where their scores are separated."""
    tbl = _table(3)
    with _port_server() as ps, _jax_server() as js:
        got, want = _drive(ps, tbl), _drive(js, tbl)
    for key in ("lookup", "lookup_pending", "lookup_imported"):
        np.testing.assert_allclose(got[key], want[key], atol=ATOL_ROWS,
                                   rtol=0)
    np.testing.assert_allclose(got["snapshot"], want["snapshot"],
                               atol=ATOL_STATE, rtol=0)
    for key in ("export", "export_after"):
        assert set(got[key]) == set(want[key])
        for leaf, v in got[key].items():
            if leaf == "version":
                np.testing.assert_array_equal(v, want[key][leaf])
            else:
                np.testing.assert_allclose(v, want[key][leaf],
                                           atol=ATOL_STATE, rtol=0)
    for key in ("nn", "nn_excl"):
        (s_t, i_t), (s_j, i_j) = got[key], want[key]
        np.testing.assert_allclose(s_t, s_j, atol=ATOL_ROWS, rtol=0)
        gaps = np.abs(np.diff(s_j, axis=1))
        sep = np.ones_like(i_j, bool)
        sep[:, 1:] &= gaps > ID_GAP
        sep[:, :-1] &= gaps > ID_GAP
        np.testing.assert_array_equal(i_t[sep], i_j[sep])
    for k in ("lookups", "updates", "lazy_grads", "rows_served",
              "stale_rows_served", "staleness_sum", "requests"):
        assert got["metrics"][k] == want["metrics"][k], k


# ---------------------------------------------------------------------------
# the deliberate difference: out-of-range ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_out_of_range_ids_are_refused_over_the_wire_as_kbiderror(
        client_pkg):
    tbl = _table(4)
    pkg = jcore if client_pkg == "jax" else tcore
    with _port_server() as srv, tcore.KBTransportServer(srv) as wire:
        srv.update(np.arange(N), tbl)
        client = pkg.RemoteKnowledgeBank("127.0.0.1", wire.port,
                                         connect_timeout_s=TIMEOUT_S)
        for bad in ([N], [-1, 3]):
            with pytest.raises(pkg.RemoteKBError, match="KBIdError"):
                client.lookup(bad)
        with pytest.raises(pkg.RemoteKBError, match="KBIdError"):
            client.update([N + 5], tbl[:1])
        np.testing.assert_array_equal(client.lookup([3]), tbl[3:4])
        client.close()
        np.testing.assert_array_equal(srv.table_snapshot(), tbl)
    # the JAX engine clamps the read, and the JAX server then fails in its
    # staleness accounting: a plain IndexError, after the engine ran
    with _jax_server() as js, jcore.KBTransportServer(js) as wire:
        js.update(np.arange(N), tbl)
        client = tcore.RemoteKnowledgeBank("127.0.0.1", wire.port,
                                           connect_timeout_s=TIMEOUT_S)
        with pytest.raises(tcore.RemoteKBError,
                           match=r"^\[IndexError\] index 48 is out of"):
            client.lookup([N])
        np.testing.assert_array_equal(client.lookup([3]), tbl[3:4])
        client.close()


def test_a_handshake_of_another_version_is_refused_in_plain_framing():
    with _port_server() as srv, tcore.KBTransportServer(srv) as wire:
        sock = socket.create_connection(("127.0.0.1", wire.port),
                                        timeout=TIMEOUT_S)
        sock.settimeout(TIMEOUT_S)
        try:
            sock.sendall(jkbp.frame_message(jkbp.Hello(3, "old", "")))
            n = jkbp.read_frame_length(sock.recv(4))
            body = b""
            while len(body) < n:
                body += sock.recv(n - len(body))
        finally:
            sock.close()
        resp = jkbp.decode_message(body)
        assert isinstance(resp, jkbp.ErrorResponse)
        assert resp.kind == "version_mismatch"


# ---------------------------------------------------------------------------
# add_done_callback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("when", ["before", "after"])
def test_done_callback_fires_exactly_once(when):
    fired = []
    r = _Request("lookup")
    if when == "before":
        r.add_done_callback(fired.append)
        assert fired == []
    r.result = np.zeros((1, D), np.float32)
    r.event.set()
    r._fire_callbacks()
    if when == "after":
        r.add_done_callback(fired.append)
    r._fire_callbacks()
    assert fired == [r]


def test_done_callbacks_on_the_dispatcher_and_a_failing_one():
    """Callbacks registered on queued requests run once each on the
    dispatcher; one that raises does not stop it serving."""
    with _port_server() as srv:
        srv.update(np.arange(N), _table(5))
        counts = {}

        def boom(r):
            raise RuntimeError("a callback's error stays in the callback")

        reqs = []
        for i in range(6):
            ids = np.array([i, i + 1])
            r = srv.enqueue_op("lookup", ids=ids, shape=ids.shape)
            r.add_done_callback(boom)
            r.add_done_callback(
                lambda q, i=i: counts.__setitem__(i, counts.get(i, 0) + 1))
            reqs.append(r)
        for r in reqs:
            r.wait()
            r.add_done_callback(boom)           # after completion too
        # the dispatcher fires a run's callbacks before it takes the next
        # request, so they have all run once this lookup is answered
        np.testing.assert_array_equal(srv.lookup([0]), _table(5)[:1])
        assert counts == {i: 1 for i in range(6)}
