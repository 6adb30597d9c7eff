"""The port's coalescing server (repro_torch.core.async_runtime) and its
serve launcher (repro_torch.launch.serve), on the CPU: coalesced against
serial, reordered against FIFO, the JAX server against the port's on one
stream, the close race, the hot-id cache, a tiny serve run, the explicit
device, the refused options, and a port that imports neither JAX nor the
JAX package.

Tolerances as tests/test_kb_engine.py: served rows atol 1e-5, tables
atol 1e-6; coalesced and reordered schedules are held bit-identical to
serial and FIFO ones, as the JAX suite holds its own.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.core import KnowledgeBankServer as JaxServer
from repro_torch.core.async_runtime import (KBServerClosedError,
                                            KnowledgeBankServer, _Request)
from repro_torch.core.kb_engine import KBEngine
from repro_torch.launch import serve

N, D = 64, 16
LAZY_LR, ZMAX = 0.2, 2.0
ROOT = Path(__file__).resolve().parents[1]


def filled(srv, seed=0):
    table = np.random.default_rng(seed).standard_normal(
        (N, D)).astype(np.float32)
    srv.update(np.arange(N), table)
    return table


def test_coalesced_server_matches_serial_engine():
    """8 threads hammer lazy_grad + lookup concurrently; the final table and
    every served value match one thread's serial execution."""
    n_threads, rows_per = 8, 8
    grads = {t: (0.1 * np.random.default_rng(t).standard_normal(
        (rows_per, D))).astype(np.float32) for t in range(n_threads)}
    ids_of = {t: np.arange(t * rows_per, (t + 1) * rows_per)
              for t in range(n_threads)}
    serial = KBEngine(N, D, lazy_lr=LAZY_LR, zmax=ZMAX, device="cpu")
    filled(serial)
    for t in range(n_threads):
        serial.lazy_grad(ids_of[t], grads[t])
    serial_vals = serial.lookup(np.arange(N))

    srv = KnowledgeBankServer(N, D, lazy_lr=LAZY_LR, zmax=ZMAX,
                              coalesce_window_s=0.002, device="cpu")
    filled(srv)
    barrier = threading.Barrier(n_threads)
    served = {}

    def worker(t):
        barrier.wait()
        srv.lazy_grad(ids_of[t], grads[t])      # disjoint rows: commutative
        barrier.wait()
        served[t] = srv.lookup(np.arange(N))    # overlapping lookups

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    srv.close()
    np.testing.assert_allclose(srv.engine.table_snapshot(),
                               serial.table_snapshot(), atol=1e-6)
    for t in range(n_threads):
        np.testing.assert_allclose(served[t], serial_vals, atol=1e-5)
    assert srv.metrics["requests"] == 2 * n_threads + 1
    assert srv.metrics["dispatches"] < srv.metrics["requests"]


def _stream(rng):
    """A queue's worth of interleaved client requests."""
    reqs = []
    for _ in range(24):
        op = rng.choice(["lookup", "lazy_grad", "update", "nn"])
        ids = rng.integers(0, N, int(rng.integers(1, 5)))
        if op == "lookup":
            reqs.append(("lookup", dict(ids=ids, shape=ids.shape)))
        elif op == "lazy_grad":
            reqs.append(("lazy_grad", dict(ids=ids, payload=(
                0.1 * rng.standard_normal((ids.size, D))).astype(
                    np.float32))))
        elif op == "update":
            reqs.append(("update", dict(ids=ids, payload=rng.standard_normal(
                (ids.size, D)).astype(np.float32))))
        else:
            reqs.append(("nn", dict(payload=rng.standard_normal(
                (2, D)).astype(np.float32), k=3)))
    return reqs


def _runs_executed(srv, stream):
    """``stream`` as one popped batch, formed into runs and each run
    executed as one engine op -> (runs, the requests)."""
    batch = [_Request(op, **kw) for op, kw in stream]
    runs = srv._form_runs(batch)
    for run in runs:
        srv._execute_run(run)
    assert all(r.error is None for r in batch)
    return runs, batch


@pytest.mark.parametrize("seed", [0, 1, 100])
def test_reordered_runs_equal_fifo_runs(seed):
    """One popped batch formed into runs with reorder on and off, each run
    executed as one engine op: every result and the final state are
    bit-identical, and reordering merged some requests."""
    stream = _stream(np.random.default_rng(seed))
    outcomes = []
    for reorder in (False, True):
        srv = KnowledgeBankServer(N, D, coalesce=False, reorder=reorder,
                                  reorder_window=8, device="cpu")
        filled(srv, seed)
        runs, batch = _runs_executed(srv, stream)
        outcomes.append((len(runs), [r.result for r in batch],
                         srv.engine.table_snapshot(),
                         srv.engine.version_snapshot(),
                         srv.metrics["reorders"]))
    (n_fifo, res_fifo, tbl_fifo, ver_fifo, _), \
        (n_re, res_re, tbl_re, ver_re, hoisted) = outcomes
    assert n_re < n_fifo and hoisted > 0
    np.testing.assert_array_equal(tbl_re, tbl_fifo)
    np.testing.assert_array_equal(ver_re, ver_fifo)
    for a, b in zip(res_fifo, res_re):
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        elif a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 100])
def test_reorder_keeps_lazy_grads_on_one_row_apart(seed):
    """tests/test_kb_router.py::test_reorder_bit_identical_to_fifo's
    stream (24 lookups, updates and lazy_grads of 1-5 ids of 48 rows,
    N(0, 1) payloads of width 4, a table from seed 9) as one popped batch:
    the reordered runs give FIFO's lookups, table and gradient caches bit
    for bit. At seed 100 lazy_grads 11 and 13 share row 18 with update 12
    between them; a schedule that hoisted 13 into 11's run called them as
    one and clipped and stepped row 18's norm EMA once (ROADMAP Q3 item
    10). Versions are not compared: a merged run of lookups bumps a row
    they share once, as FIFO's merge of consecutive ones does."""
    n, d = 48, 4
    rng = np.random.default_rng(seed)
    stream = []
    for _ in range(24):
        op = ("lookup", "update", "lazy_grad")[int(rng.integers(3))]
        ids = rng.integers(0, n, int(rng.integers(1, 6)))
        stream.append((op, dict(ids=ids, shape=ids.shape) if op == "lookup"
                       else dict(ids=ids, payload=rng.normal(
                           size=(ids.size, d)).astype(np.float32))))
    table = np.random.default_rng(9).standard_normal((n, d)).astype(
        np.float32)
    outcomes = []
    for reorder in (False, True):
        srv = KnowledgeBankServer(n, d, coalesce=False, reorder=reorder,
                                  reorder_window=8, device="cpu")
        srv.update(np.arange(n), table)
        runs, batch = _runs_executed(srv, stream)
        st = srv.engine.state
        outcomes.append(([r.result for r in batch if r.op == "lookup"],
                         srv.engine.table_snapshot(),
                         [getattr(st, f).numpy().copy() for f in
                          ("grad_sum", "grad_cnt", "grad_sqnorm",
                           "norm_ema")], len(runs)))
    (look_f, tbl_f, grads_f, n_fifo), (look_r, tbl_r, grads_r, n_re) = \
        outcomes
    assert n_re < n_fifo
    for a, b in zip(look_f, look_r):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tbl_r, tbl_f)
    for a, b in zip(grads_f, grads_r):
        np.testing.assert_array_equal(a, b)


def test_port_server_matches_jax_server():
    """The same serial stream through both packages' servers."""
    port = KnowledgeBankServer(N, D, lazy_lr=LAZY_LR, zmax=ZMAX,
                               coalesce=False, device="cpu")
    ref = JaxServer(N, D, lazy_lr=LAZY_LR, zmax=ZMAX, coalesce=False)
    rng = np.random.default_rng(5)
    table = (0.5 * rng.standard_normal((N, D))).astype(np.float32)
    for srv in (port, ref):
        srv.update(np.arange(N), table)
    for step in range(6):
        ids = rng.integers(0, N, 5)
        g = (0.1 * rng.standard_normal((5, D))).astype(np.float32)
        for srv in (port, ref):
            srv.lazy_grad(ids, g)
        np.testing.assert_allclose(port.lookup(ids), ref.lookup(ids),
                                   atol=1e-5)
    q = rng.standard_normal((3, D)).astype(np.float32)
    (ps, pi), (rs, ri) = port.nn_search(q, 4), ref.nn_search(q, 4)
    np.testing.assert_allclose(ps, rs, atol=1e-5)
    np.testing.assert_array_equal(pi, ri)
    port.flush()
    ref.flush()
    np.testing.assert_allclose(port.table_snapshot(), ref.table_snapshot(),
                               atol=1e-6)
    assert port.metrics["dispatches"] == ref.metrics["dispatches"]
    port.close()
    ref.close()


def test_close_then_call_fails_fast():
    srv = KnowledgeBankServer(N, D, device="cpu")
    srv.update(np.array([1]), np.ones((1, D)))
    pending = srv.enqueue_op("lookup", ids=np.array([1]), shape=(1,))
    srv.close()
    np.testing.assert_allclose(pending.wait()[0], 1.0)   # drained, answered
    with pytest.raises(KBServerClosedError):
        srv.lookup(np.array([1]))
    with pytest.raises(KBServerClosedError):
        srv.enqueue_op("flush")
    np.testing.assert_allclose(srv.table_snapshot()[1], 1.0)


def test_hot_id_cache_serves_repeats_and_invalidates_on_write():
    srv = KnowledgeBankServer(N, D, cache_rows=8, device="cpu")
    table = filled(srv)
    a = srv.lookup(np.array([3, 4, 3]))
    b = srv.lookup(np.array([4, 3]))
    np.testing.assert_array_equal(a[[1, 0]], b)
    assert srv.metrics["cache_hits"] == 2
    srv.lazy_grad(np.array([3]), np.ones((1, D), np.float32))
    c = srv.lookup(np.array([3]))
    assert not np.allclose(c[0], table[3])     # the gradient applied
    srv.close()


def test_serve_on_the_cpu_when_asked(capsys):
    res = serve.main(["--kb", "--device", "cpu", "--kb-entries", "300",
                      "--kb-dim", "16", "--clients", "4", "--batch", "3",
                      "--gen", "3", "--kb-reorder"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("kb-serve backend=cuda search=exact "
                             "coalesce=True clients=4: ")
    assert out[1].startswith("kb storage mode=fp32 bytes/row=64 "
                             "resident=300/300")
    assert res["requests"] == 4 * 3 * 3 + 2          # + fill + flush
    assert res["req_per_s"] > 0
    st = res["engine"].state
    assert not st.grad_cnt.any() and not st.grad_sum.any()   # flushed


def test_serve_refuses_what_is_not_ported():
    # every arch serves (tests/test_torch_zoo.py); the JAX launcher's
    # autotuned ANN config does not yet
    with pytest.raises(NotImplementedError, match="ROADMAP Q1 item 5c"):
        serve.main(["--kb", "--device", "cpu", "--kb-autotuned",
                    "tuned.json"])
    # the wire fleet is ported: a member without --listen is the JAX
    # launcher's refusal (tests/test_torch_fleet.py serves --listen)
    with pytest.raises(SystemExit, match="--listen"):
        serve.main(["--kb", "--device", "cpu", "--kb-join", "0/2"])


def _run(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                          **env})


def test_serve_without_a_card_exits_with_the_no_cuda_error():
    """No --device: the default is CUDA, and without a card the launcher
    stops rather than serve on the CPU."""
    proc = _run("from repro_torch.launch.serve import main; main(['--kb'])",
                CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "kb-serve" not in proc.stdout


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith(('jax.', 'jaxlib')) or n == 'repro' or "
        "n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]),"
        " bad)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.split(" ", 1)
    assert int(count) >= 14
    assert bad.strip() == "[]"
