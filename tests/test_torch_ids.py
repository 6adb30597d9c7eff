"""Ids outside [0, N) sent to the port's engine and server
(repro_torch.core.kb_engine, repro_torch.core.async_runtime).

The port refuses them on the host, before any device op, with one error
(``KBIdError``, an ``IndexError``) on every backend and storage mode, and
leaves the bank bit-identical: a CUDA index out of range is a device-side
assert that would poison every later request of the process. The JAX
engine clamps such reads and drops such writes instead (ROADMAP,
deliberate differences). The server refuses the request in the caller's
thread, so it never fails a merged run of good requests, and serves the
next one.
"""
import numpy as np
import pytest
import torch

from repro_torch.convert import kb_state_to_numpy
from repro_torch.core.async_runtime import KnowledgeBankServer
from repro_torch.core.kb_engine import KBEngine, KBIdError

N, D = 48, 16


def _engine(backend, storage, device="cpu"):
    rng = np.random.default_rng(5)
    eng = KBEngine(N, D, backend=backend, storage=storage, master_rows=8,
                   device=device)
    eng.update(np.arange(N), rng.standard_normal((N, D)).astype(np.float32))
    eng.lazy_grad(np.array([1, 2, 2]), np.ones((3, D), np.float32))
    return eng


def _snapshot(eng):
    leaves = kb_state_to_numpy(eng.state)
    if eng._qscale is not None:
        leaves["scale"] = eng._qscale.cpu().numpy()
        leaves["offset"] = eng._qoffset.cpu().numpy()
    masters = {g: m.copy() for g, m in eng._masters.items()}
    return leaves, masters, eng.total_write_rows, eng.dispatches


def _assert_unchanged(eng, before):
    leaves, masters, writes, dispatches = _snapshot(eng)
    for f, want in before[0].items():
        np.testing.assert_array_equal(leaves[f], want, err_msg=f)
    assert masters.keys() == before[1].keys()
    for g in masters:
        np.testing.assert_array_equal(masters[g], before[1][g])
    assert (writes, dispatches) == before[2:]


def _call(eng, op, bad):
    ids = np.array([3, bad, 5])
    if op == "lookup":
        eng.lookup(ids)
    elif op == "update":
        eng.update(ids, np.ones((3, D), np.float32))
    else:
        eng.lazy_grad(ids, np.ones((3, D), np.float32))


@pytest.mark.parametrize("bad", [N, -1])
@pytest.mark.parametrize("op", ["lookup", "update", "lazy_grad"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_engine_refuses_out_of_range_ids(backend, storage, op, bad):
    eng = _engine(backend, storage)
    before = _snapshot(eng)
    with pytest.raises(KBIdError, match=rf"{op}: ids \[{bad}\] lie outside"):
        _call(eng, op, bad)
    _assert_unchanged(eng, before)
    assert issubclass(KBIdError, IndexError)
    # the engine goes on serving
    np.testing.assert_array_equal(eng.lookup(np.array([7])),
                                  _engine(backend, storage).lookup([7]))


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_exclusion_ids_refused_but_minus_one_inert(backend, storage):
    eng = _engine(backend, storage)
    q = np.random.default_rng(6).standard_normal((2, D)).astype(np.float32)
    s, i = eng.nn_search(q, 4, exclude_ids=np.array([[-1], [0]]))
    assert 0 not in i[1]
    before = _snapshot(eng)
    for bad in (N, -2):
        with pytest.raises(KBIdError, match="exclude_ids"):
            eng.nn_search(q, 4, exclude_ids=np.array([[bad], [0]]))
    _assert_unchanged(eng, before)


@pytest.mark.parametrize("coalesce", [True, False])
def test_server_refuses_the_request_and_serves_the_next(coalesce):
    srv = KnowledgeBankServer(N, D, device="cpu", coalesce=coalesce)
    rng = np.random.default_rng(7)
    table = rng.standard_normal((N, D)).astype(np.float32)
    srv.update(np.arange(N), table)
    before = _snapshot(srv.engine)
    requests = srv.metrics["requests"]
    for bad in (N, -1):
        with pytest.raises(KBIdError):
            srv.lookup(np.array([bad]))
        with pytest.raises(KBIdError):
            srv.update(np.array([0, bad]), np.ones((2, D), np.float32))
        with pytest.raises(KBIdError):
            srv.lazy_grad(np.array([bad, 1]), np.ones((2, D), np.float32))
        with pytest.raises(KBIdError):
            srv.enqueue_op("lookup", ids=np.array([bad]), shape=(1,))
    with pytest.raises(KBIdError):
        srv.nn_search(table[:1], 3, exclude_ids=np.array([[N]]))
    _assert_unchanged(srv.engine, before)
    assert srv.metrics["requests"] == requests     # none was queued
    np.testing.assert_array_equal(srv.lookup(np.array([4, 9])),
                                  table[[4, 9]])
    srv.close()


@pytest.mark.cuda
def test_cuda_engine_refuses_out_of_range_ids_and_keeps_serving():
    """On the card: no bad id reaches a kernel or an index, so the CUDA
    context survives and the next request is served."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py phase 3 runs this "
                    "check on the card")
    for storage in ("fp32", "int8"):
        eng = _engine("cuda", storage, device="cuda")
        want = eng.lookup(np.array([7]))
        before = _snapshot(eng)
        for op in ("lookup", "update", "lazy_grad"):
            for bad in (N, -1):
                with pytest.raises(KBIdError):
                    _call(eng, op, bad)
        torch.cuda.synchronize()
        _assert_unchanged(eng, before)
        np.testing.assert_array_equal(eng.lookup(np.array([7])), want)
