"""The port's engine (repro_torch.core.kb_engine) held against the JAX
engine (repro.core.kb_engine) on the same numpy state and op stream, on
the CPU: bucket padding at awkward batch sizes, duplicate ids, the
immediate-update ablation, exclusion through over-fetch; and the port's
own contract: warm-up on a scratch state, explicit devices, unported
options refused.

Tolerances as tests/test_kb_engine.py: version and grad_cnt exact, state
leaves atol 1e-6, lookup values atol 1e-5, nn scores atol 1e-5 and ids
exact where the reference's scores around them are > 1e-4 apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KBEngine as JaxEngine
from repro.core import knowledge_bank as jkb
from repro_torch.convert import kb_state_from_numpy, kb_state_to_numpy
from repro_torch.core import knowledge_bank as tkb
from repro_torch.core.async_runtime import KnowledgeBankServer
from repro_torch.core.kb_engine import (CudaBackend, DenseBackend, KBEngine,
                                        make_backend, make_kb_ops)
from repro_torch.kernels import ops

N, D = 200, 16
LAZY_LR, ZMAX = 0.2, 2.0
EXACT = ("version", "grad_cnt", "step")


def start_leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {"table": (0.5 * rng.standard_normal((N, D))).astype(np.float32),
            "version": np.zeros(N, np.int32),
            "grad_sum": np.zeros((N, D), np.float32),
            "grad_cnt": np.zeros(N, np.float32),
            "grad_sqnorm": np.zeros(N, np.float32),
            "norm_ema": np.zeros(N, np.float32),
            "step": np.zeros((), np.int32)}


def engines(port_backend, jax_backend, lazy_update=True, seed=0):
    leaves = start_leaves(seed)
    port = KBEngine(N, D, backend=port_backend, lazy_lr=LAZY_LR, zmax=ZMAX,
                    lazy_update=lazy_update, device="cpu")
    port.load_state(leaves)
    ref = JaxEngine(N, D, backend=jax_backend, lazy_lr=LAZY_LR, zmax=ZMAX,
                    lazy_update=lazy_update)
    ref.state = jkb.KBState(**{f: jnp.asarray(leaves[f])
                               for f in jkb.KBState._fields})
    return port, ref


def assert_same_state(port, ref, label=""):
    got = kb_state_to_numpy(port.state)
    for f in jkb.KBState._fields:
        want = np.asarray(getattr(ref.state, f))
        if f in EXACT:
            np.testing.assert_array_equal(got[f], want, err_msg=f"{label} {f}")
        else:
            np.testing.assert_allclose(got[f], want, atol=1e-6, rtol=0,
                                       err_msg=f"{label} {f}")


def assert_nn_close(got, want, label=""):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_allclose(gs, ws, atol=1e-5, err_msg=f"{label} scores")
    gap = np.concatenate([ws[:, :-1] - ws[:, 1:],
                          np.full((len(ws), 1), np.inf)], 1)
    decided = (gap > 1e-4) & (np.roll(gap, 1, 1) > 1e-4)
    np.testing.assert_array_equal(gi[decided], wi[decided],
                                  err_msg=f"{label} ids")


@pytest.mark.parametrize("port_backend,jax_backend,lazy_update", [
    ("cuda", "pallas", True),       # the kernel path against Pallas
    ("dense", "dense", True),
    ("cuda", "dense", False),       # the immediate-update ablation: gather
])
def test_engine_op_stream_matches_jax(port_backend, jax_backend,
                                      lazy_update):
    """Awkward batch sizes (pow2 padding inside), duplicate ids, updates
    with last-writer-wins, flush, nn_search with and without exclusion:
    same results, same state, same dispatch count."""
    port, ref = engines(port_backend, jax_backend, lazy_update)
    rng = np.random.default_rng(1)
    for size in (1, 3, 5, 9, 17):
        ids = rng.integers(0, N, size)
        ids[size // 2:] = ids[:size - size // 2]           # duplicates
        g = (0.1 * rng.standard_normal((size, D))).astype(np.float32)
        for eng in (port, ref):
            eng.lazy_grad(ids, g)
        np.testing.assert_allclose(port.lookup(ids), ref.lookup(ids),
                                   atol=1e-5, err_msg=f"lookup {size}")
        assert_same_state(port, ref, f"size {size}")
    upd_ids = np.array([4, 4, 9, 150])
    vals = rng.standard_normal((4, D)).astype(np.float32)
    for eng in (port, ref):
        eng.update(upd_ids, vals)
        eng.lazy_grad(upd_ids[::-1], np.ones((4, D), np.float32) * 0.05)
        eng.flush()
    assert_same_state(port, ref, "after flush")
    q = rng.standard_normal((5, D)).astype(np.float32)
    assert_nn_close(port.nn_search(q, 6), ref.nn_search(q, 6), "nn")
    best = np.argmax(q @ port.table_snapshot().T, 1)
    excl = np.stack([best, np.full(5, -1)], 1)
    assert_nn_close(port.nn_search(q, 6, exclude_ids=excl),
                    ref.nn_search(q, 6, exclude_ids=excl), "nn excl")
    np.testing.assert_array_equal(port.version_snapshot(),
                                  ref.version_snapshot())
    np.testing.assert_allclose(port.table_snapshot(), ref.table_snapshot(),
                               atol=1e-6)
    assert port.dispatches == ref.dispatches


def test_cuda_backend_excludes_through_the_kernel_search(monkeypatch):
    """CudaBackend.nn_search with exclude_ids over-fetches k + E through
    the kernel wrapper (never the plain dense search) and matches the
    dense masked top-k."""
    calls = []
    search = ops.nn_search

    def spy(queries, bank, k):
        calls.append(k)
        return search(queries, bank, k)

    monkeypatch.setattr(ops, "nn_search", spy)
    monkeypatch.setattr(tkb, "kb_nn_search", None)   # must not be reached
    rng = np.random.default_rng(2)
    leaves = start_leaves(2)
    st = kb_state_from_numpy(leaves, "cpu")
    q = torch.from_numpy(rng.standard_normal((4, D)).astype(np.float32))
    full = torch.argsort(-(q @ st.table.T), dim=1, stable=True)
    excl = torch.stack([full[:, 0], full[:, 2], torch.full((4,), -1)], 1)
    got = CudaBackend().nn_search(st, q, 5, exclude_ids=excl)
    assert calls == [8]
    monkeypatch.undo()
    want = DenseBackend().nn_search(st, q, 5, exclude_ids=excl)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-6)
    jax_want = jkb.kb_nn_search(
        jkb.KBState(**{f: jnp.asarray(leaves[f])
                       for f in jkb.KBState._fields}),
        jnp.asarray(q.numpy()), 5, exclude_ids=jnp.asarray(excl.numpy()))
    assert_nn_close((got[0].numpy(), got[1].numpy()),
                    tuple(np.asarray(a) for a in jax_want))


@pytest.mark.parametrize("lazy_update", [True, False])
def test_warmup_never_touches_the_live_state(lazy_update):
    """The JAX warm-up runs lookups on the live state and drops them; an
    in-place engine must not, or row 0's pending gradients would apply."""
    eng = KBEngine(N, D, lazy_update=lazy_update, device="cpu")
    eng.load_state(start_leaves(3))
    eng.lazy_grad(np.array([0, 0, 7]), np.ones((3, D), np.float32))
    before = kb_state_to_numpy(eng.state)
    eng.warmup(64)
    after = kb_state_to_numpy(eng.state)
    for f in before:
        np.testing.assert_array_equal(after[f], before[f], err_msg=f)
    assert eng.dispatches == 1


def test_update_last_writer_wins_and_empty_batches():
    eng = KBEngine(N, D, device="cpu")
    eng.update(np.array([4, 4, 9]), np.stack([np.full(D, 1.0),
                                              np.full(D, 2.0),
                                              np.full(D, 3.0)]))
    tbl = eng.table_snapshot()
    assert (tbl[4] == 2.0).all() and (tbl[9] == 3.0).all()
    assert eng.version_snapshot()[4] == 1
    assert eng.lookup(np.zeros((0,), np.int64)).shape == (0, D)
    eng.update(np.zeros((0,), np.int64), np.zeros((0, D)))
    eng.lazy_grad(np.zeros((0,), np.int64), np.zeros((0, D)))
    np.testing.assert_array_equal(eng.table_snapshot(), tbl)
    assert eng.dispatches == 1


def test_kb_ops_facade_binds_the_knobs():
    leaves = start_leaves(4)
    kb_ops = make_kb_ops(backend="cuda", lazy_lr=LAZY_LR, zmax=ZMAX)
    assert kb_ops.backend_name == "cuda"
    st = kb_state_from_numpy(leaves, "cpu")
    ref = kb_state_from_numpy(leaves, "cpu")
    ids = torch.tensor([1, 5, 1])
    g = torch.full((3, D), 0.1)
    st = kb_ops.lazy_grad(st, ids, g)
    ref = tkb.kb_lazy_grad(ref, ids, g, zmax=ZMAX)
    v, st = kb_ops.lookup(st, ids)
    rv, ref = tkb.kb_lookup(ref, ids, lazy_lr=LAZY_LR, zmax=ZMAX)
    assert torch.equal(v, rv)
    st = kb_ops.flush(st)
    ref = tkb.kb_flush(ref, lazy_lr=LAZY_LR, zmax=ZMAX)
    for a, b in zip(st, ref):
        assert torch.equal(a, b)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        KBEngine(N, D, storage="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        KBEngine(N, D, resident_rows=16, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        KBEngine(N, D, search_mode="ivf", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_backend("sharded")
    with pytest.raises(ValueError):
        make_backend("pallas")
    eng = KBEngine(N, D, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.nn_search(np.zeros((1, D), np.float32), 2, mode="ivf")
    with pytest.raises(ValueError):
        eng.load_state(start_leaves() | {"table": np.zeros((N, D + 1))})


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """The default backend is the kernel backend and the default device is
    CUDA; without a card the default raises instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KBEngine(N, D)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KnowledgeBankServer(N, D)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkb.kb_create(N, D)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kb_state_from_numpy(start_leaves())
    eng = KBEngine(N, D, device="cpu")
    assert eng.backend.name == "cuda"
    assert eng.state.table.device.type == "cpu"
