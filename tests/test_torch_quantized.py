"""The port's int8 storage held against the JAX package on the CPU, on the
same numpy inputs: the int8 twins of repro.core.knowledge_bank, the plain
version of the int8 fused lookup against the Pallas kernel
(kb_fused_lookup_q_pallas, interpret mode), and the int8 engine against
the JAX engine (dense, and the kernel backend against "pallas").

Tolerances: scale and offset rtol 1e-6 / atol 1e-6 (tests/test_kb_quantized.py
:61-62); dequantized values atol 1e-5; versions exact; codes equal, except
that a code may differ by 1 where the JAX value (v - offset) / scale lies
within 1e-4 of a half-integer (the clip's sum of squares runs in another
order, so such a value may round the other way), and those are counted; a
repeated read-only lookup bit-identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KBEngine as JaxEngine
from repro.core import knowledge_bank as jkb
from repro.kernels.kb_fused_lookup import kb_fused_lookup_q_pallas
from repro_torch.convert import kb_state_to_numpy
from repro_torch.core import knowledge_bank as tkb
from repro_torch.core.kb_engine import KBEngine
from repro_torch.kernels import ops

N, D = 257, 32
LAZY_LR, ZMAX = 0.2, 2.0
HALF_TOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def rows_with_constants(rng, n, d):
    rows = rng.standard_normal((n, d)).astype(np.float32)
    rows[1] = 3.25                                # constant rows: scale 1
    rows[2] = 0.0
    return rows


def codes_agree(got, want, prequant, off, scale, label=""):
    """Codes equal, or off by one where the JAX value sits within
    HALF_TOL of a half-integer. Returns the count of the latter."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    diff = np.abs(got - want)
    x = ((np.asarray(prequant, np.float64) - np.asarray(off)[..., None])
         / np.asarray(scale)[..., None])
    near_half = np.abs(np.abs(x - np.floor(x)) - 0.5) < HALF_TOL
    bad = (diff > 1) | ((diff == 1) & ~near_half)
    assert not bad.any(), f"{label}: {int(bad.sum())} codes disagree"
    return int((diff == 1).sum())


# ---------------------------------------------------------------------------
# the int8 twins
# ---------------------------------------------------------------------------

def test_quantize_and_dequantize_match_jax():
    rows = rows_with_constants(np.random.default_rng(0), 64, D)
    c, s, o = tkb.quantize_rows(t(rows))
    jc, js, jo = map(np.asarray, jkb.quantize_rows(jnp.asarray(rows)))
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(o.numpy(), jo, rtol=1e-6, atol=1e-6)
    codes_agree(c.numpy(), jc, rows, jo, js, "quantize")
    assert c.dtype == torch.int8 and s[1] == 1.0 and not c[1:3].any()
    back = tkb.dequantize_rows(c, s, o).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jkb.dequantize_rows(jc, js, jo)), atol=1e-5)
    np.testing.assert_array_equal(back[1], rows[1])       # exact constant
    # re-quantizing a dequantized row gives back its codes
    c2, _, _ = tkb.quantize_rows(torch.from_numpy(back))
    assert torch.equal(c, c2)


def test_quantized_scores_match_jax():
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((5, D)).astype(np.float32)
    c, s, o = tkb.quantize_rows(t(rows))
    got = tkb.quantized_scores(t(q), c, s, o).numpy()
    want = np.asarray(jkb.quantized_scores(jnp.asarray(q), jnp.asarray(
        c.numpy()), jnp.asarray(s.numpy()), jnp.asarray(o.numpy())))
    np.testing.assert_allclose(got, want, atol=1e-5)


def quantized_state(seed, n=N, d=D, pending_share=0.4):
    """Numpy leaves of an int8 bank with pending gradients (some past the
    clip), plus its scale and offset."""
    rng = np.random.default_rng(seed)
    codes, s, o = map(np.asarray, jkb.quantize_rows(
        jnp.asarray(rows_with_constants(rng, n, d))))
    pending = rng.random(n) < pending_share
    cnt = np.where(pending, rng.integers(1, 4, n), 0).astype(np.float32)
    gsum = (0.1 * rng.standard_normal((n, d)) * cnt[:, None]).astype(
        np.float32)
    gsq = ((gsum.astype(np.float64) ** 2).sum(1) / np.maximum(cnt, 1)
           * rng.uniform(0.02, 2.0, n)).astype(np.float32)
    return {"table": codes, "version": np.zeros(n, np.int32),
            "grad_sum": gsum, "grad_cnt": cnt, "grad_sqnorm": gsq,
            "norm_ema": np.zeros(n, np.float32),
            "step": np.zeros((), np.int32), "scale": s, "offset": o}


def jax_state(leaves):
    return (jkb.KBState(**{f: jnp.asarray(leaves[f])
                           for f in jkb.KBState._fields}),
            jnp.asarray(leaves["scale"]), jnp.asarray(leaves["offset"]))


def torch_state(leaves):
    return (tkb.KBState(**{f: t(leaves[f]) for f in tkb.KBState._fields}),
            t(leaves["scale"]), t(leaves["offset"]))


def prequant_rows(leaves, rows):
    """What the JAX op re-quantizes for ``rows``: dequant + pending delta."""
    st, s, o = jax_state(leaves)
    return np.asarray(jkb.dequantize_rows(st.table[rows], s[rows], o[rows])
                      + jkb.pending_delta(st.grad_sum[rows],
                                          st.grad_cnt[rows],
                                          st.grad_sqnorm[rows],
                                          lazy_lr=LAZY_LR, zmax=ZMAX))


def assert_same_q(got, want, leaves, rows, label):
    """Port state (KBState, s, o) against the JAX one after an op that
    re-quantized ``rows`` from ``leaves``."""
    (gst, gs, go), (wst, ws, wo) = got, want
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6,
                               atol=1e-6, err_msg=f"{label} scale")
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=1e-6,
                               atol=1e-6, err_msg=f"{label} offset")
    gc, wc = gst.table.numpy(), np.asarray(wst.table)
    n_half = codes_agree(gc[rows], wc[rows], prequant_rows(leaves, rows),
                         np.asarray(wo)[rows], np.asarray(ws)[rows], label)
    others = np.setdiff1d(np.arange(gc.shape[0]), rows)
    np.testing.assert_array_equal(gc[others], wc[others])
    for f in ("version", "grad_cnt", "step"):
        np.testing.assert_array_equal(getattr(gst, f).numpy(),
                                      np.asarray(getattr(wst, f)), f)
    for f in ("grad_sum", "grad_sqnorm", "norm_ema"):
        np.testing.assert_allclose(getattr(gst, f).numpy(),
                                   np.asarray(getattr(wst, f)), atol=1e-6)
    return n_half


def test_kb_lookup_q_update_q_flush_q_match_jax():
    leaves = quantized_state(2)
    ids = np.array([5, 9, 5, 1, 200, 256, 9, 0, 33])
    # lookup
    st, s, o = torch_state(leaves)
    vals, st = tkb.kb_lookup_q(st, s, o, t(ids), lazy_lr=LAZY_LR, zmax=ZMAX)
    jvals, jst, js, jo = jkb.kb_lookup_q(*jax_state(leaves), jnp.asarray(ids),
                                         lazy_lr=LAZY_LR, zmax=ZMAX)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-5)
    assert_same_q((st, s, o), (jst, js, jo), leaves, np.unique(ids),
                  "lookup_q")
    # update
    st, s, o = torch_state(leaves)
    new = np.random.default_rng(3).standard_normal((4, D)).astype(np.float32)
    tkb.kb_update_q(st, s, o, t(ids[:4][::-1]), t(new))
    jst, js, jo = jkb.kb_update_q(*jax_state(leaves),
                                  jnp.asarray(ids[:4][::-1].copy()),
                                  jnp.asarray(new))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(st.table.numpy(), np.asarray(jst.table))
    np.testing.assert_array_equal(st.version.numpy(), np.asarray(jst.version))
    # flush
    st, s, o = torch_state(leaves)
    tkb.kb_flush_q(st, s, o, lazy_lr=LAZY_LR, zmax=ZMAX)
    jst, js, jo = jkb.kb_flush_q(*jax_state(leaves), lazy_lr=LAZY_LR,
                                 zmax=ZMAX)
    assert_same_q((st, s, o), (jst, js, jo), leaves,
                  np.flatnonzero(leaves["grad_cnt"] > 0), "flush_q")


def test_kb_nn_search_q_matches_jax_with_exclusion():
    leaves = quantized_state(4)
    q = np.random.default_rng(5).standard_normal((4, D)).astype(np.float32)
    excl = np.array([[3, -1], [7, 8], [-1, -1], [0, 1]])
    st, s, o = torch_state(leaves)
    gs, gi = tkb.kb_nn_search_q(st, s, o, t(q), 6, exclude_ids=t(excl))
    ws, wi = jkb.kb_nn_search_q(*jax_state(leaves), jnp.asarray(q), 6,
                                exclude_ids=jnp.asarray(excl))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# ---------------------------------------------------------------------------
# kernel #5's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,b", [(257, 32, 9), (64, 16, 40), (300, 8, 1)])
def test_fused_lookup_q_plain_matches_pallas(n, d, b):
    """Duplicates, a -1 padding id, constant rows, rows past the clip."""
    leaves = quantized_state(n + b, n, d)
    rng = np.random.default_rng(b)
    ids = rng.integers(0, n, b)
    ids[b // 2:] = ids[:b - b // 2]
    ids[0], ids[-1] = 1, -1 if b > 1 else ids[-1]
    st, s, o = torch_state(leaves)
    got = ops.kb_fused_lookup_q(st.table, s, o, st.grad_sum, st.grad_cnt,
                                st.grad_sqnorm, t(ids), lazy_lr=LAZY_LR,
                                zmax=ZMAX)
    jst, js, jo = jax_state(leaves)
    vals, tbl, ws, wo, gsum, gcnt, gsq = kb_fused_lookup_q_pallas(
        jst.table, js, jo, jst.grad_sum, jst.grad_cnt, jst.grad_sqnorm,
        jnp.asarray(ids, jnp.int32), lazy_lr=LAZY_LR, zmax=ZMAX,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(vals), atol=1e-5)
    if b > 1:
        assert not got[-1].any()                 # -1 reads zeros
    want = (jst._replace(table=tbl, grad_sum=gsum, grad_cnt=gcnt,
                         grad_sqnorm=gsq), ws, wo)
    rows = np.unique(ids[ids >= 0])
    assert_same_q((st, s, o), want, leaves, rows, "fused_q")


def test_fused_lookup_q_keeps_rows_without_pending_gradients_exact():
    """A row with no pending gradient keeps its exact codes, scale and
    offset, and a repeated lookup returns the same bits."""
    leaves = quantized_state(6, pending_share=0.0)
    leaves["grad_sum"][:] = 0.0
    st, s, o = torch_state(leaves)
    before = [a.clone() for a in (st.table, s, o)]
    ids = t(np.array([4, 4, 100, 2]))
    a = ops.kb_fused_lookup_q(st.table, s, o, st.grad_sum, st.grad_cnt,
                              st.grad_sqnorm, ids, lazy_lr=LAZY_LR,
                              zmax=ZMAX)
    b = ops.kb_fused_lookup_q(st.table, s, o, st.grad_sum, st.grad_cnt,
                              st.grad_sqnorm, ids, lazy_lr=LAZY_LR,
                              zmax=ZMAX)
    assert torch.equal(a, b)
    for x, y in zip((st.table, s, o), before):
        assert torch.equal(x, y)
    assert torch.equal(a[0], tkb.dequantize_rows(before[0][4], before[1][4],
                                                 before[2][4]))


def test_fused_lookup_q_wrapper_refuses_what_the_kernel_does_not_take():
    leaves = quantized_state(7, 16, 8)
    st, s, o = torch_state(leaves)
    # a CUDA launcher never takes CPU tensors (no fallback inside it)
    with pytest.raises(ValueError, match="lies on cpu"):
        ops.LAUNCHERS["kb_fused_lookup_q"](
            st.table, s, o, st.grad_sum, st.grad_cnt, st.grad_sqnorm,
            t(np.array([1])), lazy_lr=LAZY_LR, zmax=ZMAX)


# ---------------------------------------------------------------------------
# the int8 engine against the JAX engine
# ---------------------------------------------------------------------------

def engines(port_backend, jax_backend, leaves, **kw):
    port = KBEngine(N, D, backend=port_backend, lazy_lr=LAZY_LR, zmax=ZMAX,
                    storage="int8", device="cpu", **kw)
    port.load_state(leaves)
    ref_eng = JaxEngine(N, D, backend=jax_backend, lazy_lr=LAZY_LR,
                        zmax=ZMAX, storage="int8", **kw)
    ref_eng.state, ref_eng._qscale, ref_eng._qoffset = jax_state(leaves)
    return port, ref_eng


def leaves_of(eng):
    """Numpy leaves (with scale/offset) of a port or JAX int8 engine."""
    if isinstance(eng, KBEngine):
        out = kb_state_to_numpy(eng.state)
    else:
        out = {f: np.array(getattr(eng.state, f))
               for f in jkb.KBState._fields}
    out["scale"] = np.array(eng._qscale)
    out["offset"] = np.array(eng._qoffset)
    return out


@pytest.mark.parametrize("port_backend,jax_backend", [
    ("cuda", "pallas"),         # kernel #5's contract against Pallas
    ("dense", "dense"),
])
def test_int8_engine_op_stream_matches_jax(port_backend, jax_backend):
    """Each op from one shared state: awkward batch sizes, duplicates,
    update with masters, flush, exact search with the master re-rank. The
    port is re-synced to the JAX state after each op, so that a code
    rounded the other way at a half-integer does not carry on."""
    port, jeng = engines(port_backend, jax_backend, quantized_state(8),
                         master_rows=16)
    rng = np.random.default_rng(9)
    n_half = 0
    for size in (1, 3, 5, 9, 17):
        ids = rng.integers(0, N, size)
        ids[size // 2:] = ids[:size - size // 2]
        g = (0.1 * rng.standard_normal((size, D))).astype(np.float32)
        for eng in (port, jeng):
            eng.lazy_grad(ids, g)
        before = leaves_of(jeng)
        np.testing.assert_allclose(port.lookup(ids), jeng.lookup(ids),
                                   atol=1e-5, err_msg=f"lookup {size}")
        n_half += assert_same_q(
            (port.state, port._qscale, port._qoffset),
            (jeng.state, jeng._qscale, jeng._qoffset), before,
            np.unique(ids), f"lookup {size}")
        port.load_state(leaves_of(jeng))
    upd = np.array([4, 4, 9, 150, 33])
    vals = rng.standard_normal((5, D)).astype(np.float32)
    for eng in (port, jeng):
        eng.update(upd, vals)
        eng.lazy_grad(upd[2:3], np.full((1, D), 0.05, np.float32))
    np.testing.assert_array_equal(port.state.table.numpy(),
                                  np.asarray(jeng.state.table))
    assert list(port._masters) == list(jeng._masters)
    before = leaves_of(jeng)
    for eng in (port, jeng):
        eng.flush()
    n_half += assert_same_q((port.state, port._qscale, port._qoffset),
                            (jeng.state, jeng._qscale, jeng._qoffset),
                            before, np.flatnonzero(before["grad_cnt"] > 0),
                            "flush")
    port.load_state(leaves_of(jeng))
    q = rng.standard_normal((5, D)).astype(np.float32)
    q[0] = vals[0]                          # a master among the winners
    (ps, pi), (ws, wi) = port.nn_search(q, 6), jeng.nn_search(q, 6)
    np.testing.assert_allclose(ps, ws, atol=1e-5)
    np.testing.assert_array_equal(pi, wi)
    excl = np.stack([wi[:, 0], np.full(5, -1)], 1)
    (ps, pi), (ws, wi) = (port.nn_search(q, 6, exclude_ids=excl),
                          jeng.nn_search(q, 6, exclude_ids=excl))
    np.testing.assert_allclose(ps, ws, atol=1e-5)
    np.testing.assert_array_equal(pi, wi)
    np.testing.assert_allclose(port.table_snapshot(), jeng.table_snapshot(),
                               atol=1e-5)
    assert port.dispatches == jeng.dispatches
    # the count of codes rounded the other way at a half-integer
    assert n_half <= 4, n_half


def test_repeated_int8_lookup_is_bit_identical():
    eng = KBEngine(N, D, storage="int8", device="cpu")
    rng = np.random.default_rng(10)
    eng.update(np.arange(N), rng.standard_normal((N, D)).astype(np.float32))
    eng.lazy_grad(rng.integers(0, N, 32),
                  rng.standard_normal((32, D)).astype(np.float32))
    ids = rng.integers(0, N, 24)
    a = eng.lookup(ids)                 # applies, re-quantizes
    b = eng.lookup(ids)                 # reads only
    np.testing.assert_array_equal(a, b)


def test_int8_engine_contract():
    with pytest.raises(ValueError, match="lazy_update"):
        KBEngine(N, D, storage="int8", lazy_update=False, device="cpu")
    eng = KBEngine(N, D, storage="int8", device="cpu")
    assert eng.state.table.dtype == torch.int8
    assert not eng.table_snapshot().any()           # zero rows decode to 0
    vals = np.random.default_rng(11).standard_normal((N, D)).astype(
        np.float32)
    eng.update(np.arange(N), vals)
    snap = eng.table_snapshot()
    assert snap.dtype == np.float32 and np.abs(snap - vals).max() < 0.05
    st = eng.storage_stats()
    assert st["mode"] == "int8" and st["bytes_per_row"] == D + 8
    assert st["master_rows"] == N and st["bytes_resident"] == \
        (D + 8) * N + N * D * 4
    with pytest.raises(ValueError):
        eng.load_state(kb_state_to_numpy(
            KBEngine(N, D, device="cpu").state))      # fp32 table refused
    eng.warmup(16)                                  # int8 scratch warm-up
    np.testing.assert_array_equal(eng.table_snapshot(), snap)
