"""The port's Knowledge Bank semantics (repro_torch.core.knowledge_bank)
held against the JAX reference (repro.core.knowledge_bank) on the same
numpy inputs, on the CPU.

Tolerances, as tests/test_kb_engine.py:32-82 holds the JAX backends to each
other: version, step and grad_cnt exact; table, grad_sum, grad_sqnorm and
norm_ema atol 1e-6; lookup values and nn scores atol 1e-5; nn ids exact on
the queries whose k-th and (k+1)-th scores are more than 1e-4 apart (the
two packages sum in different orders, so nearer ties may flip).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knowledge_bank as jkb
from repro_torch.convert import kb_state_from_numpy, kb_state_to_numpy
from repro_torch.core import knowledge_bank as tkb

N, D = 300, 24
EXACT = ("version", "grad_cnt", "step")


def random_leaves(rng, n=N, d=D):
    """A bank mid-flight: random rows, a third of them with pending
    gradients, a norm EMA on half of them. Gradient leaves stay below ~4,
    where an fp32 ulp is under the 1e-6 tolerance: the two packages reduce
    a row's squares in different orders."""
    pending = rng.random(n) < 0.33
    cnt = np.where(pending, rng.integers(1, 4, n), 0).astype(np.float32)
    gsum = (0.1 * rng.standard_normal((n, d))
            * cnt[:, None]).astype(np.float32)
    gsq = ((gsum ** 2).sum(1) / np.maximum(cnt, 1)
           * rng.uniform(0.05, 2.0, n)).astype(np.float32)
    ema = np.where(rng.random(n) < 0.5, rng.uniform(0.01, 0.5, n), 0.0)
    return {"table": rng.standard_normal((n, d)).astype(np.float32),
            "version": rng.integers(0, 5, n).astype(np.int32),
            "grad_sum": gsum, "grad_cnt": cnt, "grad_sqnorm": gsq,
            "norm_ema": ema.astype(np.float32),
            "step": np.array(3, np.int32)}


def jax_state(leaves):
    return jkb.KBState(**{f: jnp.asarray(leaves[f])
                          for f in jkb.KBState._fields})


def jax_leaves(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def assert_leaves_close(got, want, label=""):
    assert set(got) == set(want)
    for f in want:
        if f in EXACT:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"{label}: {f}")
        else:
            np.testing.assert_allclose(got[f], want[f], atol=1e-6, rtol=0,
                                       err_msg=f"{label}: {f}")


def assert_nn_close(got, want, label=""):
    """Scores atol 1e-5; ids exact where the reference's consecutive
    scores around them are more than 1e-4 apart."""
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_allclose(gs, ws, atol=1e-5, err_msg=f"{label} scores")
    gap = np.concatenate([ws[:, :-1] - ws[:, 1:],
                          np.full((len(ws), 1), np.inf)], 1)
    decided = (gap > 1e-4) & (np.roll(gap, 1, 1) > 1e-4)
    np.testing.assert_array_equal(np.asarray(gi)[decided],
                                  np.asarray(wi)[decided],
                                  err_msg=f"{label} ids")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_stream_matches_jax(seed):
    """Every fp32 op, in a random order, on duplicate ids: same outputs and
    same state leaves after each op."""
    rng = np.random.default_rng(seed)
    leaves = random_leaves(rng)
    js, ts = jax_state(leaves), kb_state_from_numpy(leaves, "cpu")
    lazy_lr, zmax = 0.2, 2.0
    for step in range(14):
        op = rng.choice(["lazy_grad", "lookup", "peek", "update", "flush",
                         "nn"])
        b = int(rng.choice([1, 6, 16]))     # few shapes: few JAX compiles
        ids = rng.integers(0, N, b)
        ids[b // 2:] = ids[:b - b // 2]               # duplicates
        label = f"seed {seed} step {step} {op}"
        if op == "lazy_grad":
            ez = float(rng.choice([0.0, 2.0]))
            scale = float(rng.choice([0.05, 0.2]))
            clipped = np.flatnonzero(ts.norm_ema.numpy() > 0)
            if ez and clipped.size:
                # outliers, on rows whose EMA clips them back
                scale, ids = 20.0, rng.choice(clipped, b)
                ids[b // 2:] = ids[:b - b // 2]
            g = (scale * rng.standard_normal((b, D))).astype(np.float32)
            mask = (rng.random(b) < 0.8).astype(np.float32)
            js = jkb.kb_lazy_grad(js, jnp.asarray(ids), jnp.asarray(g),
                                  zmax=ez, mask=jnp.asarray(mask))
            ts = tkb.kb_lazy_grad(ts, torch.from_numpy(ids),
                                  torch.from_numpy(g), zmax=ez,
                                  mask=torch.from_numpy(mask))
        elif op in ("lookup", "peek"):
            jv, js = jkb.kb_lookup(js, jnp.asarray(ids), lazy_lr=lazy_lr,
                                   zmax=zmax, apply_pending=op == "lookup")
            tv, ts = tkb.kb_lookup(ts, torch.from_numpy(ids),
                                   lazy_lr=lazy_lr, zmax=zmax,
                                   apply_pending=op == "lookup")
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                                       err_msg=label)
        elif op == "update":
            u = np.unique(ids)
            v = rng.standard_normal((u.size, D)).astype(np.float32)
            js = jkb.kb_update(js, jnp.asarray(u), jnp.asarray(v))
            ts = tkb.kb_update(ts, torch.from_numpy(u), torch.from_numpy(v))
        elif op == "flush":
            js = jkb.kb_flush(js, lazy_lr=lazy_lr, zmax=zmax)
            ts = tkb.kb_flush(ts, lazy_lr=lazy_lr, zmax=zmax)
        else:
            q = rng.standard_normal((b, D)).astype(np.float32)
            excl = None
            if rng.random() < 0.5:
                # -1 entries are inert; row N-1 is left out, because the
                # JAX scatter would also write -1's False onto it
                excl = rng.integers(0, N - 1, (b, 3))
                excl[:, 2] = -1
            jout = jkb.kb_nn_search(
                js, jnp.asarray(q), 5,
                exclude_ids=None if excl is None else jnp.asarray(excl))
            tout = tkb.kb_nn_search(
                ts, torch.from_numpy(q), 5,
                exclude_ids=None if excl is None else torch.from_numpy(excl))
            assert_nn_close((tout[0].numpy(), tout[1].numpy()),
                            tuple(np.asarray(a) for a in jout), label)
        assert_leaves_close(kb_state_to_numpy(ts), jax_leaves(js), label)


@pytest.mark.parametrize("scale", [1e-14, 1e-7, 1.0, 1e4])
def test_pending_delta_matches_jax(scale):
    """The clip at every magnitude, tiny norms included: rows below the
    1e-12 floors, rows clipped, rows not clipped, empty caches."""
    rng = np.random.default_rng(5)
    n = 64
    cnt = rng.integers(0, 4, n).astype(np.float32)
    gsum = (rng.standard_normal((n, D)) * scale).astype(np.float32)
    gsq = ((gsum.astype(np.float64) ** 2).sum(1)
           * rng.uniform(0.01, 3.0, n)).astype(np.float32)
    want = jkb.pending_delta(jnp.asarray(gsum), jnp.asarray(cnt),
                             jnp.asarray(gsq), lazy_lr=0.3, zmax=1.5)
    got = tkb.pending_delta(torch.from_numpy(gsum), torch.from_numpy(cnt),
                            torch.from_numpy(gsq), lazy_lr=0.3, zmax=1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    assert not got.numpy()[cnt == 0].any()


def test_lazy_grad_is_bit_identical_under_duplicates():
    """Duplicates are added in occurrence order, without atomics: two runs
    of the same call give the same bits, and each leaf matches JAX's
    scatter-add within the tolerances."""
    rng = np.random.default_rng(11)
    leaves = random_leaves(rng)
    ids = rng.integers(0, 16, 200)                   # heavy duplication
    g = (0.05 * rng.standard_normal((200, D))).astype(np.float32)
    runs = [kb_state_to_numpy(tkb.kb_lazy_grad(
        kb_state_from_numpy(leaves, "cpu"), torch.from_numpy(ids),
        torch.from_numpy(g), zmax=2.0)) for _ in range(2)]
    for f in runs[0]:
        assert np.array_equal(runs[0][f], runs[1][f]), f
    want = jkb.kb_lazy_grad(jax_state(leaves), jnp.asarray(ids),
                            jnp.asarray(g), zmax=2.0)
    got, want = runs[0], jax_leaves(want)
    for f in ("grad_sum", "grad_sqnorm", "norm_ema"):
        np.testing.assert_allclose(got[f], want[f], atol=1e-6, rtol=0,
                                   err_msg=f)
    for f in EXACT + ("table",):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_lazy_grad_duplicate_ids_keep_ema_bounded():
    """m duplicates of a row in one call move the norm EMA by ONE step."""
    kb = tkb.kb_create(N, D, device="cpu")
    ids = torch.full((12,), 5)
    g = torch.ones((12, D))
    kb = tkb.kb_lazy_grad(kb, ids, g, zmax=2.0)
    ema = float(kb.norm_ema[5])
    assert ema == pytest.approx(float(D))
    kb = tkb.kb_lazy_grad(kb, ids, 0.1 * g, zmax=2.0)
    assert 0.0 < float(kb.norm_ema[5]) < ema
    assert float(kb.grad_cnt[5]) == 24.0


def test_index_add_in_order_matches_sequential_adds():
    """Bit for bit the loop ``target[ids[i]] += vals[i]`` in order."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 40, 500)
    vals = rng.standard_normal((500, 3)).astype(np.float32)
    want = rng.standard_normal((40, 3)).astype(np.float32)
    got = torch.from_numpy(want.copy())
    t_ids = torch.from_numpy(ids)
    rounds = tkb.occurrence_rounds(t_ids)
    assert len(rounds) == np.bincount(ids).max()
    tkb.index_add_in_order(got, t_ids, torch.from_numpy(vals), rounds)
    for i in range(ids.size):
        want[ids[i]] += vals[i]
    np.testing.assert_array_equal(got.numpy(), want)


def test_kb_create_zero_and_seeded():
    kb = tkb.kb_create(N, D, device="cpu")
    assert kb.table.shape == (N, D) and kb.table.dtype == torch.float32
    assert kb.version.dtype == torch.int32 and kb.step.shape == ()
    assert not any(bool(t.any()) for t in kb)
    a = tkb.kb_create(N, D, device="cpu",
                      generator=torch.Generator().manual_seed(4))
    b = tkb.kb_create(N, D, device="cpu",
                      generator=torch.Generator().manual_seed(4))
    assert torch.equal(a.table, b.table)
    assert 0.008 < float(a.table.std()) < 0.012


def test_convert_round_trip_copies():
    leaves = random_leaves(np.random.default_rng(2))
    st = kb_state_from_numpy(leaves, "cpu")
    back = kb_state_to_numpy(st)
    for f in leaves:
        np.testing.assert_array_equal(back[f], leaves[f])
        assert back[f].dtype == leaves[f].dtype
    st.table.zero_()                    # the dict holds copies, not views
    np.testing.assert_array_equal(back["table"], leaves["table"])
    with pytest.raises(ValueError, match="missing"):
        kb_state_from_numpy({"table": leaves["table"]}, "cpu")
