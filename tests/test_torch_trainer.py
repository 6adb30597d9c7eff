"""The port's trainer (repro_torch.core.trainer, core.knowledge_maker) held
against the JAX package's on the CPU, and the trainer modes' properties.

One step of each builder (and three more of the CARLS step, whose losses
and gradient norms are compared) runs in both packages on the reduced yi-6b (2
layers, d 128, fp32) from JAX-initialised parameters (``flatten_params``
-> ``lm_params_from_numpy``), one bank (``kb_state_from_numpy``: N(0,
0.01²) rows, a fifth of them with pending gradients, half with a norm
EMA) and one ``SyntheticGraphCorpus`` batch. The port runs its ``cuda``
backend, whose kernel wrappers take their plain versions on CPU tensors;
JAX its default (dense) backend under ``jax.jit``.

Bounds:

- metrics: atol 1e-5 + rtol 1e-5 (the reduced LM's bound; the loss is
  ~6.4); ``acc``, ``tokens`` and ``kb_pending`` exactly;
- the bank after the step: ``tests/test_kb_engine.py``'s, leaves atol
  1e-6, versions and the clock exactly;
- the neighbour gradient and the parameter gradients: atol 1e-6, the
  losses' bound (the parameter gradients are read off the step-1 first
  moment, m = (1 - b1) g);
- moments: atol 1e-6;
- post-step parameters: Adam's first step moves an entry by lr·g/(|g| +
  eps), which is ±lr wherever |g| >> eps = 1e-8, so an entry whose
  gradient is 0 up to rounding in one package can move by up to 2·lr
  against the other. Where the JAX gradient |g| exceeds T = 1e-5, ten
  times the gradient bound, both packages' gradients have one sign and
  their normalised steps differ by at most eps·1e-6/T² = 1e-4, lr·1e-4 =
  2e-7: there the parameters are held within atol 1e-6. Elsewhere (about
  16% of the entries here, most of them exactly 0 in both: embedding
  rows of tokens not in the batch) they are held within 2·lr + 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import flatten_params as jax_flatten
from repro.configs import get_config as jax_config
from repro.core import make_carls_train_step as jax_carls_step
from repro.core import make_embedding_refresh as jax_refresh
from repro.core.knowledge_bank import KBState as JaxKBState
from repro.core.trainer import make_async_train_fns as jax_async_fns
from repro.core.trainer import make_inline_baseline_step as jax_inline_step
from repro.data import SyntheticGraphCorpus as JaxCorpus
from repro.models import build_model as jax_build
from repro.optim import AdamW as JaxAdamW
from repro.optim import constant_lr as jax_constant_lr
from repro.sharding.partition import DistContext
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.kb_engine import make_kb_ops
from repro_torch.core.knowledge_bank import kb_create, kb_update
from repro_torch.core.knowledge_maker import (make_embed_fn,
                                              make_embedding_refresh)
from repro_torch.core.trainer import (make_async_train_fns,
                                      make_carls_train_step,
                                      make_inline_baseline_step)
from repro_torch.data import SyntheticGraphCorpus
from repro_torch.models import build_model
from repro_torch.optim import AdamW, AdamWState, constant_lr
from repro_torch.tree import tree_items, tree_map

ATOL, RTOL = 1e-5, 1e-5
LEAF_ATOL = GRAD_ATOL = 1e-6
LR, B1 = 2e-3, 0.9
SIGN_T = 10 * GRAD_ATOL
DIST = DistContext()


def _bank_leaves(N, D, seed=0):
    rng = np.random.default_rng(seed)
    pend = rng.random(N) < 0.2
    gsum = (rng.standard_normal((N, D)) * 0.01 * pend[:, None]).astype(
        np.float32)
    return dict(
        table=(rng.standard_normal((N, D)) * 0.01).astype(np.float32),
        version=np.zeros(N, np.int32), grad_sum=gsum,
        grad_cnt=np.where(pend, rng.integers(1, 3, N), 0).astype(
            np.float32),
        grad_sqnorm=(np.sum(gsum ** 2, -1) * 1.5).astype(np.float32),
        norm_ema=np.where(rng.random(N) < 0.5, 1e-4, 0.0).astype(
            np.float32),
        step=np.int32(3))


@pytest.fixture(scope="module")
def pair():
    """The reduced yi-6b in both packages on JAX's init, the bank's
    leaves and a batch of 4 (with the inline baseline's neighbour
    tokens)."""
    cfg = jax_config("yi-6b").reduced()
    jm = jax_build(cfg)
    jp = jm.init(jax.random.key(0))
    tcfg = get_config("yi-6b").reduced()
    corpus = JaxCorpus(num_nodes=cfg.carls.kb_entries,
                       vocab_size=cfg.vocab_size, seq_len=17,
                       neighbors_per_node=cfg.carls.num_neighbors)
    batch = corpus.batch(np.random.default_rng(1), 4)
    batch["neighbor_tokens"] = corpus.neighbor_tokens(batch["neighbor_ids"])
    return dict(jm=jm, jp=jp, tm=build_model(tcfg), flat=jax_flatten(jp),
                tcfg=tcfg, leaves=_bank_leaves(cfg.carls.kb_entries,
                                               cfg.d_model),
                batch=batch)


def _port(pair):
    """Fresh port copies of the parameters, an AdamW and its state."""
    tp = convert.lm_params_from_numpy(pair["flat"], pair["tcfg"],
                                      device="cpu")
    opt = AdamW(lr=constant_lr(LR))
    return tp, opt, opt.init(tp)


def _jax_opt(pair):
    opt = JaxAdamW(lr=jax_constant_lr(LR))
    return opt, opt.init(pair["jp"])


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, label, atol=ATOL, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=label)


def _check_metrics(tm, jm):
    assert set(tm) == set(jm)
    for k in jm:
        if k in ("acc", "tokens", "kb_pending"):
            assert float(tm[k]) == float(jm[k]), k
        else:
            _close(tm[k], jm[k], k)


def _check_step(tp, ts, jp, js):
    """Moments, gradients and parameters after step 1 (module doc)."""
    assert int(ts.count) == int(js.count) == 1
    for name in ("mu", "nu"):
        want = jax_flatten(getattr(js, name))
        got = dict(tree_items(getattr(ts, name)))
        for k, w in want.items():
            _close(got[k], w, f"{name} {k}", atol=LEAF_ATOL, rtol=0)
    mu_j = jax_flatten(js.mu)
    mu_t = dict(tree_items(ts.mu))
    pj = jax_flatten(jp)
    pt = dict(tree_items(tp))
    decided = 0
    for k, m in mu_j.items():
        g_j, g_t = m / (1 - B1), mu_t[k].numpy() / (1 - B1)
        _close(g_t, g_j, f"grad {k}", atol=GRAD_ATOL, rtol=0)
        sure = np.abs(g_j) > SIGN_T
        err = np.abs(pt[k].numpy() - pj[k])
        assert err[sure].max(initial=0) <= LEAF_ATOL, k
        assert err[~sure].max(initial=0) <= 2 * LR + LEAF_ATOL, k
        decided += int(sure.sum())
    assert decided > 0.8 * sum(m.size for m in mu_j.values())


def _check_bank(tkb, jkb):
    got = convert.kb_state_to_numpy(tkb)
    for f in JaxKBState._fields:
        want = np.asarray(getattr(jkb, f))
        if want.dtype.kind == "f":
            _close(got[f], want, f, atol=LEAF_ATOL, rtol=0)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)


@pytest.mark.parametrize("trainer_push", [True, False])
def test_carls_step_matches_jax(pair, jax_async, trainer_push):
    batch = {k: v for k, v in pair["batch"].items()
             if k != "neighbor_tokens"}
    jopt, jst = _jax_opt(pair)
    jkb = JaxKBState(**{k: jnp.asarray(v)
                        for k, v in pair["leaves"].items()})
    jstep = jax.jit(jax_carls_step(pair["jm"], jopt, DIST,
                                   trainer_push=trainer_push))
    jp, jst, jkb, jmet = jstep(pair["jp"], jst, jkb, _jb(batch))

    tp, topt, tst = _port(pair)
    tkb = convert.kb_state_from_numpy(pair["leaves"], device="cpu")
    grads = []
    cc = pair["tcfg"].carls
    base = make_kb_ops(backend="cuda", lazy_lr=cc.lazy_lr,
                       zmax=cc.outlier_zmax, apply_pending=cc.lazy_update)
    ops = base._replace(lazy_grad=lambda kb, ids, g: grads.append(g) or
                        base.lazy_grad(kb, ids, g))
    tstep = make_carls_train_step(pair["tm"], topt,
                                  trainer_push=trainer_push, kb_ops=ops)
    out = tstep(tp, tst, tkb, _tb(batch))
    assert out[0] is tp and out[1] is tst and out[2] is tkb   # in place
    _check_metrics(out[3], jmet)
    assert float(out[3]["kb_pending"]) > 0
    _check_bank(tkb, jkb)
    _check_step(tp, tst, jp, jst)
    # the neighbour gradient the step pushed to the lazy cache, against
    # JAX's for the same looked-up rows
    (gn,) = grads
    assert gn.shape == batch["neighbor_ids"].shape + (pair["tcfg"].d_model,)
    _close(gn, jax_async["gn"], "neighbour gradient", atol=GRAD_ATOL,
           rtol=0)
    ids = batch["sample_ids"]
    pushed = convert.kb_state_to_numpy(tkb)
    if trainer_push:     # the pooled embeddings, unit norm
        np.testing.assert_allclose(
            np.linalg.norm(pushed["table"][ids], axis=-1), 1.0, rtol=1e-5)
    # three more steps on fresh batches: the losses stay together
    corpus = SyntheticGraphCorpus(
        num_nodes=pair["tcfg"].carls.kb_entries,
        vocab_size=pair["tcfg"].vocab_size, seq_len=17,
        neighbors_per_node=pair["tcfg"].carls.num_neighbors)
    rng = np.random.default_rng(7)
    for _ in range(3):
        b = corpus.batch(rng, 4)
        jp, jst, jkb, jmet = jstep(jp, jst, jkb, _jb(b))
        tp, tst, tkb, met = tstep(tp, tst, tkb, _tb(b))
        for k in ("loss", "grad_norm"):
            _close(met[k], jmet[k], f"later step {k}")


@pytest.fixture(scope="module")
def jax_async(pair):
    """JAX's async core on the rows the step's lookup serves: the
    neighbour gradient both step tests hold the port's against."""
    batch = {k: v for k, v in pair["batch"].items()
             if k != "neighbor_tokens"}
    lk = convert.kb_state_from_numpy(pair["leaves"], device="cpu")
    nbr, _ = make_kb_ops(backend="cuda").lookup(
        lk, torch.from_numpy(batch["neighbor_ids"]))
    nbr = nbr.numpy()
    jopt, jst = _jax_opt(pair)
    jcore, jembed = (jax.jit(f) for f in jax_async_fns(pair["jm"], jopt,
                                                        DIST))
    jp, jst, jpooled, jgn, jmet = jcore(pair["jp"], jst, _jb(batch),
                                        jnp.asarray(nbr))
    toks = jnp.asarray(batch["tokens"])
    return dict(batch=batch, nbr=nbr, jp=jp, jst=jst, pooled=jpooled,
                gn=jgn, metrics=jmet, embed=jembed(jp, toks))


def test_async_train_fns_match_jax(pair, jax_async):
    batch, nbr = jax_async["batch"], jax_async["nbr"]
    tp, topt, tst = _port(pair)
    core, embed = make_async_train_fns(pair["tm"], topt)
    tp, tst, pooled, gn, met = core(tp, tst, _tb(batch),
                                    torch.from_numpy(nbr))
    _check_metrics(met, jax_async["metrics"])
    _close(pooled, jax_async["pooled"], "pooled")
    _close(gn, jax_async["gn"], "neighbour gradient", atol=GRAD_ATOL,
           rtol=0)
    _check_step(tp, tst, jax_async["jp"], jax_async["jst"])
    toks = torch.from_numpy(batch["tokens"])
    _close(embed(tp, toks), jax_async["embed"], "embed_fn")
    _close(make_embed_fn(pair["tm"])(tp, toks), jax_async["embed"],
           "make_embed_fn")


def test_inline_baseline_step_matches_jax(pair):
    K = pair["tcfg"].carls.num_neighbors
    jopt, jst = _jax_opt(pair)
    jstep = jax.jit(jax_inline_step(pair["jm"], jopt, DIST,
                                    num_neighbors=K))
    jp, jst, jmet = jstep(pair["jp"], jst, _jb(pair["batch"]))
    tp, topt, tst = _port(pair)
    step = make_inline_baseline_step(pair["tm"], topt, num_neighbors=K)
    tp, tst, met = step(tp, tst, _tb(pair["batch"]))
    _check_metrics(met, jmet)
    _check_step(tp, tst, jp, jst)


def test_embedding_refresh_matches_jax(pair):
    ids = np.arange(8, dtype=np.int32)
    corpus = SyntheticGraphCorpus(num_nodes=pair["tcfg"].carls.kb_entries,
                                  vocab_size=pair["tcfg"].vocab_size,
                                  seq_len=17)
    toks = corpus.node_tokens(ids)[:, :-1]
    jkb = JaxKBState(**{k: jnp.asarray(v)
                        for k, v in pair["leaves"].items()})
    jkb = jax.jit(jax_refresh(pair["jm"], DIST))(
        pair["jp"], jkb, jnp.asarray(ids), jnp.asarray(toks))
    tp = _port(pair)[0]
    tkb = convert.kb_state_from_numpy(pair["leaves"], device="cpu")
    make_embedding_refresh(pair["tm"])(tp, tkb, torch.from_numpy(ids),
                                       torch.from_numpy(toks))
    _check_bank(tkb, jkb)


# ---------------------------------------------------------------------------
# the trainer modes' properties (tests/test_trainer_modes.py, in the port)
# ---------------------------------------------------------------------------

def _setup(arch="yi-6b", **kw):
    cfg = get_config(arch).reduced().replace(**kw)
    model = build_model(cfg)
    opt = AdamW(lr=constant_lr(2e-3), weight_decay=0.0)
    params = model.init(torch.Generator().manual_seed(0))
    kb = kb_create(cfg.carls.kb_entries, cfg.d_model, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    corpus = SyntheticGraphCorpus(num_nodes=cfg.carls.kb_entries,
                                  vocab_size=cfg.vocab_size, seq_len=17,
                                  neighbors_per_node=4)
    return cfg, model, opt, params, kb, corpus


def _copy(tree):
    if isinstance(tree, AdamWState):
        return AdamWState(tree.count.clone(), _copy(tree.mu), _copy(tree.nu))
    return tree_map(torch.clone, tree)


def test_loss_decreases_over_steps():
    cfg, model, opt, params, kb, corpus = _setup()
    step = make_carls_train_step(model, opt)
    st = opt.init(params)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(12):
        params, st, kb, m = step(params, st, kb, _tb(corpus.batch(rng, 8)))
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_trainer_push_refreshes_kb():
    cfg, model, opt, params, kb, corpus = _setup()
    step = make_carls_train_step(model, opt, trainer_push=True)
    b = _tb(corpus.batch(np.random.default_rng(0), 4))
    _, _, kb, _ = step(params, opt.init(params), kb, b)
    ids = b["sample_ids"].long()
    assert bool((kb.version[ids] > 0).all())
    torch.testing.assert_close(kb.table[ids].norm(dim=-1),
                               torch.ones(ids.shape), rtol=1e-3, atol=0)


def test_no_push_leaves_versions():
    cfg, model, opt, params, kb, corpus = _setup()
    step = make_carls_train_step(model, opt, trainer_push=False)
    b = _tb(corpus.batch(np.random.default_rng(0), 4))
    _, _, kb, _ = step(params, opt.init(params), kb, b)
    assert bool((kb.version[b["sample_ids"].long()] == 0).all())


def test_lazy_grads_affect_next_lookup_direction():
    """Descent on the graph regulariser pulls the (fixed) neighbour rows
    toward the sample embedding on the next lookup."""
    cfg, model, opt, params, kb, corpus = _setup()
    n = cfg.carls.kb_entries
    kb = kb_update(kb, torch.arange(n), torch.ones((n, cfg.d_model)) * 5.0)
    step = make_carls_train_step(model, opt, trainer_push=False)
    st = opt.init(params)
    b = _tb(corpus.batch(np.random.default_rng(0), 4))
    _, _, kb, m1 = step(_copy(params), _copy(st), kb, b)
    assert float(kb.grad_cnt.sum()) > 0
    # the second step serves those rows: pending grads applied, reg drops
    _, _, kb, m2 = step(_copy(params), _copy(st), kb, b)
    assert float(m2["graph_reg"]) < float(m1["graph_reg"])


def test_maker_refresh_changes_rows_and_discards_pending():
    cfg, model, opt, params, kb, corpus = _setup()
    ids = torch.arange(8)
    kb.grad_sum[:8] = 1.0
    kb.grad_cnt[:8] = 1.0
    before = kb.table[:8].clone()
    maker = make_embedding_refresh(model)
    toks = torch.from_numpy(corpus.node_tokens(np.arange(8))[:, :-1])
    maker(params, kb, ids, toks)
    assert bool((kb.version[:8] == 1).all())
    assert not torch.allclose(kb.table[:8], before)
    assert not kb.grad_sum[:8].any() and not kb.grad_cnt[:8].any()


def test_moe_arch_multi_step_stability():
    """jamba's reduced group (7 Mamba layers, MoE on the odd positions)
    trains on the CPU through the plain scan; its aux loss is the routers'
    load balance, >= 1 up to rounding."""
    cfg, model, opt, params, kb, corpus = _setup("jamba-1.5-large-398b")
    step = make_carls_train_step(model, opt)
    st = opt.init(params)
    rng = np.random.default_rng(0)
    for _ in range(3):
        params, st, kb, m = step(params, st, kb, _tb(corpus.batch(rng, 4)))
        assert np.isfinite(float(m["loss"]))
        assert float(m["aux"]) >= 0.99
