"""One CARLS training step of a reduced config in both packages, and the
comparison the port's trainer tests make between them (the bounds of
tests/test_torch_trainer.py):

- metrics: atol 1e-5 + rtol 1e-5; ``acc``, ``tokens`` and ``kb_pending``
  exactly;
- the bank after the step: leaves atol 1e-6, versions and the clock
  exactly;
- the neighbour gradient the step pushes to the lazy cache, the
  moments, and the parameter gradients (read off the step-1 first
  moment, m = (1 - b1) g): atol 1e-6;
- post-step parameters: atol 1e-6 where the JAX gradient exceeds 1e-5,
  elsewhere 2 lr + 1e-6 (Adam's first step moves an entry whose gradient
  is 0 up to rounding by up to lr either way).

The inputs are numpy arrays from seeded generators: parameters from
``repro.models.LM.init`` carried over by ``lm_params_from_numpy``, the
bank of ``bank_leaves``, a ``SyntheticGraphCorpus`` batch and, for the
front-ends, N(0, 1) ``patch_embs`` or ``frames`` in the batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.checkpointing import flatten_params
from repro.configs import get_config as jax_config
from repro.core import make_carls_train_step as jax_carls_step
from repro.core.knowledge_bank import KBState as JaxKBState
from repro.core.trainer import make_async_train_fns as jax_async_fns
from repro.data import SyntheticGraphCorpus
from repro.models import build_model as jax_build
from repro.optim import AdamW as JaxAdamW
from repro.optim import constant_lr as jax_constant_lr
from repro.sharding.partition import DistContext
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.kb_engine import make_kb_ops
from repro_torch.core.trainer import FRONTEND_KEYS, make_carls_train_step
from repro_torch.models import build_model, moe
from repro_torch.optim import AdamW, constant_lr
from repro_torch.tree import tree_items

ATOL, RTOL = 1e-5, 1e-5
LEAF_ATOL = GRAD_ATOL = 1e-6
LR, B1 = 2e-3, 0.9
SIGN_T = 10 * GRAD_ATOL
# MoE routing is exact in both packages only where a token's k-th and
# (k+1)-th router probabilities are further apart than this
MOE_GAP = 1e-4


def bank_leaves(N, D, seed=0):
    """N(0, 0.01²) rows, a fifth of them with 1-2 pending gradients, half
    with a norm EMA (tests/test_torch_trainer.py's bank)."""
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


def configs(arch, **changes):
    """The reduced config of ``arch`` in both packages, with ``changes``."""
    return (jax_config(arch).reduced().replace(**changes),
            get_config(arch).reduced().replace(**changes))


def make_batch(cfg, B=4, S=16, seed=1):
    """A corpus batch of B sequences of S tokens, with the front-end's
    input (N(0, 1), (B, num_frontend_tokens, d_model)) where the config
    has one."""
    corpus = SyntheticGraphCorpus(num_nodes=cfg.carls.kb_entries,
                                  vocab_size=cfg.vocab_size, seq_len=S + 1,
                                  neighbors_per_node=cfg.carls.num_neighbors)
    batch = corpus.batch(np.random.default_rng(seed), B)
    key = FRONTEND_KEYS.get(cfg.frontend)
    if key is not None:
        batch[key] = np.random.default_rng(seed + 100).standard_normal(
            (B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def jax_params(jcfg, seed=0):
    """``repro.models.LM.init(key(seed))`` of ``jcfg``."""
    return jax_build(jcfg).init(jax.random.key(seed))


def jax_step(jcfg, batch, leaves, *, seed=0, with_gn=True):
    """JAX's jitted CARLS step from ``LM.init(key(seed))`` -> (initial
    parameters, post-step parameters, AdamW state, bank, metrics, the
    neighbour gradient of its async core on the rows the lookup serves,
    None without ``with_gn``: the bank's lazy cache holds it summed by
    row)."""
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.key(seed))
    jopt = JaxAdamW(lr=jax_constant_lr(LR))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jax.jit(jax_carls_step(jm, jopt, DistContext()))
    jp2, js, jkb, jmet = step(jp, jopt.init(jp), JaxKBState(
        **{k: jnp.asarray(v) for k, v in leaves.items()}), jb)
    gn = None
    if with_gn:
        lk = convert.kb_state_from_numpy(leaves, device="cpu")
        nbr, _ = make_kb_ops(backend="cuda").lookup(
            lk, torch.from_numpy(batch["neighbor_ids"]))
        core = jax.jit(jax_async_fns(jm, jopt, DistContext())[0])
        gn = np.asarray(core(jp, jopt.init(jp), jb,
                             jnp.asarray(nbr.numpy()))[3])
    return dict(p0=jp, p=jp2, st=js, kb=jkb, met=jmet, gn=gn)


def port_step(tcfg, jax_params, batch, leaves, monkeypatch=None):
    """The port's CARLS step on ``jax_params`` carried over -> (params,
    AdamW state, bank, metrics, the pushed neighbour gradient, the
    smallest gap between a token's k-th and (k+1)-th router
    probabilities over the MoE layers, inf without MoE)."""
    tp = convert.lm_params_from_numpy(flatten_params(jax_params), tcfg,
                                      device="cpu")
    opt = AdamW(lr=constant_lr(LR))
    st = opt.init(tp)
    kb = convert.kb_state_from_numpy(leaves, device="cpu")
    cc = tcfg.carls
    base = make_kb_ops(backend="cuda", lazy_lr=cc.lazy_lr,
                       zmax=cc.outlier_zmax, apply_pending=cc.lazy_update)
    pushed = []
    kb_ops = base._replace(lazy_grad=lambda kb, ids, g: pushed.append(g)
                           or base.lazy_grad(kb, ids, g))
    gaps = [float("inf")]
    if monkeypatch is not None:
        route = moe.route

        def gap_route(x, wr, k):
            probs = torch.softmax(x.detach().float() @ wr.detach().float(),
                                  dim=-1)
            top = torch.topk(probs, k + 1, dim=-1).values
            gaps.append(float((top[:, k - 1] - top[:, k]).min()))
            return route(x, wr, k)
        monkeypatch.setattr(moe, "route", gap_route)
    step = make_carls_train_step(build_model(tcfg), opt, kb_ops=kb_ops)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    tp, st, kb, met = step(tp, st, kb, tb)
    return dict(p=tp, st=st, kb=kb, met=met, gn=pushed[0], gap=min(gaps))


def _close(got, want, label, atol, rtol=0.0):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=label)


def check_against_jax(port, jax_):
    """Everything the port's step produced against JAX's (module doc)."""
    assert set(port["met"]) == set(jax_["met"])
    for k, v in jax_["met"].items():
        if k in ("acc", "tokens", "kb_pending"):
            assert float(port["met"][k]) == float(v), k
        else:
            _close(port["met"][k], v, k, ATOL, RTOL)
    if jax_["gn"] is not None:
        _close(port["gn"], jax_["gn"], "neighbour gradient", GRAD_ATOL)
    got = convert.kb_state_to_numpy(port["kb"])
    for f in JaxKBState._fields:
        want = np.asarray(getattr(jax_["kb"], f))
        if want.dtype.kind == "f":
            _close(got[f], want, f"bank {f}", LEAF_ATOL)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)
    ts, js = port["st"], jax_["st"]
    assert int(ts.count) == int(js.count) == 1
    for name in ("mu", "nu"):
        mine = dict(tree_items(getattr(ts, name)))
        for k, w in flatten_params(getattr(js, name)).items():
            _close(mine[k], w, f"{name} {k}", LEAF_ATOL)
    mu_t = dict(tree_items(ts.mu))
    p_t = dict(tree_items(port["p"]))
    p_j = flatten_params(jax_["p"])
    for k, m in flatten_params(js.mu).items():
        g_j = m / (1 - B1)
        _close(mu_t[k].numpy() / (1 - B1), g_j, f"grad {k}", GRAD_ATOL)
        sure = np.abs(g_j) > SIGN_T
        err = np.abs(p_t[k].float().numpy() - p_j[k])
        assert err[sure].max(initial=0) <= LEAF_ATOL, k
        assert err[~sure].max(initial=0) <= 2 * LR + LEAF_ATOL, k
