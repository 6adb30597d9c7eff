"""The plain backward versions of the port's three sequence kernels
(``repro_torch.kernels.ref``: flash attention, the RWKV6 WKV recurrence,
the Mamba scan), their autograd Functions' plumbing, and the reduced
rwkv6-7b and jamba CARLS steps, held on the CPU against ``torch.autograd``
of the plain forwards and against ``jax.vjp`` of the JAX package's
functions, on the same seeded numpy inputs. The CUDA kernels themselves
are held against these plain backwards on the card
(``tests/test_torch_backward_cuda.py``, ``chip_smoke.py``).

Bounds:

- against ``torch.autograd`` of the plain forward (fp32): atol 1e-5 +
  rtol 1e-5. The explicit backward sums the same fp32 products as
  autograd's graph, in another order.
- against ``jax.vjp``: the trainer's gradient atol 1e-6 plus 1e-5 of the
  value. At these sizes the gradients reach ~60 (ddelta of the scan) and
  the two packages sum S x d fp32 products in another order, which moves
  a gradient by a few ulps of its own size (up to 8.6e-6 seen on ddelta,
  2e-6 on flash's dv of ~7): atol 1e-6 alone does not hold. 1e-5
  relative is a fifth of the relative size of the forward's 5e-5 bound
  (tests/test_kernels.py) on outputs of ~1.
- the mixers' gradients (x and every parameter, d 128): atol 1e-5 + rtol
  1e-5, the bound tests/test_torch_rwkv.py and tests/test_torch_jamba.py
  hold the mixers' forwards to (the projections' 128-term sums run in
  another order too).
- the CARLS steps: tests/test_torch_trainer.py's bounds (metrics atol
  1e-5 + rtol 1e-5; bank and moments atol 1e-6; gradients, read off the
  first moment, atol 1e-6 + rtol 1e-5 as against ``jax.vjp`` above;
  post-step parameters by the trainer test's sign rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import flatten_params
from repro.configs import get_config as jax_config
from repro.core import make_carls_train_step as jax_carls_step
from repro.core.knowledge_bank import KBState as JaxKBState
from repro.data import SyntheticGraphCorpus as JaxCorpus
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro.models import ssm as jssm
from repro.models.layers import flash_attention_jax
from repro.optim import AdamW as JaxAdamW
from repro.optim import constant_lr as jax_constant_lr
from repro.sharding.partition import DistContext
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.kb_engine import make_kb_ops
from repro_torch.core.trainer import make_carls_train_step
from repro_torch.kernels import (flash_attention, mamba_scan, ops, ref,
                                 rwkv_wkv)
from repro_torch.models import build_model, ssm
from repro_torch.optim import AdamW, constant_lr
from repro_torch.tree import tree_items

ATOL_AG = RTOL_AG = 1e-5
ATOL_VJP, RTOL_VJP = 1e-6, 1e-5
ATOL_MIX = RTOL_MIX = 1e-5
LEAF_ATOL = 1e-6
LR, B1 = 2e-3, 0.9
SIGN_T = 10 * LEAF_ATOL


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grad(leaf):
    """A leaf's gradient; zeros where the loss does not reach it (w with
    one step and no gradient of the state)."""
    return (np.zeros(leaf.shape, np.float32) if leaf.grad is None
            else leaf.grad.numpy())


def _close(got, want, label, atol, rtol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=label)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (B, S, H, KV, d, causal, window, softcap)
    (2, 64, 4, 2, 32, True, 0, 0.0),       # GQA, causal
    (1, 96, 4, 1, 16, True, 24, 20.0),     # window and soft cap
    (2, 48, 2, 2, 16, False, 0, 0.0),      # not causal
    (1, 64, 6, 3, 32, False, 20, 5.0),     # not causal, window, soft cap
]


def _flash_inputs(case, seed=0):
    B, S, H, KV, d = case[:5]
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, S, H, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, KV, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _flash_kw(case):
    return dict(causal=case[5], window=case[6], softcap=case[7])


def _flash_plain_bwd(q, k, v, do, kw):
    out, lse = ref.flash_attention_ref(t(q), t(k), t(v), return_lse=True,
                                       **kw)
    return out, ref.flash_attention_bwd_ref(t(q), t(k), t(v), out, lse,
                                            t(do), **kw)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_plain_matches_autograd(case):
    q, k, v, do = _flash_inputs(case)
    kw = _flash_kw(case)
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    ref.flash_attention_ref(*leaves, **kw).backward(t(do))
    _, grads = _flash_plain_bwd(q, k, v, do, kw)
    for name, g, leaf in zip(("dq", "dk", "dv"), grads, leaves):
        assert g.dtype == torch.float32 and g.shape == leaf.shape
        _close(g, _grad(leaf), name, ATOL_AG, RTOL_AG)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bwd_plain_matches_jax_vjp(case):
    q, k, v, do = _flash_inputs(case, seed=1)
    kw = _flash_kw(case)
    out_j, vjp = jax.vjp(
        lambda a, b, c: flash_attention_jax(a, b, c, q_chunk=32, kv_chunk=16,
                                            **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, grads = _flash_plain_bwd(q, k, v, do, kw)
    _close(out, out_j, "out", ATOL_VJP, RTOL_VJP)
    for name, g, gj in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(do))):
        _close(g, gj, name, ATOL_VJP, RTOL_VJP)


def test_flash_lse_is_the_rows_log_sum_exp():
    """The log-sum-exp the forward keeps for the backward, against a
    float64 one over the masked, capped scores."""
    case = FLASH_CASES[1]
    q, k, v, _ = _flash_inputs(case)
    B, S, H, KV, d = case[:5]
    _, lse = ref.flash_attention_ref(t(q), t(k), t(v), return_lse=True,
                                     **_flash_kw(case))
    kr = np.repeat(k, H // KV, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kr) / np.sqrt(d)
    s = np.tanh(s / case[7]) * case[7]
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    s = np.where((qp >= kp) & (qp - kp < case[6]), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    assert lse.shape == (B, H, S)
    _close(lse, want, "lse", 1e-5, 1e-6)


# ---------------------------------------------------------------------------
# the WKV recurrence
# ---------------------------------------------------------------------------

WKV_CASES = [  # (B, S, H, d, decays, with a gradient of S_fin)
    (2, 40, 3, 16, "model", True),          # 3 chunks, the last ragged
    (1, 16, 2, 8, "extreme", True),         # one whole chunk, w down to 0
    (2, 1, 2, 8, "model", False),           # one step
    (1, 37, 2, 16, "extreme", False),
]


def _wkv_inputs(B, S, H, d, decays, seed=0):
    """tests/test_torch_rwkv.py's ranges; "extreme" decays run from 0 to
    ~1 per channel, some exactly 0 (w = exp(-exp(.)) underflows)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, d)).astype(np.float32)
               for _ in range(3))
    if decays == "model":
        w = (0.5 / (1.0 + np.exp(-rng.standard_normal((B, S, H, d))))
             + 0.5).astype(np.float32)
    else:
        w = rng.random((B, S, H, d)).astype(np.float32)
        w[:, ::5] = 0.0
    u = (0.1 * rng.standard_normal((H, d))).astype(np.float32)
    dy = rng.standard_normal((B, S, H, d)).astype(np.float32)
    ds = rng.standard_normal((B, H, d, d)).astype(np.float32)
    return (r, k, v, w, u), dy, ds


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv_bwd_plain_matches_autograd(case):
    *shape, decays, with_ds = case
    args, dy, ds = _wkv_inputs(*shape, decays)
    leaves = [t(a).requires_grad_() for a in args]
    y, s_fin = ref.rwkv_wkv_ref(*leaves)
    loss = (y * t(dy)).sum()
    if with_ds:
        loss = loss + (s_fin * t(ds)).sum()
    loss.backward()
    grads = ref.rwkv_wkv_bwd_ref(*(t(a) for a in args), t(dy),
                                 t(ds) if with_ds else None)
    for name, g, leaf in zip(("dr", "dk", "dv", "dw", "du"), grads, leaves):
        assert g.shape == leaf.shape
        _close(g, _grad(leaf), name, ATOL_AG, RTOL_AG)


def test_wkv_bwd_plain_matches_jax_vjp():
    """JAX's plain WKV recurrence returns y alone: the state's gradient is
    held through the mixer below."""
    args, dy, _ = _wkv_inputs(2, 40, 3, 16, "model", seed=1)
    _, vjp = jax.vjp(jref.rwkv_wkv_ref, *(jnp.asarray(a) for a in args))
    grads = ref.rwkv_wkv_bwd_ref(*(t(a) for a in args), t(dy))
    for name, g, gj in zip(("dr", "dk", "dv", "dw", "du"), grads,
                           vjp(jnp.asarray(dy))):
        _close(g, gj, name, ATOL_VJP, RTOL_VJP)


# ---------------------------------------------------------------------------
# the Mamba scan
# ---------------------------------------------------------------------------

SCAN_CASES = [  # (B, S, di, ds, with a gradient of h_fin)
    (2, 40, 24, 8, True),
    (1, 16, 8, 4, True),
    (2, 1, 16, 8, False),
    (1, 37, 40, 16, False),
]


def _scan_inputs(B, S, di, ds, seed=0):
    """tests/test_torch_jamba.py's ranges: delta 0.1 U(0, 1), B, C, x
    N(0, 1), A = -exp(N(0, 1))."""
    rng = np.random.default_rng(seed)
    delta = (0.1 * rng.random((B, S, di))).astype(np.float32)
    bm, cm = (rng.standard_normal((B, S, ds)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((B, S, di)).astype(np.float32)
    A = (-np.exp(rng.standard_normal((di, ds)))).astype(np.float32)
    dy = rng.standard_normal((B, S, di)).astype(np.float32)
    dh = rng.standard_normal((B, di, ds)).astype(np.float32)
    return (delta, bm, cm, x, A), dy, dh


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_bwd_plain_matches_autograd(case):
    *shape, with_dh = case
    args, dy, dh = _scan_inputs(*shape)
    leaves = [t(a).requires_grad_() for a in args]
    y, h_fin = ref.mamba_scan_ref(*leaves)
    loss = (y * t(dy)).sum()
    if with_dh:
        loss = loss + (h_fin * t(dh)).sum()
    loss.backward()
    grads = ref.mamba_scan_bwd_ref(*(t(a) for a in args), t(dy),
                                   t(dh) if with_dh else None)
    for name, g, leaf in zip(("ddelta", "dbm", "dcm", "dx", "dA"), grads,
                             leaves):
        assert g.shape == leaf.shape
        _close(g, _grad(leaf), name, ATOL_AG, RTOL_AG)


def test_scan_bwd_plain_matches_jax_vjp():
    """JAX's plain scan returns y alone: the state's gradient is held
    through the mixer below."""
    args, dy, _ = _scan_inputs(2, 40, 24, 8, seed=1)
    _, vjp = jax.vjp(jref.mamba_scan_ref, *(jnp.asarray(a) for a in args))
    grads = ref.mamba_scan_bwd_ref(*(t(a) for a in args), t(dy))
    for name, g, gj in zip(("ddelta", "dbm", "dcm", "dx", "dA"), grads,
                           vjp(jnp.asarray(dy))):
        _close(g, gj, name, ATOL_VJP, RTOL_VJP)


# ---------------------------------------------------------------------------
# the autograd Functions, with the plain versions in the kernels' places
# ---------------------------------------------------------------------------

@pytest.fixture
def functions_on_cpu(monkeypatch):
    """``ops.flash_attention``, ``ops.rwkv_wkv`` and ``ops.mamba_scan``
    routed to their CUDA launchers, as on the card, with every launch
    replaced by the plain versions (forwards, and backwards through the
    plain backward functions): the Functions' plumbing (what they save,
    the padding and cutting of channels, the zero gradient of an unused
    state, the dtype of the gradients) runs on the CPU. Counts the
    backward calls."""
    calls = {"flash_attention": 0, "rwkv_wkv": 0, "mamba_scan": 0}
    for mod in (flash_attention, rwkv_wkv, mamba_scan):
        monkeypatch.setattr(mod, "require_cuda", lambda *a: None)

    def flash_fwd(q, k, v, causal, window, softcap, with_lse):
        out, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, softcap=softcap,
                                           return_lse=True)
        return out, (lse if with_lse else None)

    def flash_bwd(*a, **kw):
        calls["flash_attention"] += 1
        return ref.flash_attention_bwd_ref(*a, **kw)

    def wkv_fwd(r, k, v, w, u, prof, checkpoints=False):
        return (*ref.rwkv_wkv_ref(r, k, v, w, u), None)

    def wkv_bwd(r, k, v, w, u, ckpt, dy, ds):
        calls["rwkv_wkv"] += 1
        return ref.rwkv_wkv_bwd_ref(r, k, v, w, u, dy, ds)

    def scan_fwd(delta, bm, cm, x, A, prof, checkpoints=False):
        return (*ref.mamba_scan_ref(delta, bm, cm, x, A), None)

    def scan_bwd(delta, bm, cm, x, A, ckpt, dy, dh):
        assert delta.shape[-1] % mamba_scan.DI_MULTIPLE == 0
        calls["mamba_scan"] += 1
        return ref.mamba_scan_bwd_ref(delta, bm, cm, x, A, dy, dh)

    monkeypatch.setattr(flash_attention, "_forward", flash_fwd)
    monkeypatch.setattr(flash_attention, "flash_attention_bwd_cuda",
                        flash_bwd)
    monkeypatch.setattr(rwkv_wkv, "_launch", wkv_fwd)
    monkeypatch.setattr(rwkv_wkv, "rwkv_wkv_bwd_cuda", wkv_bwd)
    monkeypatch.setattr(mamba_scan, "_launch", scan_fwd)
    monkeypatch.setattr(mamba_scan, "mamba_scan_bwd_cuda", scan_bwd)
    monkeypatch.setattr(ops, "flash_attention",
                        flash_attention.flash_attention_cuda)
    monkeypatch.setattr(ops, "rwkv_wkv", rwkv_wkv.rwkv_wkv_cuda)
    monkeypatch.setattr(ops, "mamba_scan", mamba_scan.mamba_scan_cuda)
    return calls


@pytest.mark.parametrize("kernel,shape", [
    ("flash_attention", (1, 96, 4, 1, 32, True, 24, 20.0)),
    ("rwkv_wkv", (2, 40, 3, 16)),
    ("mamba_scan", (2, 40, 37, 8)),          # di 37: padded to 40, cut
    ("mamba_scan", (1, 16, 16, 4)),
])
def test_functions_match_autograd_of_the_plain_forward(functions_on_cpu,
                                                       kernel, shape):
    """Each launcher under grad runs its Function (its ``grad_fn``), whose
    gradients, with the plain backward in the kernel's place, equal
    autograd's of the plain forward; a state output left out of the loss
    has a zero gradient."""
    if kernel == "flash_attention":
        q, k, v, do = _flash_inputs(shape)
        args, kw, dys = (q, k, v), _flash_kw(shape), (do,)
        plain = lambda *a: ref.flash_attention_ref(*a, **kw)   # noqa: E731
    elif kernel == "rwkv_wkv":
        args, dy, _ = _wkv_inputs(*shape, "extreme")
        kw, dys, plain = {}, (dy,), ref.rwkv_wkv_ref
    else:
        args, dy, _ = _scan_inputs(*shape)
        kw, dys, plain = {}, (dy,), ref.mamba_scan_ref
    leaves = [t(a).requires_grad_() for a in args]
    out = getattr(ops, kernel)(*leaves, **kw)
    out = out[0] if isinstance(out, tuple) else out
    assert type(out.grad_fn).__name__.endswith("FnBackward")
    (out * t(dys[0])).sum().backward()
    assert functions_on_cpu[kernel] == 1
    want = [t(a).requires_grad_() for a in args]
    y = plain(*want)
    y = y[0] if isinstance(y, tuple) else y
    (y * t(dys[0])).sum().backward()
    for i, (a, b) in enumerate(zip(leaves, want)):
        assert a.grad.shape == b.grad.shape and a.grad.dtype == b.dtype
        _close(a.grad, b.grad.numpy(), f"{kernel} grad {i}", ATOL_AG,
               RTOL_AG)


def test_scan_function_returns_grads_in_the_inputs_dtypes(functions_on_cpu):
    """bf16 x (the model dtype) gets a bf16 gradient, the fp32 inputs fp32
    ones."""
    args, dy, dh = _scan_inputs(1, 16, 16, 4)
    leaves = [t(a) for a in args]
    leaves[3] = leaves[3].to(torch.bfloat16)
    leaves = [a.requires_grad_() for a in leaves]
    y, h_fin = ops.mamba_scan(*leaves)
    ((y * t(dy)).sum() + (h_fin * t(dh)).sum()).backward()
    assert [a.grad.dtype for a in leaves] == [a.dtype for a in leaves]


# ---------------------------------------------------------------------------
# the mixers on JAX-initialised parameters, through the Functions
# ---------------------------------------------------------------------------

def _mixer_vjp(apply_j, jp, apply_t, tp, x, cot, cot_state, state_key):
    """jax.vjp of ``apply_j`` against the port's autograd of ``apply_t``
    (through the Functions), both with cotangents on y and on the state's
    ``state_key``: -> [(name, port grad, JAX grad)] for x and every
    parameter."""
    (yj, sj), vjp = jax.vjp(apply_j, jp, jnp.asarray(x))
    state_cot = {k: jnp.zeros_like(val) for k, val in sj.items()}
    state_cot[state_key] = jnp.asarray(cot_state)
    gp_j, gx_j = vjp((jnp.asarray(cot), state_cot))
    leaves = {k: val.clone().requires_grad_() for k, val in
              tree_items(tp)}
    xt = t(x).requires_grad_()
    params = _nest_leaves(leaves)
    y, st = apply_t(params, xt)
    ((y * t(cot)).sum() + (st[state_key] * t(cot_state)).sum()).backward()
    out = [("x", xt.grad, gx_j)]
    flat_j = flatten_params(gp_j)
    for k, leaf in leaves.items():
        out.append((k, leaf.grad, flat_j[k]))
    return out


def _nest_leaves(leaves):
    tree = {}
    for path, leaf in leaves.items():
        node = tree
        *parents, last = path.split("::")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


@pytest.mark.parametrize("mixer", ["rwkv6", "mamba"])
def test_mixer_grads_match_jax(functions_on_cpu, mixer):
    arch = "rwkv6-7b" if mixer == "rwkv6" else "jamba-1.5-large-398b"
    cfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    init_j = jssm.rwkv6_init if mixer == "rwkv6" else jssm.mamba_init
    jp = jax.jit(lambda key: init_j(key, cfg))(jax.random.key(0))
    tp = convert.lm_params_from_numpy(flatten_params(jp), tcfg, device="cpu")
    rng = np.random.default_rng(5)
    B, S, D = 2, 40, cfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    cot = rng.standard_normal((B, S, D)).astype(np.float32)
    if mixer == "rwkv6":
        hd = cfg.rwkv_head_dim
        cot_state = rng.standard_normal((B, D // hd, hd, hd))
        key = "S"
        apply_j = lambda p, a: jssm.rwkv6_apply_state(p, a, cfg)  # noqa
        apply_t = lambda p, a: ssm.rwkv6_apply_state(p, a, tcfg)  # noqa
    else:
        di = cfg.ssm_expand * cfg.d_model
        cot_state = rng.standard_normal((B, di, cfg.ssm_state_dim))
        key = "h"
        apply_j = lambda p, a: jssm.mamba_apply_state(p, a, cfg)  # noqa
        apply_t = lambda p, a: ssm.mamba_apply_state(p, a, tcfg)  # noqa
    cot_state = cot_state.astype(np.float32)
    got = _mixer_vjp(apply_j, jp, apply_t, tp, x, cot, cot_state, key)
    kernel = "rwkv_wkv" if mixer == "rwkv6" else "mamba_scan"
    assert functions_on_cpu[kernel] == 1
    assert len(got) == len(flatten_params(jp)) + 1
    for name, g, gj in got:
        _close(g, gj, f"{mixer} grad {name}", ATOL_MIX, RTOL_MIX)


# ---------------------------------------------------------------------------
# the reduced rwkv6-7b and jamba CARLS steps, through the Functions
# ---------------------------------------------------------------------------

def _bank_leaves(N, D, seed=0):
    """tests/test_torch_trainer.py's bank."""
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


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b"])
def test_carls_step_matches_jax(functions_on_cpu, arch):
    """One CARLS step of the reduced model in both packages from JAX's
    init, one bank and one batch of 4 x 16 tokens; the port's mixers run
    their Functions with the plain backwards."""
    cfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jm = jax_build(cfg)
    jp = jm.init(jax.random.key(0))
    corpus = JaxCorpus(num_nodes=cfg.carls.kb_entries,
                       vocab_size=cfg.vocab_size, seq_len=17,
                       neighbors_per_node=cfg.carls.num_neighbors)
    batch = corpus.batch(np.random.default_rng(1), 4)
    leaves = _bank_leaves(cfg.carls.kb_entries, cfg.d_model)
    jopt = JaxAdamW(lr=jax_constant_lr(LR))
    jstep = jax.jit(jax_carls_step(jm, jopt, DistContext()))
    jp2, js, jkb, jmet = jstep(
        jp, jopt.init(jp), JaxKBState(**{k: jnp.asarray(v)
                                         for k, v in leaves.items()}),
        {k: jnp.asarray(v) for k, v in batch.items()})

    tp = convert.lm_params_from_numpy(flatten_params(jp), tcfg, device="cpu")
    topt = AdamW(lr=constant_lr(LR))
    ts = topt.init(tp)
    tkb = convert.kb_state_from_numpy(leaves, device="cpu")
    cc = tcfg.carls
    kb_ops = make_kb_ops(backend="cuda", lazy_lr=cc.lazy_lr,
                         zmax=cc.outlier_zmax, apply_pending=cc.lazy_update)
    step = make_carls_train_step(build_model(tcfg), topt, kb_ops=kb_ops)
    _, _, _, met = step(tp, ts, tkb, {k: t(v) for k, v in batch.items()})
    kernel = "rwkv_wkv" if arch == "rwkv6-7b" else "mamba_scan"
    assert functions_on_cpu[kernel] == cfg.num_layers - (
        0 if arch == "rwkv6-7b" else 1)        # one attention layer
    for k in jmet:
        if k in ("acc", "tokens", "kb_pending"):
            assert float(met[k]) == float(jmet[k]), k
        else:
            _close(met[k], jmet[k], k, 1e-5, 1e-5)
    got = convert.kb_state_to_numpy(tkb)
    for f in JaxKBState._fields:
        want = np.asarray(getattr(jkb, f))
        if want.dtype.kind == "f":
            _close(got[f], want, f, LEAF_ATOL, 0)
        else:
            np.testing.assert_array_equal(got[f], want, err_msg=f)
    mu_j, mu_t = flatten_params(js.mu), dict(tree_items(ts.mu))
    p_j, p_t = flatten_params(jp2), dict(tree_items(tp))
    for k, m in mu_j.items():
        g_j = m / (1 - B1)
        _close(mu_t[k].numpy() / (1 - B1), g_j, f"grad {k}", ATOL_VJP,
               RTOL_VJP)
        sure = np.abs(g_j) > SIGN_T
        err = np.abs(p_t[k].float().numpy() - p_j[k])
        assert err[sure].max(initial=0) <= LEAF_ATOL, k
        assert err[~sure].max(initial=0) <= 2 * LR + LEAF_ATOL, k
