"""The port's jamba path (the plain Mamba scan, ``models/ssm.py``'s Mamba
half, ``models/moe.py``, the hybrid jamba ``LM`` and its serve drive) held
against the JAX package on the CPU.

Inputs come from numpy with a seed; the models run on parameters that
``repro``'s initialisers made and ``repro_torch.convert
.lm_params_from_numpy`` carried over (through
``repro.checkpoint.checkpointing.flatten_params``). Tolerances:

- the scan: y atol 5e-5, tests/test_kernels_extra.py's bound for the
  Pallas kernel against its oracle; the final state, which JAX's kernel
  does not return, against a float64 numpy recurrence at the same bound;
- the mixer (reduced jamba: d 128, di 256, ds 16, fp32): y, the state h
  (a sum over time), ``conv_buf`` (rows of the input projection) and the
  decode step's output and state atol 1e-5 + rtol 1e-5, as
  tests/test_torch_lm.py holds the reduced yi-6b: the two packages sum
  the same fp32 products in another order (matmuls of width 128 and 256,
  the scan's sum over the 16 states);
- MoE: the router's gates atol 1e-6 (a softmax over 4 or 8 logits, in
  [0, 1]); its aux loss (about E, from means over the tokens summed in
  another order) atol 1e-5 + rtol 1e-5; its experts exact wherever the
  sorted probabilities around the k-th are more than 1e-4 apart; the
  layer's output atol 1e-5 + rtol 1e-5 (sums of width 32 to 256, each
  expert's products in another order);
- the reduced LM (8 layers, d 128, 4 experts, fp32): hidden states,
  logits and every cache entry atol 1e-5 + rtol 1e-5, the bounds of
  tests/test_torch_lm.py for the reduced yi-6b;
- greedy ids exact wherever the JAX top-2 logits are more than 1e-4
  apart, and the serve drive's ids exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import flatten_params
from repro.configs import get_config as jax_config
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.models import build_model as jax_build
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.sharding.partition import DistContext
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import build_model, moe, ssm

ARCH = "jamba-1.5-large-398b"
ATOL_SCAN = 5e-5
ATOL, RTOL = 1e-5, 1e-5
ID_GAP = 1e-4


def t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, label, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=label)


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------

def _scan_inputs(B, S, di, ds, seed):
    """tests/test_kernels_extra.py's ranges: delta softplus(N(0, 1)); B, C
    and x 0.5 N(0, 1); A = -exp(0.3 N(0, 1))."""
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(
        np.float32)
    bm, cm = (0.5 * rng.standard_normal((B, S, ds)).astype(np.float32)
              for _ in range(2))
    x = 0.5 * rng.standard_normal((B, S, di)).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal((di, ds))).astype(np.float32)
    return delta, bm, cm, x, A


def _state_f64(delta, bm, x, A):
    """The state after the last step, in float64."""
    B, S, di = delta.shape
    d, b, xx, a = (v.astype(np.float64) for v in (delta, bm, x, A))
    h = np.zeros((B, di, A.shape[1]))
    for i in range(S):
        h = (np.exp(d[:, i, :, None] * a[None]) * h
             + (d[:, i] * xx[:, i])[..., None] * b[:, i, None, :])
    return h


@pytest.mark.parametrize("B,S,di,ds,blocks", [
    (1, 64, 32, 8, (16, 32)),
    (2, 128, 64, 16, (64, 64)),
    (1, 256, 128, 16, (128, 64)),   # the Pallas kernel's state carry
    (2, 333, 40, 16, None),         # S and di no block multiple: port only
    (3, 1, 24, 8, None),            # one step
])
def test_scan_plain_matches_pallas_and_jax_ref(B, S, di, ds, blocks):
    args = _scan_inputs(B, S, di, ds, seed=B * S + di)
    ja = [jnp.asarray(a) for a in args]
    y, h_fin = ref.mamba_scan_ref(*map(t, args))
    assert y.dtype == h_fin.dtype == torch.float32
    assert y.shape == (B, S, di) and h_fin.shape == (B, di, ds)
    if blocks is not None:
        pallas = mamba_scan_pallas(*ja, di_block=blocks[0],
                                   seq_block=blocks[1], interpret=True)
        _close(y, pallas, "y vs Pallas", atol=ATOL_SCAN, rtol=0)
    _close(y, jref.mamba_scan_ref(*ja), "y vs JAX ref", atol=ATOL_SCAN,
           rtol=0)
    delta, bm, _, x, A = args
    _close(h_fin, _state_f64(delta, bm, x, A), "h_fin", atol=ATOL_SCAN,
           rtol=0)


def test_scan_plain_widens_bf16_x():
    """x in bf16 (the full-width model dtype) reads as its fp32 values."""
    delta, bm, cm, x, A = _scan_inputs(2, 40, 24, 16, seed=5)
    xb = t(x).to(torch.bfloat16)
    y, h = ref.mamba_scan_ref(t(delta), t(bm), t(cm), xb, t(A))
    y32, h32 = ref.mamba_scan_ref(t(delta), t(bm), t(cm), xb.float(), t(A))
    assert torch.equal(y, y32) and torch.equal(h, h32)
    _close(y, jref.mamba_scan_ref(jnp.asarray(delta), jnp.asarray(bm),
                                  jnp.asarray(cm),
                                  jnp.asarray(xb.float().numpy()),
                                  jnp.asarray(A)),
           "bf16 x", atol=ATOL_SCAN, rtol=0)


# ---------------------------------------------------------------------------
# the Mamba mixer on JAX-initialised parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixer_pair():
    cfg = jax_config(ARCH).reduced()
    jp = jax.jit(lambda k: jssm.mamba_init(k, cfg))(jax.random.key(0))
    tcfg = get_config(ARCH).reduced()
    tp = convert.lm_params_from_numpy(flatten_params(jp), tcfg,
                                      device="cpu")
    return cfg, jp, tcfg, tp


@pytest.mark.parametrize("S", [48, 2])     # 2 < w - 1: conv_buf padded
def test_mixer_state_and_decode_match_jax(mixer_pair, S):
    cfg, jp, tcfg, tp = mixer_pair
    rng = np.random.default_rng(S)
    B, D = 2, cfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, D)).astype(np.float32)
    jy, jst = jax.jit(lambda p, a: jssm.mamba_apply_state(p, a, cfg))(
        jp, jnp.asarray(x))
    y, st = ssm.mamba_apply_state(tp, t(x), tcfg)
    assert y.shape == (B, S, D) and st["h"].dtype == torch.float32
    _close(y, jy, "y")
    for n in ("h", "conv_buf"):
        assert tuple(st[n].shape) == jst[n].shape, n
        _close(st[n], jst[n], n)
    if S < cfg.ssm_conv_width - 1:
        assert not st["conv_buf"][:, :cfg.ssm_conv_width - 1 - S].any()
    jy1, jst1 = jssm.mamba_decode(jp, jnp.asarray(x1), jst, cfg)
    y1, st1 = ssm.mamba_decode(tp, t(x1), st, tcfg)
    _close(y1, jy1, "decode y")
    for n in ("h", "conv_buf"):
        _close(st1[n], jst1[n], f"decode {n}")
    assert ssm.mamba_apply(tp, t(x), tcfg).shape == (B, S, D)
    empty = ssm.mamba_init_state(tcfg, B, torch.float32, device="cpu")
    jempty = jssm.mamba_init_state(cfg, B, jnp.float32)
    for n in ("h", "conv_buf"):
        assert tuple(empty[n].shape) == jempty[n].shape
        assert not empty[n].any()


def test_mamba_init_state_defaults_to_the_card(mixer_pair, monkeypatch):
    """Like every entry point of the port, the empty state is made on the
    card unless the caller names the CPU: without a card the default
    raises the "no CUDA device" error instead of falling back."""
    tcfg = mixer_pair[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssm.mamba_init_state(tcfg, 2, torch.float32)


def test_mixer_prefill_on_cpu_launches_nothing(mixer_pair):
    _, _, tcfg, tp = mixer_pair
    ops.reset_launch_counts()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 8, tcfg.d_model)).astype(np.float32))
    ssm.mamba_apply_state(tp, x, tcfg)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_params(D, F, E, seed, skew=0.0):
    """Router and experts at the init's scale; ``skew`` adds to expert
    0's router column, so that most tokens pick it."""
    rng = np.random.default_rng(seed)
    wr = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    wr[:, 0] += skew
    wi, wg = ((rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(
        np.float32) for _ in range(2))
    wo = (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)
    return wr, wi, wg, wo


@pytest.mark.parametrize("T,E,k,skew", [(64, 4, 2, 0.0), (96, 8, 2, 0.0),
                                        (40, 4, 2, 0.1), (33, 8, 1, 0.0)])
def test_moe_route_and_dispatch_match_jax(T, E, k, skew):
    D, F = 32, 48
    wr, wi, wg, wo = _moe_params(D, F, E, seed=T + E, skew=skew)
    x = np.random.default_rng(T).standard_normal((T, D)).astype(np.float32)
    if skew:
        x[:, :] = np.abs(x)      # every token leans to expert 0
    jg, je, jaux = jax.jit(jmoe.route, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(wr), k)
    g, e, aux = moe.route(t(x), t(wr), k)
    _close(g, jg, "gates", atol=1e-6, rtol=0)
    _close(aux, jaux, "aux")
    probs = np.sort(np.asarray(jax.nn.softmax(jnp.asarray(x) @ wr)), -1)
    gaps = np.diff(probs, axis=-1)[:, ::-1]      # p(1)-p(2), p(2)-p(3), ...
    decided = (gaps[:, :k] > ID_GAP).all(-1)
    assert decided.sum() > T // 2
    np.testing.assert_array_equal(e.numpy()[decided], np.asarray(je)[decided])
    jy, _ = jax.jit(jmoe.moe_ref, static_argnums=5)(
        *(jnp.asarray(a) for a in (x, wr, wi, wg, wo)), k)
    y_ref, aux_ref = moe.moe_ref(*map(t, (x, wr, wi, wg, wo)), k)
    y, aux2 = moe.moe_dispatch(*map(t, (x, wr, wi, wg, wo)), k)
    _close(y_ref, jy, "port moe_ref vs JAX moe_ref")
    _close(y, jy, "dispatch vs JAX moe_ref")
    _close(y, y_ref, "dispatch vs port moe_ref")
    assert aux2 == aux_ref == aux
    again, _ = moe.moe_dispatch(*map(t, (x, wr, wi, wg, wo)), k)
    assert torch.equal(again, y)
    if skew:                       # one expert takes most tokens: none drop
        assert (e == 0).any(-1).float().mean() > 0.9


def test_moe_apply_takes_the_config_and_shapes():
    cfg = get_config(ARCH).reduced()
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    wr, wi, wg, wo = _moe_params(D, F, E, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 5, D)).astype(
        np.float32)
    y, aux = moe.moe_apply(t(x), {"wr": t(wr), "wi": t(wi), "wg": t(wg),
                                  "wo": t(wo)}, cfg=cfg)
    jcfg = jax_config(ARCH).reduced()
    jy, jaux = jax.jit(lambda a, p: jmoe.moe_apply(a, p, cfg=jcfg,
                                                   dist=None))(
        jnp.asarray(x), {"wr": wr, "wi": wi, "wg": wg, "wo": wo})
    assert y.shape == (2, 5, D)
    _close(y, jy, "moe_apply")
    _close(aux, jaux, "aux")


# ---------------------------------------------------------------------------
# the reduced jamba LM
# ---------------------------------------------------------------------------

# the JAX functions run under jax.jit: eagerly, each call traces the
# 8-layer group scan anew (seconds a call on the CPU)

@pytest.fixture(scope="module")
def lm_pair():
    cfg = jax_config(ARCH).reduced()
    jm = jax_build(cfg)
    params = jax.jit(jm.init)(jax.random.key(0))
    tcfg = get_config(ARCH).reduced()
    tp = convert.lm_params_from_numpy(flatten_params(params), tcfg,
                                      device="cpu")
    return jm, params, build_model(tcfg), tp


def test_group_spec_is_jax_s(lm_pair):
    jm, _, tm, _ = lm_pair
    assert tm.spec == jm.spec
    assert [m for m, _ in tm.spec].count("attn") == 1
    assert tm.spec[3] == ("attn", "moe")


def test_hidden_matches_jax(lm_pair):
    jm, params, tm, tp = lm_pair
    toks = np.random.default_rng(64).integers(0, jm.cfg.vocab_size, (2, 64))
    want, _, want_aux, _ = jax.jit(
        lambda p, tk: jm.hidden(p, tk, {}, DistContext()))(
        params, jnp.asarray(toks, jnp.int32))
    got, prefix, aux, cache = tm.hidden(tp, t(toks))
    assert cache is None and prefix == 0
    _close(got, want, "hidden")
    # the MoE routers' aux loss summed over the layers, as JAX sums it
    assert aux.shape == () and float(aux) > 0.0
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)


B_SERVE, P_SERVE, G_SERVE = 2, 16, 4


@pytest.fixture(scope="module")
def jax_serve(lm_pair):
    """The JAX launcher's LM loop (repro/launch/serve.py) at --batch 2
    --prompt-len 16 --gen 4 --seed 0: prefill at prompt + gen + 1 slots,
    then greedy decode fed the prompt's last token first. Keeps the
    prompt, the prefill's cache and hidden states, each step's logits, the
    cache after the last step and the ids, as numpy."""
    jm, params, _, _ = lm_pair
    dist = DistContext()
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab_size,
                                             (B_SERVE, P_SERVE))
    prefill = jax.jit(lambda p, tk: jm.prefill(p, tk, {}, dist,
                                               cache_len=P_SERVE + G_SERVE
                                               + 1))
    step = jax.jit(lambda p, c, tk: jm.decode_step(p, c, tk, {}, dist))
    cache, h = prefill(params, jnp.asarray(toks, jnp.int32))
    run = {"toks": toks, "h": np.asarray(h),
           "cache0": jax.tree.map(np.asarray, cache), "logits": []}
    last, out = jnp.asarray(toks[:, -1:], jnp.int32), []
    for _ in range(G_SERVE):
        logits, cache = step(params, cache, last)
        run["logits"].append(np.asarray(logits))
        last = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(last))
    run["cache"] = jax.tree.map(np.asarray, cache)
    run["ids"] = np.concatenate(out, axis=1)
    return run


def _check_cache(cache, jcache, label):
    assert cache["groups"].keys() == jcache["groups"].keys()
    assert cache["t"] == int(jcache["t"])
    np.testing.assert_array_equal(cache["pos"].numpy(), jcache["pos"])
    for pk, ent in cache["groups"].items():
        assert ent.keys() == jcache["groups"][pk].keys(), pk
        for n, got in ent.items():
            want = jcache["groups"][pk][n]
            assert tuple(got.shape) == want.shape, (pk, n)
            _close(got, want, f"{label} {pk} {n}")


def test_prefill_and_decode_match_jax(lm_pair, jax_serve):
    """The port's prefill cache (k, v and pos of the attention layer, h
    and conv_buf of the seven Mamba layers), each decode step's logits
    and ids, and the cache after them, fed the JAX run's ids."""
    _, _, tm, tp = lm_pair
    toks = jax_serve["toks"]
    cache, h = tm.prefill(tp, t(toks), cache_len=P_SERVE + G_SERVE + 1)
    _close(h, jax_serve["h"], "prefill hidden")
    _check_cache(cache, jax_serve["cache0"], "prefill cache")
    assert cache["t"] == P_SERVE
    last, decided = toks[:, -1:], 0
    for step, jl in enumerate(jax_serve["logits"]):
        logits, cache = tm.decode_step(tp, cache, t(last))
        _close(logits, jl, f"logits step {step}")
        jl = jl[:, -1]
        top2 = np.sort(jl, -1)[:, -2:]
        ok = top2[:, 1] - top2[:, 0] > ID_GAP
        np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy()[ok],
                                      jl.argmax(-1)[ok])
        decided += int(ok.sum())
        last = jax_serve["ids"][:, step:step + 1]
    assert decided == B_SERVE * G_SERVE
    _check_cache(cache, jax_serve["cache"], "cache after decode")


def test_cache_shapes_match_jax(lm_pair):
    jm, _, tm, _ = lm_pair
    shapes, jshapes = tm.cache_shapes(3, 11), jm.cache_shapes(3, 11)
    assert shapes.keys() == {"groups", "pos"}      # ``t`` is an int here
    assert jshapes.keys() == {"groups", "pos", "t"}
    assert shapes["pos"][0] == jshapes["pos"].shape
    for pk, ent in shapes["groups"].items():
        assert ent.keys() == jshapes["groups"][pk].keys(), pk
        for n, (shape, dtype) in ent.items():
            assert shape == jshapes["groups"][pk][n].shape, (pk, n)
    cache = tm.init_cache(3, 11, device="cpu")
    assert (cache["pos"] == -1).all() and cache["t"] == 0
    assert cache["groups"]["pos0"]["h"].dtype == torch.float32


def test_serve_lm_generates_the_jax_launchers_ids(lm_pair, jax_serve,
                                                 capsys):
    """``serve_lm`` on the JAX parameters gives the JAX launcher's ids."""
    res = serve.serve_lm(get_config(ARCH).reduced(), batch=B_SERVE,
                         prompt_len=P_SERVE, gen=G_SERVE, seed=0,
                         device="cpu", params=lm_pair[3])
    want = jax_serve["ids"]
    np.testing.assert_array_equal(res["generated"], want)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={ARCH} prefill({B_SERVE}x{P_SERVE})=")
    assert lines[1] == f"generated: {want[0].tolist()}"
    assert res["prefill_launches"] == dict.fromkeys(ops.LAUNCHERS, 0)
    assert res["decode_launches"] == dict.fromkeys(ops.LAUNCHERS, 0)


def test_serve_main_serves_jamba_on_the_cpu(capsys):
    res = serve.main(["--device", "cpu", "--arch", ARCH, "--batch", "2",
                      "--prompt-len", "16", "--gen", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert lines[0].startswith(f"arch={ARCH} prefill(2x16)=")
    assert " decode 4 tok: " in lines[0] and lines[0].endswith(" ms/tok")
    assert lines[1] == f"generated: {res['generated'][0].tolist()}"
    assert res["generated"].shape == (2, 4)
    assert ((res["generated"] >= 0) & (res["generated"] < 512)).all()


# ---------------------------------------------------------------------------
# parameters: the port's own init and the conversion's dtypes
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flat(v, key + "::")
        else:
            yield key, v


_TORCH_TO_NP = {torch.float32: np.dtype(np.float32),
                torch.bfloat16: np.dtype(jnp.bfloat16)}


def test_bf16_leaf_dtypes_match_jax_before_and_after_convert(lm_pair):
    """A bf16 copy of the reduced config: every leaf of the port's
    ``LM.init`` and of its conversion of a JAX tree has JAX's dtype (fp32
    for the norms and Mamba's a_log and d_skip; bf16 for dt_bias, conv_b
    and the weights, the MoE's included) and shape. The JAX tree is the
    fp32 one of ``lm_pair`` cast to the dtypes of JAX's bf16 init."""
    jcfg = jax_config(ARCH).reduced().replace(dtype="bfloat16")
    tcfg = get_config(ARCH).reduced().replace(dtype="bfloat16")
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.key(1))
    jparams = jax.tree.map(lambda a, s: a.astype(s.dtype), lm_pair[1],
                           shapes)
    want = {"::".join(str(getattr(k, "key", k)) for k in path):
            np.dtype(leaf.dtype) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert want["groups::pos0::mamba::a_log"] == np.float32
    assert want["groups::pos0::mamba::dt_bias"] == jnp.bfloat16
    assert want["groups::pos1::moe::wi"] == jnp.bfloat16
    flat = flatten_params(jparams)
    mine = dict(_flat(build_model(tcfg).init(torch.Generator()
                                             .manual_seed(1))))
    carried = dict(_flat(convert.lm_params_from_numpy(flat, tcfg,
                                                      device="cpu")))
    for tree in (mine, carried):
        assert tree.keys() == want.keys()
        for k, leaf in tree.items():
            assert _TORCH_TO_NP[leaf.dtype] == want[k], k
            assert tuple(leaf.shape) == flat[k].shape, k
    for k in want:                       # the conversion loses no bits
        np.testing.assert_array_equal(
            carried[k].float().numpy(), np.asarray(flat[k], np.float32),
            err_msg=k)


def test_port_init_has_the_jax_distributions():
    cfg = get_config(ARCH).reduced()
    p = build_model(cfg).init(torch.Generator().manual_seed(0))
    mb = p["groups"]["pos0"]["mamba"]
    ds = cfg.ssm_state_dim
    # log(1 .. ds), correctly rounded (XLA's log may round one ulp away)
    want_a = np.log(np.arange(1, ds + 1)).astype(np.float32)
    np.testing.assert_allclose(mb["a_log"][0, 5].numpy(), want_a, rtol=0,
                               atol=2.0 ** -22)
    assert (mb["a_log"] == mb["a_log"][:, :1]).all()
    assert (mb["d_skip"] == 1.0).all() and not mb["conv_b"].any()
    assert (mb["dt_bias"] == -4.6).all()
    conv = mb["conv"]                     # fan-in is the conv width
    assert conv.abs().max() <= 2.0 / cfg.ssm_conv_width ** 0.5 + 1e-6
    w = p["groups"]["pos1"]["moe"]["wi"]  # (G, E, D, F), fan-in D
    assert w.shape == (1, cfg.num_experts, cfg.d_model, cfg.d_ff)
    assert w.abs().max() <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    std = 0.8796 / cfg.d_model ** 0.5
    assert abs(w.std().item() - std) < 0.05 * std
    assert "ffn" in p["groups"]["pos0"] and "moe" not in p["groups"]["pos0"]
