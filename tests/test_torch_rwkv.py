"""The port's RWKV6 path (the plain WKV version, ``models/ssm.py``'s RWKV6
half, the rwkv6-7b ``LM`` and its serve drive) held against the JAX
package on the CPU.

Inputs come from numpy with a seed; the models run on parameters that
``repro``'s initialisers made and ``repro_torch.convert
.lm_params_from_numpy`` carried over (through
``repro.checkpoint.checkpointing.flatten_params``). Tolerances:

- the WKV recurrence: y atol 5e-5, tests/test_kernels.py's bound for the
  Pallas kernel against its oracle; the final state, which JAX's kernel
  does not return, against a float64 numpy recurrence at the same bound;
- the mixer (d 128, fp32): ``x_prev`` is a slice of the input, atol
  1e-6; the projections, y, the state S (a sum over time) and the decode
  step's output atol 1e-5 + rtol 1e-5, as tests/test_torch_lm.py holds
  the reduced yi-6b: the two packages sum the same fp32 products in
  another order (matmuls of width 128, the recurrence's einsums);
- the reduced LM (2 layers, d 128, fp32): hidden states, logits and the
  cache (S, and x_prev, the last layer's mixer input, which the first
  layer's sums have moved) atol 1e-5 + rtol 1e-5;
- greedy ids exact wherever the JAX top-2 logits are more than 1e-4
  apart, and the serve drive's ids exact.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import flatten_params
from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv_wkv import rwkv_wkv_pallas
from repro.models import build_model as jax_build
from repro.models import ssm as jssm
from repro.sharding.partition import DistContext
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import ssm

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-7b"
ATOL_WKV = 5e-5
ATOL, RTOL = 1e-5, 1e-5
ID_GAP = 1e-4


def t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, label, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=label)


# ---------------------------------------------------------------------------
# the WKV recurrence
# ---------------------------------------------------------------------------

def _wkv_inputs(B, S, H, d, seed):
    """tests/test_kernels.py's ranges: r, k, v 0.5 N(0, 1); w in (0.5, 1);
    u 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, S, H, d)).astype(np.float32)
               for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((B, S, H, d))))
         + 0.5).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, d))).astype(np.float32)
    return r, k, v, w, u


def _state_f64(k, v, w):
    """The state after the last step, in float64: S <- S w + k v^T."""
    B, S, H, d = k.shape
    st = np.zeros((B, H, d, d))
    for i in range(S):
        st = (st * w[:, i, :, :, None].astype(np.float64)
              + k[:, i, :, :, None].astype(np.float64)
              * v[:, i, :, None, :].astype(np.float64))
    return st


@pytest.mark.parametrize("B,S,H,d,seq_block", [
    (1, 64, 1, 16, None), (2, 128, 2, 32, None), (3, 96, 4, 16, None),
    (1, 256, 1, 16, 64)])          # the Pallas kernel's chunked state carry
def test_wkv_plain_matches_pallas_and_jax_ref(B, S, H, d, seq_block):
    r, k, v, w, u = _wkv_inputs(B, S, H, d, seed=B * S + H)
    ja = [jnp.asarray(a) for a in (r, k, v, w, u)]
    if seq_block is None:
        pallas = jops.rwkv_wkv(*ja, interpret=True)
    else:
        pallas = rwkv_wkv_pallas(*ja, seq_block=seq_block, interpret=True)
    y, s_fin = ref.rwkv_wkv_ref(*map(t, (r, k, v, w, u)))
    assert y.dtype == s_fin.dtype == torch.float32
    assert y.shape == (B, S, H, d) and s_fin.shape == (B, H, d, d)
    _close(y, pallas, "y vs Pallas", atol=ATOL_WKV, rtol=0)
    _close(y, jref.rwkv_wkv_ref(*ja), "y vs JAX ref", atol=ATOL_WKV, rtol=0)
    _close(s_fin, _state_f64(k, v, w), "S_fin", atol=ATOL_WKV, rtol=0)


def test_wkv_plain_widens_bf16_inputs():
    """r, k, v in bf16 (the full-width model dtype) read as their fp32
    values; w and u stay fp32."""
    r, k, v, w, u = _wkv_inputs(2, 40, 2, 32, seed=5)
    rb, kb, vb = (t(a).to(torch.bfloat16) for a in (r, k, v))
    y, s_fin = ref.rwkv_wkv_ref(rb, kb, vb, t(w), t(u))
    y32, s32 = ref.rwkv_wkv_ref(rb.float(), kb.float(), vb.float(), t(w),
                                t(u))
    assert torch.equal(y, y32) and torch.equal(s_fin, s32)
    _close(y, jref.rwkv_wkv_ref(*(jnp.asarray(a.float().numpy())
                                   for a in (rb, kb, vb)),
                                 jnp.asarray(w), jnp.asarray(u)),
           "bf16 inputs", atol=ATOL_WKV, rtol=0)


# ---------------------------------------------------------------------------
# the RWKV6 mixer on JAX-initialised parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixer_pair():
    cfg = jax_config(ARCH).reduced()
    jp = jssm.rwkv6_init(jax.random.key(0), cfg)
    tp = convert.lm_params_from_numpy(flatten_params(jp),
                                      get_config(ARCH).reduced(),
                                      device="cpu")
    return cfg, jp, get_config(ARCH).reduced(), tp


def test_mixer_projections_state_and_decode_match_jax(mixer_pair):
    cfg, jp, tcfg, tp = mixer_pair
    rng = np.random.default_rng(3)
    B, S, D = 2, 48, cfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, D)).astype(np.float32)
    x_prev = np.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :S]
    want = jssm._rwkv_projections(jp, jnp.asarray(x), jnp.asarray(x_prev),
                                  cfg)
    got = ssm._rwkv_projections(tp, t(x), t(x_prev), tcfg)
    for name, g, w in zip("rkvgw", got, want):
        assert g.shape == w.shape, name
        _close(g, w, f"projection {name}")
    jy, jst = jssm.rwkv6_apply_state(jp, jnp.asarray(x), cfg)
    y, st = ssm.rwkv6_apply_state(tp, t(x), tcfg)
    assert y.shape == (B, S, D) and st["S"].dtype == torch.float32
    _close(y, jy, "y")
    _close(st["S"], jst["S"], "S")
    _close(st["x_prev"], jst["x_prev"], "x_prev", atol=1e-6, rtol=0)
    jy1, jst1 = jssm.rwkv6_decode(jp, jnp.asarray(x1), jst, cfg)
    y1, st1 = ssm.rwkv6_decode(tp, t(x1), st, tcfg)
    _close(y1, jy1, "decode y")
    _close(st1["S"], jst1["S"], "decode S")
    _close(st1["x_prev"], jst1["x_prev"], "decode x_prev", atol=1e-6,
           rtol=0)
    assert ssm.rwkv6_apply(tp, t(x), tcfg).shape == (B, S, D)
    empty = ssm.rwkv6_init_state(tcfg, B, torch.float32, device="cpu")
    jempty = jssm.rwkv6_init_state(cfg, B, jnp.float32)
    for n in ("S", "x_prev"):
        assert tuple(empty[n].shape) == jempty[n].shape
        assert not empty[n].any()


def test_rwkv6_init_state_defaults_to_the_card(mixer_pair, monkeypatch):
    """Like every entry point of the port, the empty state is made on the
    card unless the caller names the CPU: without a card the default
    raises the "no CUDA device" error instead of falling back."""
    tcfg = mixer_pair[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssm.rwkv6_init_state(tcfg, 2, torch.float32)


def test_mixer_prefill_on_cpu_launches_nothing(mixer_pair):
    _, _, tcfg, tp = mixer_pair
    ops.reset_launch_counts()
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 8, tcfg.d_model)).astype(np.float32))
    ssm.rwkv6_apply_state(tp, x, tcfg)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHERS, 0)


# ---------------------------------------------------------------------------
# the reduced rwkv6-7b LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_pair():
    cfg = jax_config(ARCH).reduced()
    jm = jax_build(cfg)
    params = jm.init(jax.random.key(0))
    tcfg = get_config(ARCH).reduced()
    tp = convert.lm_params_from_numpy(flatten_params(params), tcfg,
                                      device="cpu")
    return jm, params, build_model(tcfg), tp


def test_hidden_matches_jax(lm_pair):
    jm, params, tm, tp = lm_pair
    toks = np.random.default_rng(64).integers(0, jm.cfg.vocab_size, (2, 64))
    want = jm.hidden(params, jnp.asarray(toks, jnp.int32), {},
                     DistContext())[0]
    got, prefix, aux, cache = tm.hidden(tp, t(toks))
    assert cache is None and prefix == 0
    assert aux.shape == () and float(aux) == 0.0  # no MoE layer
    _close(got, want, "hidden")


def test_prefill_and_decode_match_jax(lm_pair):
    jm, params, tm, tp = lm_pair
    dist = DistContext()
    S, C = 40, 52
    toks = np.random.default_rng(9).integers(0, jm.cfg.vocab_size, (2, S))
    jcache, jh = jm.prefill(params, jnp.asarray(toks, jnp.int32), {}, dist,
                            cache_len=C)
    cache, h = tm.prefill(tp, t(toks), cache_len=C)
    _close(h, jh, "prefill hidden")
    assert "pos" not in cache and "pos" not in jcache
    assert cache["groups"].keys() == jcache["groups"].keys() == {"pos0"}
    assert cache["t"] == int(jcache["t"]) == S

    def check_cache(label):
        # x_prev is the last layer's mixer input, after the first layer
        for n in ("S", "x_prev"):
            got, want = cache["groups"]["pos0"][n], jcache["groups"]["pos0"][n]
            assert tuple(got.shape) == want.shape, n
            _close(got, want, f"{label} {n}")

    check_cache("prefill cache")
    last = toks[:, -1:]
    decided = 0
    for step in range(8):
        jl, jcache = jm.decode_step(params, jcache,
                                    jnp.asarray(last, jnp.int32), {}, dist)
        logits, cache = tm.decode_step(tp, cache, t(last))
        _close(logits, jl, f"logits step {step}")
        jl = np.asarray(jl)[:, -1]
        top2 = np.sort(jl, -1)[:, -2:]
        ok = top2[:, 1] - top2[:, 0] > ID_GAP
        np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy()[ok],
                                      jl.argmax(-1)[ok])
        decided += int(ok.sum())
        last = jl.argmax(-1)[:, None]
    assert decided == 16
    assert cache["t"] == int(jcache["t"]) == S + 8
    check_cache("cache after decode")


def test_cache_shapes_follow_the_mixers():
    """No ``pos`` when no layer attends; the llama cache keeps it."""
    rw = build_model(get_config(ARCH).reduced())
    jrw = jax_build(jax_config(ARCH).reduced())
    shapes, jshapes = rw.cache_shapes(3, 11), jrw.cache_shapes(3, 11)
    assert "pos" not in shapes and "pos" not in jshapes
    for n, (shape, dtype) in shapes["groups"]["pos0"].items():
        assert shape == jshapes["groups"]["pos0"][n].shape, n
    assert "pos" in build_model(get_config("yi-6b").reduced()).cache_shapes(
        3, 11)


def test_serve_lm_generates_the_jax_launchers_ids(lm_pair, capsys):
    """``serve_lm`` and the JAX launcher's LM loop (repro/launch/serve.py:
    prefill at prompt + gen + 1 slots, greedy decode fed the prompt's last
    token first) give the same ids at --batch 2 --prompt-len 16 --gen 4."""
    jm, params, _, tp = lm_pair
    B, P, G, seed = 2, 16, 4, 0
    dist = DistContext()
    rng = np.random.default_rng(seed)
    toks = jnp.asarray(rng.integers(0, jm.cfg.vocab_size, (B, P)),
                       jnp.int32)
    cache, _ = jm.prefill(params, toks, {}, dist, cache_len=P + G + 1)
    last, out = toks[:, -1:], []
    for _ in range(G):
        logits, cache = jm.decode_step(params, cache, last, {}, dist)
        last = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(last))
    want = np.concatenate(out, axis=1)
    res = serve.serve_lm(get_config(ARCH).reduced(), batch=B, prompt_len=P,
                         gen=G, seed=seed, device="cpu", params=tp)
    np.testing.assert_array_equal(res["generated"], want)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={ARCH} prefill({B}x{P})=")
    assert lines[1] == f"generated: {want[0].tolist()}"
    assert res["prefill_launches"] == dict.fromkeys(ops.LAUNCHERS, 0)
    assert res["decode_launches"] == dict.fromkeys(ops.LAUNCHERS, 0)


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


def _jax_dtypes(params):
    return {"::".join(str(getattr(k, "key", k)) for k in path):
            np.dtype(leaf.dtype) for path, leaf in
            jax.tree_util.tree_flatten_with_path(params)[0]}


_TORCH_TO_NP = {torch.float32: np.dtype(np.float32),
                torch.bfloat16: np.dtype(jnp.bfloat16)}


def test_bf16_leaf_dtypes_match_jax_before_and_after_convert():
    """A bf16 copy of the reduced config: every leaf of the port's
    ``LM.init`` and of its conversion of JAX's tree has JAX's dtype (fp32
    for the norms and RWKV6's u, dec_0 and ln_x; bf16 for mu and the
    weights) and shape."""
    jcfg = jax_config(ARCH).reduced().replace(dtype="bfloat16")
    tcfg = get_config(ARCH).reduced().replace(dtype="bfloat16")
    jparams = jax_build(jcfg).init(jax.random.key(1))
    want = _jax_dtypes(jparams)
    assert want["groups::pos0::rwkv6::u"] == np.float32
    assert want["groups::pos0::rwkv6::mu"] == jnp.bfloat16
    shapes = {k: v.shape for k, v in flatten_params(jparams).items()}
    mine = dict(_flat(build_model(tcfg).init(torch.Generator()
                                             .manual_seed(1))))
    carried = dict(_flat(convert.lm_params_from_numpy(
        flatten_params(jparams), tcfg, device="cpu")))
    for tree in (mine, carried):
        assert tree.keys() == want.keys()
        for k, leaf in tree.items():
            assert _TORCH_TO_NP[leaf.dtype] == want[k], k
            assert tuple(leaf.shape) == shapes[k], k
    for k in want:                       # the conversion loses no bits
        np.testing.assert_array_equal(
            carried[k].float().numpy(),
            np.asarray(flatten_params(jparams)[k], np.float32), err_msg=k)


def test_port_init_has_the_jax_distributions():
    cfg = get_config(ARCH).reduced()
    p = build_model(cfg).init(torch.Generator().manual_seed(0))
    rw = p["groups"]["pos0"]["rwkv6"]
    assert (rw["dec_0"] == -2.0).all() and not rw["ln_x"].any()
    assert 0.0 <= rw["mu"].min() and rw["mu"].max() < 1.0
    assert abs(rw["mu"].mean().item() - 0.5) < 0.05
    assert abs(rw["u"].std().item() - 0.1) < 0.02
    w = rw["w_r"]                         # N(0, 1) cut at +-2, / sqrt(D)
    assert w.abs().max() <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    std = 0.8796 / cfg.d_model ** 0.5
    assert abs(w.std().item() - std) < 0.05 * std


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_main_serves_rwkv6_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--batch", "2", "--prompt-len", "16", "--gen", "4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 2
    assert lines[0].startswith(f"arch={ARCH} prefill(2x16)=")
    assert " decode 4 tok: " in lines[0] and lines[0].endswith(" ms/tok")
    ids = eval(lines[1].removeprefix("generated: "))
    assert len(ids) == 4 and all(0 <= i < 512 for i in ids)
