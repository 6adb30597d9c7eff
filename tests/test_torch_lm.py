"""The port's llama path (repro_torch.configs, models, convert and the LM
mode of launch/serve) held against the JAX package on the CPU.

Inputs and prompts come from numpy with a seed; the model runs on
parameters that ``repro.models.LM.init`` made and
``repro_torch.convert.lm_params_from_numpy`` carried over (through
``repro.checkpoint.checkpointing.flatten_params``). Tolerances: the layers
atol 1e-6 (fp32); hidden states and logits of the reduced yi-6b (2 layers,
d 128, fp32) atol 1e-5 plus rtol 1e-5: after the final norm they reach a
few units, and the two packages sum the same fp32 products in another
order (the JAX flash scans chunks of 1024 keys, the port's plain version
tiles of 32), which moves the larger values by a few ulps. Greedy ids are
exact wherever the JAX top-2 logits are more than 1e-4 apart, and the
serve drive's ids are exact.
"""
import dataclasses
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
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.sharding.partition import DistContext
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import PORTED_ARCHS, build_model
from repro_torch.models import layers as TL

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-5, 1e-5
ID_GAP = 1e-4


def t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_configs_are_the_jax_packages():
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for port, ref in ((get_config(arch), jax_config(arch)),
                          (get_config(arch).reduced(),
                           jax_config(arch).reduced())):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
            assert port.layer_pattern() == ref.layer_pattern()
            assert port.param_count() == ref.param_count()


def test_unported_archs_and_parts_refuse_naming_roadmap(monkeypatch):
    """Every arch builds, serves and trains. The five text archs of the
    zoo take a reduced step through the launcher; internvl2-2b and
    whisper-tiny, whose batches must carry their front-end's input, are
    refused by the launcher with a ValueError naming the missing batch
    key (the JAX launcher fails inside its first step). The flash
    backward takes kimi-k2's head dim 112: under grad the launcher runs
    its Function (its device check and launch stubbed), one forward
    launch, and the backward launches at d 112."""
    assert PORTED_ARCHS == tuple(ARCH_IDS)
    from repro_torch.launch import train
    from repro_torch.models.model import LM
    assert train.TRAINED_ARCHS == tuple(ARCH_IDS)
    argv = ["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "8",
            "--nodes", "16"]
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        assert isinstance(build_model(cfg), LM)
        key = train.FRONTEND_KEYS.get(cfg.frontend)
        if key is None:
            if arch not in ("yi-6b", "rwkv6-7b", "jamba-1.5-large-398b"):
                res = train.main(argv + ["--arch", arch])
                assert len(res["losses"]) == 1
                assert np.isfinite(res["losses"]).all()
            continue
        with pytest.raises(ValueError, match=key):
            train.main(argv + ["--arch", arch])
        with pytest.raises(ValueError, match=key):
            train.train_carls(cfg, steps=1, batch=2, seq=8, nodes=16,
                              lr=1e-3, maker_every=1, device="cpu")
    assert {a for a in ARCH_IDS if get_config(a).frontend != "none"} == {
        "internvl2-2b", "whisper-tiny"}
    base = get_config("yi-6b").reduced()
    # Mamba mixers, MoE, GELU feed-forwards and the front-ends are ported
    assert LM(base.replace(ssm_type="mamba")).spec == [("mamba", "swiglu")]
    assert LM(base.replace(num_experts=4, experts_per_token=2)).spec == [
        ("attn", "moe")]
    assert LM(get_config("whisper-tiny").reduced()).spec == [
        ("attn", "gelu")]
    from repro_torch.kernels import flash_attention as fa
    launched = []
    monkeypatch.setattr(fa, "require_cuda", lambda *a: None)
    monkeypatch.setattr(fa, "launch", lambda *a: launched.append(a))
    q = torch.zeros((1, 8, 2, 112), requires_grad=True)
    kv = torch.zeros((1, 8, 2, 112))
    out = fa.flash_attention_cuda(q, kv, kv)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert [a[1] for a in launched] == ["flash_attention_launch"]
    fa.flash_attention_bwd_cuda(q.detach(), kv, kv, q.detach(),
                                torch.zeros((1, 2, 8)), q.detach())
    assert [a[1] for a in launched] == ["flash_attention_launch",
                                        "flash_attention_bwd_launch"]
    assert launched[1][-6] == 112         # d, as the launch passes it
    fa.flash_attention_cuda(q.detach(), kv, kv)     # no grad: the kernel
    assert len(launched) == 3


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _qkv(B, S, H, KV, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, d)).astype(np.float32),
            rng.standard_normal((B, S, KV, d)).astype(np.float32),
            rng.standard_normal((B, S, KV, d)).astype(np.float32))


def test_norm_rope_swiglu_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(64)).astype(np.float32)
    np.testing.assert_allclose(TL.rms_norm(t(x), t(scale), 1e-5).numpy(),
                               JL.rms_norm(jnp.asarray(x), scale, 1e-5),
                               atol=1e-6)
    xh = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    for pos in (np.arange(9), np.arange(18).reshape(2, 9) + 5):
        np.testing.assert_allclose(
            TL.apply_rope(t(xh), t(pos), 1e6).numpy(),
            JL.apply_rope(jnp.asarray(xh), jnp.asarray(pos), 1e6),
            atol=1e-6)
    wi, wg = (0.1 * rng.standard_normal((64, 96)).astype(np.float32)
              for _ in range(2))
    wo = 0.1 * rng.standard_normal((96, 64)).astype(np.float32)
    np.testing.assert_allclose(
        TL.swiglu(t(x), t(wi), t(wg), t(wo)).numpy(),
        JL.swiglu(jnp.asarray(x), wi, wg, wo), atol=1e-6)


@pytest.mark.parametrize("causal,window,softcap,q_offset", [
    (True, 0, 0.0, 0), (False, 0, 0.0, 0), (True, 5, 0.0, 0),
    (True, 0, 20.0, 0), (True, 0, 0.0, 7)])
def test_naive_attention_matches_jax(causal, window, softcap, q_offset):
    q, k, v = _qkv(2, 12, 4, 2, 32, 1)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    np.testing.assert_allclose(
        TL.naive_attention(t(q), t(k), t(v), **kw).numpy(),
        JL.naive_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw),
        atol=1e-6)


def test_decode_attention_and_ring_positions_match_jax():
    q, k, v = _qkv(2, 10, 4, 2, 32, 2)
    q = q[:, :1]
    pos = np.array([[0, 1, 2, 3, 4, 5, 6, -1, -1, -1],
                    [10, 11, 2, 3, 4, 5, 6, 7, 8, 9]], np.int32)
    qpos = np.array([6, 11], np.int32)
    for window, softcap in ((0, 0.0), (4, 0.0), (0, 15.0)):
        kw = dict(window=window, softcap=softcap)
        np.testing.assert_allclose(
            TL.decode_attention(t(q), t(k), t(v), t(pos),
                                q_position=t(qpos), **kw).numpy(),
            JL.decode_attention(*(jnp.asarray(a) for a in (q, k, v, pos)),
                                q_position=jnp.asarray(qpos), **kw),
            atol=1e-6)
        np.testing.assert_allclose(
            TL.attention(t(q), t(k), t(v), causal=True, softcap=softcap,
                         kv_positions=t(pos)).numpy(),
            JL.attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                         softcap=softcap, kv_positions=jnp.asarray(pos)),
            atol=1e-6)


def test_attention_dispatch_follows_jax(monkeypatch):
    """``auto``: naive below 2048^2 score entries, for one query or a ring
    cache; the flash path otherwise and for ``impl="flash"``."""
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(TL.ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    small = [t(a) for a in _qkv(1, 64, 2, 1, 32, 3)]
    TL.attention(*small, causal=True)
    assert not calls
    TL.attention(*small, causal=True, impl="flash")
    assert len(calls) == 1
    big = [t(a) for a in _qkv(1, 2048, 1, 1, 32, 4)]
    TL.attention(*big, causal=True)
    assert len(calls) == 2
    TL.attention(*big, causal=True, kv_positions=t(np.arange(2048)[None]))
    TL.attention(*big, causal=True, impl="naive")
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# the model, on JAX-initialised parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_pair():
    cfg = jax_config("yi-6b").reduced()
    jm = jax_build(cfg)
    params = jm.init(jax.random.key(0))
    tcfg = get_config("yi-6b").reduced()
    tp = convert.lm_params_from_numpy(flatten_params(params), tcfg,
                                      device="cpu")
    return jm, params, build_model(tcfg), tp


def _assert_close(got, want, label):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL, err_msg=label)


@pytest.mark.parametrize("S,impl", [(256, "flash"), (2048, "auto")])
def test_hidden_matches_jax(lm_pair, S, impl, monkeypatch):
    jm, params, tm, tp = lm_pair
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(TL.ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    toks = np.random.default_rng(S).integers(0, jm.cfg.vocab_size, (1, S))
    want = jm.hidden(params, jnp.asarray(toks, jnp.int32), {}, DistContext(),
                     impl=impl)[0]
    got, prefix, aux, cache = tm.hidden(tp, t(toks), impl=impl)
    assert cache is None and prefix == 0
    assert aux.shape == () and float(aux) == 0.0  # no MoE layer
    assert len(calls) == jm.cfg.num_layers        # the flash branch
    _assert_close(got, want, f"hidden S={S}")


def test_prefill_and_decode_match_jax(lm_pair):
    jm, params, tm, tp = lm_pair
    dist = DistContext()
    S, C = 40, 48
    toks = np.random.default_rng(9).integers(0, jm.cfg.vocab_size, (2, S))
    jcache, jh = jm.prefill(params, jnp.asarray(toks, jnp.int32), {}, dist,
                            cache_len=C)
    cache, h = tm.prefill(tp, t(toks), cache_len=C)
    _assert_close(h, jh, "prefill hidden")
    jg = jcache["groups"]["pos0"]
    for n in ("k", "v"):
        assert cache["groups"]["pos0"][n].shape == jg[n].shape
        _assert_close(cache["groups"]["pos0"][n], jg[n], f"cache {n}")
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert cache["t"] == int(jcache["t"]) == S
    last = toks[:, -1:]
    decided = 0
    for step in range(4):
        jl, jcache = jm.decode_step(params, jcache,
                                    jnp.asarray(last, jnp.int32), {}, dist)
        logits, cache = tm.decode_step(tp, cache, t(last))
        _assert_close(logits, jl, f"logits step {step}")
        jl = np.asarray(jl)[:, -1]
        top2 = np.sort(jl, -1)[:, -2:]
        ok = top2[:, 1] - top2[:, 0] > ID_GAP
        np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy()[ok],
                                      jl.argmax(-1)[ok])
        decided += int(ok.sum())
        last = jl.argmax(-1)[:, None]
    assert decided == 8
    assert cache["t"] == int(jcache["t"]) == S + 4
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    _assert_close(cache["groups"]["pos0"]["k"], jcache["groups"]["pos0"]["k"],
                  "cache k after decode")


def test_serve_lm_generates_the_jax_launchers_ids(lm_pair, capsys):
    """``serve_lm`` and the JAX launcher's LM loop (repro/launch/serve.py:
    prefill at prompt + gen + 1 slots, greedy decode fed the prompt's last
    token first) give the same ids at --batch 2 --prompt-len 8 --gen 4."""
    jm, params, _, tp = lm_pair
    B, P, G, seed = 2, 8, 4, 0
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
    res = serve.serve_lm(get_config("yi-6b").reduced(), batch=B,
                         prompt_len=P, gen=G, seed=seed, device="cpu",
                         params=tp)
    np.testing.assert_array_equal(res["generated"], want)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch=yi-6b prefill({B}x{P})=")
    assert lines[0].endswith(" ms/tok") and f"decode {G} tok: " in lines[0]
    assert lines[1] == f"generated: {want[0].tolist()}"
    assert res["prefill_launches"] == dict.fromkeys(ops.LAUNCHERS, 0)


# ---------------------------------------------------------------------------
# parameters: conversion and the port's own init
# ---------------------------------------------------------------------------

def test_convert_keeps_bf16_and_fp32_norms():
    cfg = jax_config("yi-6b").reduced().replace(dtype="bfloat16")
    params = jax_build(cfg).init(jax.random.key(1))
    tcfg = get_config("yi-6b").reduced().replace(dtype="bfloat16")
    for flat in (flatten_params(params),        # bf16 widened to fp32
                 {"::".join(str(getattr(k, "key", k)) for k in path):
                  np.asarray(leaf) for path, leaf in
                  jax.tree_util.tree_flatten_with_path(params)[0]}):
        tp = convert.lm_params_from_numpy(flat, tcfg, device="cpu")
        assert tp["final_norm"].dtype == torch.float32
        g = tp["groups"]["pos0"]
        assert g["ln1"].dtype == g["ln2"].dtype == torch.float32
        for w, ref in ((g["attn"]["wq"], params["groups"]["pos0"]["attn"]
                        ["wq"]), (tp["out_embed"], params["out_embed"])):
            assert w.dtype == torch.bfloat16 and w.shape == ref.shape
            np.testing.assert_array_equal(w.float().numpy(),
                                          np.asarray(ref, np.float32))


def test_port_init_has_the_jax_shapes_and_scales():
    cfg = get_config("yi-6b").reduced()
    tp = build_model(cfg).init(torch.Generator().manual_seed(0))
    jp = jax_build(jax_config("yi-6b").reduced()).init(jax.random.key(0))
    flat_t = {k: v for k, v in _flat(tp)}
    flat_j = flatten_params(jp)
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        assert tuple(flat_t[k].shape) == flat_j[k].shape, k
    g = tp["groups"]["pos0"]
    assert not g["ln1"].any() and not tp["final_norm"].any()
    wq = g["attn"]["wq"]                   # N(0, 1) cut at +-2, / sqrt(D)
    assert wq.abs().max() <= 2.0 / cfg.d_model ** 0.5 + 1e-6
    std = 0.8796 / cfg.d_model ** 0.5      # std of the cut normal
    assert abs(wq.std().item() - std) < 0.05 * std
    assert abs(tp["embed"]["tok"].std().item() - 0.02) < 0.001


def _flat(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flat(v, key + "::")
        else:
            yield key, v


# ---------------------------------------------------------------------------
# the launcher's device rule
# ---------------------------------------------------------------------------

def test_lm_serve_without_a_card_exits_with_the_no_cuda_error():
    proc = subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.launch.serve import main; main([])"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "generated" not in proc.stdout


def test_lm_serve_main_on_the_cpu(capsys):
    res = serve.main(["--device", "cpu", "--arch", "yi-6b", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4"])
    assert res["generated"].shape == (2, 4)
    out = capsys.readouterr().out
    assert out.startswith("arch=yi-6b prefill(2x8)=")
    assert f"generated: {res['generated'][0].tolist()}" in out
