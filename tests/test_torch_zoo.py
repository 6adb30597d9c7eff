"""The rest of the LM zoo on the port (minitron-4b, granite-34b,
command-r-plus-104b, grok-1-314b, kimi-k2-1t-a32b, internvl2-2b,
whisper-tiny) held against the JAX package on the CPU.

Each arch's reduced fp32 config (2 layers, d 128; kimi-k2 also with its
published head dim 112) runs on parameters that ``repro.models.LM.init``
made and ``repro_torch.convert.lm_params_from_numpy`` carried over; the
prompts and the front-ends' inputs (internvl's patch embeddings, whisper's
frames) are N(0, 1) or uniform ids from numpy with a seed. JAX runs under
``jit``. Tolerances are the LM's (tests/test_torch_lm.py): hidden states,
every cache entry and logits atol 1e-5 plus rtol 1e-5; greedy ids exact
wherever the JAX top-2 logits are more than 1e-4 apart; the layers alone
atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointing import flatten_params
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.sharding.partition import DistContext
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ATOL, RTOL = 1e-5, 1e-5
ID_GAP = 1e-4
ZOO = ("minitron-4b", "granite-34b", "command-r-plus-104b", "grok-1-314b",
       "kimi-k2-1t-a32b", "internvl2-2b", "whisper-tiny")
# (arch, head dim: 0 = the reduced config's 32)
CASES = [(a, 0) for a in ZOO] + [("kimi-k2-1t-a32b", 112)]


def t(a):
    return torch.from_numpy(np.asarray(a))


def _cfgs(arch: str, head_dim: int = 0):
    jc, tc = jax_config(arch).reduced(), get_config(arch).reduced()
    if head_dim:
        jc, tc = jc.replace(head_dim=head_dim), tc.replace(head_dim=head_dim)
    return jc, tc


_PAIRS = {}


def _pair(arch: str, head_dim: int = 0):
    """(JAX model, its parameters, the port's model, the carried-over
    parameters), built once an arch."""
    key = (arch, head_dim)
    if key not in _PAIRS:
        jc, tc = _cfgs(arch, head_dim)
        jm = jax_build(jc)
        params = jm.init(jax.random.key(0))
        tp = convert.lm_params_from_numpy(flatten_params(params), tc,
                                          device="cpu")
        _PAIRS[key] = (jm, params, build_model(tc), tp)
    return _PAIRS[key]


def _extra(cfg, B: int, seed: int):
    """The front-end's inputs, N(0, 1), as numpy: {} for a text model."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.num_frontend_tokens, cfg.d_model)
    if cfg.frontend == "vision":
        return {"patch_embs": rng.standard_normal(shape).astype(np.float32)}
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal(shape).astype(np.float32)}
    return {}


def _close(got, want, label):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL, err_msg=label)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# every arch builds; the converter carries every leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_builds_with_the_jax_tree(arch):
    """``build_model(reduced)`` for every arch: the port's init has the
    JAX init's leaves, shapes and (fp32 norms, cfg.dtype otherwise)
    dtypes, and the converter carries the JAX tree over and back leaf
    for leaf."""
    jc, tc = _cfgs(arch)
    jc, tc = jc.replace(dtype="bfloat16"), tc.replace(dtype="bfloat16")
    jm, tm = jax_build(jc), build_model(tc)
    assert tm.spec == jm.spec
    jp = jm.init(jax.random.key(1))
    flat = flatten_params(jp)
    mine = dict(_leaves(tm.init(torch.Generator().manual_seed(0))))
    dtypes = {"::".join(str(getattr(k, "key", k)) for k in path): leaf.dtype
              for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {k.replace("/", "::") for k in mine} == set(flat)
    for k, v in mine.items():
        jk = k.replace("/", "::")
        assert tuple(v.shape) == flat[jk].shape, k
        assert str(v.dtype).split(".")[-1] == str(dtypes[jk]), k
    tp = convert.lm_params_from_numpy(flat, tc, device="cpu")
    back = convert.lm_params_to_numpy(tp)
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)


# ---------------------------------------------------------------------------
# the layers alone
# ---------------------------------------------------------------------------

def test_gelu_ffn_and_sinusoid_positions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    wi = (0.1 * rng.standard_normal((64, 96))).astype(np.float32)
    wo = (0.1 * rng.standard_normal((96, 64))).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x) @ wi) @ wo)
    got = TL.gelu_ffn(t(x), t(wi), t(wo)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # jax.nn.gelu is the tanh form: torch's default erf form is not it
    erf = (torch.nn.functional.gelu(t(x) @ t(wi)) @ t(wo)).numpy()
    assert np.abs(erf - want).max() > 1e-4
    cfg = get_config("whisper-tiny").reduced()
    params = TT.ffn_init(torch.Generator().manual_seed(0), cfg, "gelu")
    assert set(params) == {"wi", "wo"}
    y, aux = TT.ffn_apply(params, t(x[..., :cfg.d_model // 2].repeat(2, -1)),
                          cfg, "gelu")
    assert y.shape == (2, 9, cfg.d_model) and aux == 0.0
    # XLA's fp32 exp and torch's differ by an ulp in some of the
    # frequencies (19 of whisper's 192), and an angle of p radians moves by
    # p of those ulps: atol 1e-6 plus 2^-23 times the last position
    for seq, d, off in ((1500, 384, 0), (1, 384, 431), (7, 128, 5)):
        np.testing.assert_allclose(
            TL.sinusoid_positions(seq, d, offset=off).numpy(),
            JL.sinusoid_positions(seq, d, offset=off),
            atol=1e-6 + 2.0 ** -23 * (off + seq - 1))


def test_whisper_encoder_and_cross_attention_match_jax():
    """``encoder_apply`` (sinusoid positions, 2 layers of RMS norm,
    non-causal attention and GELU, ``ln_out``) and one layer's
    ``cross_kv`` + ``cross_attn_apply`` on the JAX init's parameters."""
    jm, params, _, tp = _pair("whisper-tiny")
    cfg = jm.cfg
    frames = _extra(cfg, 2, 3)["frames"]
    want = jax.jit(lambda p, f: JT.encoder_apply(p, f, cfg, DistContext()))(
        params["enc"], jnp.asarray(frames))
    got = TT.encoder_apply(tp["enc"], t(frames), cfg)
    _close(got, want, "encoder")
    x = np.random.default_rng(4).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    jcross = jax.tree_util.tree_map(lambda a: a[0],
                                    params["groups"]["pos0"]["cross"])
    tcross = {k: v[0] for k, v in tp["groups"]["pos0"]["cross"].items()}
    jk, jv = JT.cross_kv(jcross, want, cfg)
    tk, tv = TT.cross_kv(tcross, got, cfg)
    _close(tk, jk, "cross k")
    _close(tv, jv, "cross v")
    _close(TT.cross_attn_apply(tcross, t(x), tk, tv, cfg),
           JT.cross_attn_apply(jcross, jnp.asarray(x), jk, jv, cfg),
           "cross-attention")


def test_encoder_takes_flash_on_the_card_and_naive_on_the_cpu(monkeypatch):
    """The encoder's attention: the naive path for CPU frames (the JAX
    function's ``impl="naive"``), the flash path otherwise."""
    cfg = get_config("whisper-tiny").reduced()
    seen = []
    real = TL.attention
    monkeypatch.setattr(TL, "attention",
                        lambda *a, **kw: seen.append(kw["impl"])
                        or real(*a, **kw))
    params = TT.encoder_init(torch.Generator().manual_seed(0), cfg)
    TT.encoder_apply(params, torch.zeros((1, 8, cfg.d_model)), cfg)
    assert seen == ["naive"] * cfg.enc_layers


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,head_dim", CASES)
def test_prefill_and_decode_match_jax(arch, head_dim):
    """``LM.prefill`` of a 2 x 24 prompt (after internvl's 16 patches;
    whisper over 16 frames) into 48 slots, then 4 ``decode_step``s fed
    JAX's greedy ids: hidden states, every cache entry (k, v, whisper's
    ck and cv), ``pos``, ``t`` and the logits."""
    jm, params, tm, tp = _pair(arch, head_dim)
    cfg, dist = jm.cfg, DistContext()
    B, S, C = 2, 24, 48
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, S))
    extra = _extra(cfg, B, 10)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    jcache, jh = jax.jit(lambda p, tk, ex: jm.prefill(
        p, tk, ex, dist, cache_len=C))(params, jnp.asarray(toks, jnp.int32),
                                        jextra)
    cache, h = tm.prefill(tp, t(toks), {k: t(v) for k, v in extra.items()},
                          cache_len=C)
    prefix = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
    assert h.shape == (B, S + prefix, cfg.d_model)
    _close(h, jh, "prefill hidden")
    for pk, ent in jcache["groups"].items():
        assert set(cache["groups"][pk]) == set(ent)
        for n, leaf in ent.items():
            assert cache["groups"][pk][n].shape == leaf.shape
            _close(cache["groups"][pk][n], leaf, f"cache {pk} {n}")
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert cache["t"] == int(jcache["t"]) == S + prefix
    step = jax.jit(lambda p, c, tk: jm.decode_step(p, c, tk, jextra, dist))
    last, decided = toks[:, -1:], 0
    for i in range(4):
        jl, jcache = step(params, jcache, jnp.asarray(last, jnp.int32))
        logits, cache = tm.decode_step(tp, cache, t(last))
        _close(logits, jl, f"logits step {i}")
        jl = np.asarray(jl)[:, -1]
        top2 = np.sort(jl, -1)[:, -2:]
        ok = top2[:, 1] - top2[:, 0] > ID_GAP
        np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy()[ok],
                                      jl.argmax(-1)[ok])
        decided += int(ok.sum())
        last = jl.argmax(-1)[:, None]
    assert decided == 2 * 4
    assert cache["t"] == int(jcache["t"]) == S + prefix + 4
    for pk, ent in jcache["groups"].items():
        _close(cache["groups"][pk]["k"], ent["k"], f"cache {pk} k after")


@pytest.mark.parametrize("arch,head_dim,S", [("kimi-k2-1t-a32b", 112, 256),
                                             ("internvl2-2b", 0, 240)])
def test_hidden_through_the_flash_branch_matches_jax(arch, head_dim, S,
                                                     monkeypatch):
    """``impl="flash"`` over 256 positions (internvl: 16 patches and 240
    tokens), the kernel's plain version on the CPU, against JAX's flash
    branch: kimi-k2 at head dim 112, the vision prefix through it;
    ``hidden`` returns JAX's prefix length."""
    jm, params, tm, tp = _pair(arch, head_dim)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(TL.ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    toks = np.random.default_rng(S).integers(0, jm.cfg.vocab_size, (1, S))
    extra = _extra(jm.cfg, 1, 11)
    want, wprefix, _, _ = jax.jit(lambda p, tk, ex: jm.hidden(
        p, tk, ex, DistContext(), impl="flash"))(
        params, jnp.asarray(toks, jnp.int32),
        {k: jnp.asarray(v) for k, v in extra.items()})
    got, prefix, aux, cache = tm.hidden(
        tp, t(toks), {k: t(v) for k, v in extra.items()}, impl="flash")
    assert cache is None and prefix == int(wprefix)
    assert len(calls) == jm.cfg.num_layers
    _close(got, want, f"hidden S={S}")


@pytest.mark.parametrize("causal,softcap", [(True, 0.0), (True, 30.0)])
def test_attention_at_2048_and_head_dim_112_matches_jax(causal, softcap):
    """``layers.attention(impl="auto")`` at a prefill's 2048 positions
    and kimi-k2's head dim 112 takes the flash branch in both packages:
    the port's plain flash version against ``flash_attention_jax``
    (fp32, atol 2e-5: tests/test_kernels.py's)."""
    rng = np.random.default_rng(112)
    q = rng.standard_normal((1, 2048, 4, 112)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2048, 2, 112)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, softcap=softcap)
    np.testing.assert_allclose(
        TL.attention(t(q), t(k), t(v), **kw).numpy(),
        JL.attention(*(jnp.asarray(a) for a in (q, k, v)), **kw), atol=2e-5)


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-tiny",
                                  "grok-1-314b"])
def test_serve_lm_generates_the_jax_launchers_ids(arch, capsys):
    """``serve_lm`` and the JAX launcher's LM loop (zeros for the
    front-end's inputs, a cache of prompt + gen + prefix + 1 slots, greedy
    decode fed the prompt's last token first) give the same ids at
    --batch 2 --prompt-len 8 --gen 4."""
    jm, params, _, tp = _pair(arch)
    cfg, dist = jm.cfg, DistContext()
    B, P, G, seed = 2, 8, 4, 0
    rng = np.random.default_rng(seed)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (B, P)), jnp.int32)
    shape = (B, cfg.num_frontend_tokens, cfg.d_model)
    extra = ({"patch_embs": jnp.zeros(shape)} if cfg.frontend == "vision"
             else {"frames": jnp.zeros(shape)} if cfg.frontend == "audio"
             else {})
    prefix = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
    cache, _ = jm.prefill(params, toks, extra, dist,
                          cache_len=P + G + prefix + 1)
    step = jax.jit(lambda p, c, tk: jm.decode_step(p, c, tk, extra, dist))
    last, out = toks[:, -1:], []
    for _ in range(G):
        logits, cache = step(params, cache, last)
        last = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(last))
    want = np.concatenate(out, axis=1)
    res = serve.serve_lm(get_config(arch).reduced(), batch=B, prompt_len=P,
                         gen=G, seed=seed, device="cpu", params=tp)
    np.testing.assert_array_equal(res["generated"], want)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={arch} prefill({B}x{P})=")
    assert lines[1] == f"generated: {want[0].tolist()}"


@pytest.mark.parametrize("arch", ZOO)
def test_serve_main_serves_the_arch_on_the_cpu(arch, capsys):
    res = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                      "--prompt-len", "8", "--gen", "2"])
    gen = res["generated"]
    assert gen.shape == (2, 2) and ((gen >= 0) & (gen < 512)).all()
    assert torch.isfinite(res["last_logits"]).all()
    assert res["prefill_launches"] == dict.fromkeys(ops.LAUNCHERS, 0)
    out = capsys.readouterr().out
    assert out.startswith(f"arch={arch} prefill(2x8)=")
