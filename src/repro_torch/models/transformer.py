"""Attention mixer, feed-forward blocks and the whisper-style encoder; the
port of ``repro/models/transformer.py``.

Parameters are plain dicts of tensors under the JAX package's names
(wq/wk/wv/wo, wi/wg/wo; the encoder's ln1/attn/ln2/ffn/ln_out), stacked
over ``batch_dims`` as there. The initialisers fill tensors on the
generator's device. Decode writes the new token's key and value into the
caller's cache in place. The feed-forward is SwiGLU, GELU (whisper) or MoE
(``repro_torch.models.moe``). Cross-attention reads the encoder's keys and
values with every slot valid, as a plain ``decode_attention``.

The encoder's self-attention runs on the flash kernel for a CUDA tensor
(bf16 at whisper-tiny's widths: 1500 frames, 6 heads of 64, not causal)
and on the naive attention for a CPU tensor, which is what the JAX
function pins (``impl="naive"``): a deliberate difference of route, the
same function.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _dense(gen, cfg, d_in, d_out, batch_dims, scale=1.0):
    out = torch.empty((*batch_dims, d_in, d_out), dtype=model_dtype(cfg),
                      device=gen.device)
    return L.dense_init_(out, gen, scale=scale)


# ---------------------------------------------------------------------------
# attention mixer
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg: ModelConfig, batch_dims=()):
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    return {
        "wq": _dense(gen, cfg, D, H * hd, batch_dims),
        "wk": _dense(gen, cfg, D, KV * hd, batch_dims),
        "wv": _dense(gen, cfg, D, KV * hd, batch_dims),
        "wo": _dense(gen, cfg, H * hd, D, batch_dims,
                     scale=1.0 / max(cfg.num_layers, 1) ** 0.5),
    }


def _qkv(params, x, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, KV, hd)
    v = (x @ params["wv"]).reshape(B, S, KV, hd)
    return q, k, v


def attn_apply(params, x, cfg: ModelConfig, *, positions, causal=True,
               window=0, impl="auto"):
    """Full-sequence attention (train / prefill). x: (B, S, D). Returns
    (y, (k, v)) with k and v after rope, for the cache."""
    q, k, v = _qkv(params, x, cfg)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    out = L.attention(q, k, v, causal=causal, window=window,
                      softcap=cfg.logit_softcap, impl=impl)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ params["wo"], (k, v)


def attn_decode(params, x1, kc, vc, kv_pos, t: int, cfg: ModelConfig, *,
                window=0):
    """One-token decode against a (ring-buffer) cache.

    x1: (B,1,D); kc/vc: (B,C,KV,hd), written in place: the new token's key
    and value go to slot t % C; kv_pos: (B,C) absolute positions (-1
    empty), which must already hold t at that slot (``LM.decode_step``
    writes it once for every layer); t: absolute position of the new
    token. Returns (y1, kc, vc).
    """
    B = x1.shape[0]
    C = kc.shape[1]
    q, k, v = _qkv(params, x1, cfg)
    tpos = torch.full((B,), t, dtype=torch.int32, device=x1.device)
    q = L.apply_rope(q, tpos[:, None], cfg.rope_theta)
    k = L.apply_rope(k, tpos[:, None], cfg.rope_theta)
    slot = t % C
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    out = L.decode_attention(q, kc, vc, kv_pos, window=window,
                             softcap=cfg.logit_softcap, q_position=tpos)
    return out.reshape(B, 1, -1) @ params["wo"], kc, vc


def cross_attn_apply(params, x, ck, cv, cfg: ModelConfig):
    """Cross-attention to precomputed encoder K/V. x: (B, S, D); ck/cv:
    (B, F, KV, hd), every slot valid."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim_
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    kv_pos = torch.zeros((B, ck.shape[1]), dtype=torch.int32,
                         device=x.device)
    out = L.decode_attention(q, ck, cv, kv_pos, q_position=None)
    return out.reshape(B, S, -1) @ params["wo"]


def cross_kv(params, enc_out, cfg: ModelConfig):
    """The encoder output's keys and values for one cross-attention layer:
    enc_out (B, F, D) -> (k, v), each (B, F, KV, hd)."""
    B, F, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim_
    k = (enc_out @ params["wk"]).reshape(B, F, KV, hd)
    v = (enc_out @ params["wv"]).reshape(B, F, KV, hd)
    return k, v


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------


def ffn_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
             batch_dims=()):
    """SwiGLU: wi, wg (D, F), wo (F, D). GELU: wi (D, F), wo (F, D). MoE:
    the router wr (D, E) and the experts' wi, wg (E, D, F) and wo (E, F,
    D), stacked after ``batch_dims`` as in JAX."""
    D, F = cfg.d_model, cfg.d_ff
    if kind == "moe":
        E = cfg.num_experts
        return {"wr": _dense(gen, cfg, D, E, batch_dims),
                "wi": _dense(gen, cfg, D, F, (*batch_dims, E)),
                "wg": _dense(gen, cfg, D, F, (*batch_dims, E)),
                "wo": _dense(gen, cfg, F, D, (*batch_dims, E))}
    if kind == "gelu":
        return {"wi": _dense(gen, cfg, D, F, batch_dims),
                "wo": _dense(gen, cfg, F, D, batch_dims)}
    return {"wi": _dense(gen, cfg, D, F, batch_dims),
            "wg": _dense(gen, cfg, D, F, batch_dims),
            "wo": _dense(gen, cfg, F, D, batch_dims)}


def ffn_apply(params, x, cfg: ModelConfig, kind: str):
    """The feed-forward block. Returns (y, aux loss), as in JAX: MoE's
    router loss, 0.0 for SwiGLU and GELU."""
    if kind == "moe":
        return moe_mod.moe_apply(x, params, cfg=cfg)
    if kind == "gelu":
        return L.gelu_ffn(x, params["wi"], params["wo"]), 0.0
    return L.swiglu(x, params["wi"], params["wg"], params["wo"]), 0.0


# ---------------------------------------------------------------------------
# whisper-style bidirectional encoder
# ---------------------------------------------------------------------------


def encoder_init(gen: torch.Generator, cfg: ModelConfig):
    EL, D, dev = cfg.enc_layers, cfg.d_model, gen.device
    return {"ln1": torch.zeros((EL, D), device=dev),
            "attn": attn_init(gen, cfg, batch_dims=(EL,)),
            "ln2": torch.zeros((EL, D), device=dev),
            "ffn": ffn_init(gen, cfg, "gelu", batch_dims=(EL,)),
            "ln_out": torch.zeros((D,), device=dev)}


def encoder_apply(params, frames, cfg: ModelConfig):
    """frames: (B, F, D) precomputed frame embeddings (the stub front-end)
    -> (B, F, D): sinusoid positions added, ``enc_layers`` layers of RMS
    norm, non-causal attention and GELU, then ``ln_out``."""
    _, F, D = frames.shape
    h = frames + L.sinusoid_positions(F, D, device=frames.device)[None].to(
        frames.dtype)
    positions = torch.arange(F, device=frames.device)
    impl = "naive" if frames.device.type == "cpu" else "flash"
    layers = {k: params[k] for k in ("ln1", "attn", "ln2", "ffn")}
    for lp in unstack(layers, cfg.enc_layers):
        a, _ = attn_apply(lp["attn"], L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                          cfg, positions=positions, causal=False, impl=impl)
        h = h + a
        f, _ = ffn_apply(lp["ffn"], L.rms_norm(h, lp["ln2"], cfg.norm_eps),
                         cfg, "gelu")
        h = h + f
    return L.rms_norm(h, params["ln_out"], cfg.norm_eps)


def unstack(tree, n: int) -> list:
    """The ``n`` views of every tensor of ``tree`` along its stacked dim
    0, one dict a slice. The tensors are split once (``unbind``), so that
    under autograd the slices' gradients are stacked once; indexing slice
    by slice would give each a zero-filled gradient of the whole stacked
    tensor to add up (``select``'s backward)."""
    if isinstance(tree, dict):
        per = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))
