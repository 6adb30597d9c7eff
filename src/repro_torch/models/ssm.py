"""Attention-free mixers; the port of ``repro/models/ssm.py``'s RWKV6
"Finch" half (data-dependent decay WKV).

As in JAX: ``rwkv6_init(gen, cfg, batch_dims)`` makes the parameters,
``rwkv6_apply_state(params, x, cfg)`` runs a whole sequence and returns
the state for decode, ``rwkv6_decode(params, x1, state, cfg)`` takes one
token, and ``rwkv6_init_state`` makes an empty state. The prefill's WKV
recurrence goes through ``repro_torch.kernels.ops.rwkv_wkv``: the
hand-written CUDA kernel for a CUDA tensor, its plain version for a CPU
tensor. Decode is one step of plain tensor ops, as in JAX.

Mamba (jamba's recurrent layer) is not ported yet: ``LM`` refuses it,
naming ROADMAP.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.transformer import _dense, model_dtype

_RWKV_LORA = 64


def _heads(cfg: ModelConfig):
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def rwkv6_init(gen: torch.Generator, cfg: ModelConfig, batch_dims=()):
    """Random parameters on ``gen``'s device with the JAX distributions:
    token-shift lerps ``mu`` U(0, 1) in ``cfg.dtype``; the projections
    truncated-normal fan-in in ``cfg.dtype``; the decay's base ``dec_0``
    -2, the per-head bonus ``u`` N(0, 0.1^2) and the group-norm scale
    ``ln_x`` 0, all three in fp32."""
    D = cfg.d_model
    Hn, hd = _heads(cfg)
    dev = gen.device
    mu = torch.rand((*batch_dims, 5, D), generator=gen, device=dev)
    params = {"mu": mu.to(model_dtype(cfg))}
    for name in ("w_r", "w_k", "w_v", "w_g"):
        params[name] = _dense(gen, cfg, D, D, batch_dims)
    params["dec_a"] = _dense(gen, cfg, D, _RWKV_LORA, batch_dims)
    params["dec_b"] = _dense(gen, cfg, _RWKV_LORA, D, batch_dims)
    params["dec_0"] = torch.full((*batch_dims, D), -2.0, device=dev)
    params["u"] = torch.randn((*batch_dims, Hn, hd), generator=gen,
                              device=dev) * 0.1
    params["ln_x"] = torch.zeros((*batch_dims, D), device=dev)
    params["w_o"] = _dense(gen, cfg, D, D, batch_dims)
    return params


def _rwkv_projections(params, x, x_prev, cfg: ModelConfig):
    """x, x_prev: (B, S, D). Returns r, k, v, g (B, S, Hn, hd) in x's
    dtype and the decays w (B, S, Hn, hd) in fp32, in (0, 1)."""
    B, S, D = x.shape
    Hn, hd = _heads(cfg)
    mu = params["mu"].to(x.dtype)                            # (5, D)
    xs = x[None] + mu[:, None, None, :] * (x_prev - x)[None]  # (5, B, S, D)
    xr, xk, xv, xg, xw = xs
    r = (xr @ params["w_r"]).reshape(B, S, Hn, hd)
    k = (xk @ params["w_k"]).reshape(B, S, Hn, hd)
    v = (xv @ params["w_v"]).reshape(B, S, Hn, hd)
    g = F.silu(xg @ params["w_g"]).reshape(B, S, Hn, hd)
    dec = (params["dec_0"].float()
           + (torch.tanh(xw @ params["dec_a"]) @ params["dec_b"]).float())
    w = torch.exp(-torch.exp(dec)).reshape(B, S, Hn, hd)
    return r, k, v, g, w


def _rwkv_group_norm(y, scale, eps: float = 1e-5):
    """Per-head rms norm. y: (B, S, Hn, hd) fp32; scale: (D,)."""
    B, S, Hn, hd = y.shape
    var = y.square().mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + eps)
    return y.reshape(B, S, Hn * hd) * (1.0 + scale.float())


def _mix_out(params, y, g, x):
    B, S, D = x.shape
    y = _rwkv_group_norm(y, params["ln_x"])
    return (y.to(x.dtype) * g.reshape(B, S, D)) @ params["w_o"]


def rwkv6_apply_state(params, x, cfg: ModelConfig):
    """x: (B, S, D) -> (y (B, S, D), state {"S": (B, Hn, hd, hd) fp32,
    "x_prev": x[:, -1]}). The WKV recurrence runs on
    ``ops.rwkv_wkv``."""
    S = x.shape[1]
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :S]
    r, k, v, g, w = _rwkv_projections(params, x, x_prev, cfg)
    y, S_fin = ops.rwkv_wkv(r, k, v, w, params["u"])
    return _mix_out(params, y, g, x), {"S": S_fin, "x_prev": x[:, -1]}


def rwkv6_apply(params, x, cfg: ModelConfig):
    return rwkv6_apply_state(params, x, cfg)[0]


def rwkv6_init_state(cfg: ModelConfig, B: int, dtype, device=None):
    Hn, hd = _heads(cfg)
    return {"S": torch.zeros((B, Hn, hd, hd), device=device),
            "x_prev": torch.zeros((B, cfg.d_model), dtype=dtype,
                                  device=device)}


def rwkv6_decode(params, x1, state, cfg: ModelConfig):
    """One token. x1: (B, 1, D); state {"S", "x_prev"} -> (y1 (B, 1, D),
    the new state). Plain tensor ops, as in JAX."""
    r, k, v, g, w = _rwkv_projections(params, x1,
                                      state["x_prev"][:, None, :], cfg)
    r_t, k_t, v_t, w_t = r[:, 0], k[:, 0], v[:, 0], w[:, 0]
    kv = torch.einsum("bhi,bhj->bhij", k_t.float(), v_t.float())
    y = torch.einsum("bhi,bhij->bhj", r_t.float(),
                     state["S"] + params["u"][None, :, :, None] * kv)
    S_new = state["S"] * w_t.float()[..., None] + kv
    return _mix_out(params, y[:, None], g, x1), {"S": S_new,
                                                 "x_prev": x1[:, 0]}
