"""Attention-free mixers; the port of ``repro/models/ssm.py``: Mamba
(selective SSM, jamba's recurrent layer) and RWKV6 "Finch" (data-dependent
decay WKV).

As in JAX, each mixer has ``<name>_init(gen, cfg, batch_dims)`` for the
parameters, ``<name>_apply_state(params, x, cfg)`` that runs a whole
sequence and returns the state for decode, ``<name>_decode(params, x1,
state, cfg)`` that takes one token, and ``<name>_init_state`` for an empty
state. The prefill's time recurrence goes through a kernel wrapper,
``repro_torch.kernels.ops.mamba_scan`` or ``ops.rwkv_wkv``: the
hand-written CUDA kernel for a CUDA tensor, its plain version for a CPU
tensor. (The JAX model path runs a checkpointed ``lax.scan`` there and
never reaches its Pallas kernels.) Decode is one step of plain tensor
ops, as in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.env import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.transformer import _dense, model_dtype

# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------


def _mamba_dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return di, dt_rank, cfg.ssm_state_dim


def mamba_init(gen: torch.Generator, cfg: ModelConfig, batch_dims=()):
    """Random parameters on ``gen``'s device with the JAX distributions:
    the projections and the depthwise conv (w, di) truncated-normal fan-in
    in ``cfg.dtype``, ``conv_b`` 0 and ``dt_bias`` -4.6 (softplus^-1 of
    0.01) in ``cfg.dtype``, ``a_log`` = log(1 .. ds) on every channel (S4D
    real) and ``d_skip`` 1, both fp32."""
    di, dtr, ds = _mamba_dims(cfg)
    D, dev, dt = cfg.d_model, gen.device, model_dtype(cfg)
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev).log()
    return {
        "w_in": _dense(gen, cfg, D, 2 * di, batch_dims),
        "conv": _dense(gen, cfg, cfg.ssm_conv_width, di, batch_dims),
        "conv_b": torch.zeros((*batch_dims, di), dtype=dt, device=dev),
        "w_xdb": _dense(gen, cfg, di, dtr + 2 * ds, batch_dims),
        "w_dt": _dense(gen, cfg, dtr, di, batch_dims),
        "dt_bias": torch.full((*batch_dims, di), -4.6, dtype=dt,
                              device=dev),
        "a_log": a.expand(*batch_dims, di, ds).contiguous(),
        "d_skip": torch.ones((*batch_dims, di), device=dev),
        "w_out": _dense(gen, cfg, di, D, batch_dims),
    }


def _causal_conv(x, conv_w, conv_b):
    """x: (B, S, di); conv_w: (w, di) depthwise causal conv."""
    w, S = conv_w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(w):
        shift = w - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xi * conv_w[i][None, None, :]
    return out + conv_b[None, None, :]


def _mamba_core(params, xin, cfg: ModelConfig):
    """The per-step tensors of the scan from xin (B, S, di), post-conv:
    delta (B, S, di) fp32, B and C (B, S, ds) fp32 (contiguous, as the
    kernel takes them), A (di, ds) fp32."""
    _, dtr, ds = _mamba_dims(cfg)
    xdb = xin @ params["w_xdb"]
    dt_in, Bm, Cm = torch.split(xdb, [dtr, ds, ds], dim=-1)
    delta = F.softplus((dt_in @ params["w_dt"]).float()
                       + params["dt_bias"].float())
    A = -torch.exp(params["a_log"])
    return (delta, Bm.float().contiguous(), Cm.float().contiguous(), A)


def mamba_apply_state(params, x, cfg: ModelConfig):
    """x: (B, S, D) -> (y (B, S, D), state {"h": (B, di, ds) fp32,
    "conv_buf": the last w - 1 conv inputs (B, w - 1, di), zeros before
    the first when S < w - 1}). The time scan runs on
    ``ops.mamba_scan``."""
    S = x.shape[1]
    di = _mamba_dims(cfg)[0]
    xin_raw, z = torch.split(x @ params["w_in"], di, dim=-1)
    xin = F.silu(_causal_conv(xin_raw, params["conv"], params["conv_b"]))
    delta, Bm, Cm, A = _mamba_core(params, xin, cfg)
    ys, h_fin = ops.mamba_scan(delta, Bm, Cm, xin, A)
    y = ys + params["d_skip"][None, None] * xin.float()
    y = (y.to(x.dtype) * F.silu(z)) @ params["w_out"]
    # the last w - 1 rows of xin_raw padded in front by w - 1 zeros, a copy
    # (the JAX rule, repro/models/ssm.py:140-143, without the full pad)
    tail = xin_raw[:, max(S - (cfg.ssm_conv_width - 1), 0):]
    buf = F.pad(tail, (0, 0, cfg.ssm_conv_width - 1 - tail.shape[1], 0))
    return y, {"h": h_fin, "conv_buf": buf}


def mamba_apply(params, x, cfg: ModelConfig):
    return mamba_apply_state(params, x, cfg)[0]


def mamba_init_state(cfg: ModelConfig, B: int, dtype, device="cuda"):
    di, _, ds = _mamba_dims(cfg)
    device = resolve_device(device)
    return {"h": torch.zeros((B, di, ds), device=device),
            "conv_buf": torch.zeros((B, cfg.ssm_conv_width - 1, di),
                                    dtype=dtype, device=device)}


def mamba_decode(params, x1, state, cfg: ModelConfig):
    """One token. x1: (B, 1, D); state {"h", "conv_buf"} -> (y1 (B, 1, D),
    the new state). Plain tensor ops, as in JAX."""
    di = _mamba_dims(cfg)[0]
    xin, z = torch.split(x1[:, 0] @ params["w_in"], di, dim=-1)
    seq = torch.cat([state["conv_buf"], xin[:, None, :]], dim=1)  # (B,w,di)
    conv = torch.einsum("bwd,wd->bd", seq, params["conv"]) + params["conv_b"]
    xin_c = F.silu(conv)
    delta, Bm, Cm, A = _mamba_core(params, xin_c[:, None, :], cfg)
    d_t, b_t, c_t = delta[:, 0], Bm[:, 0], Cm[:, 0]
    a_t = torch.exp(d_t[..., None] * A[None])
    h = (a_t * state["h"]
         + (d_t * xin_c.float())[..., None] * b_t[:, None, :])
    y = (torch.einsum("bds,bs->bd", h, c_t)
         + params["d_skip"] * xin_c.float())
    y = (y.to(x1.dtype) * F.silu(z)) @ params["w_out"]
    return y[:, None, :], {"h": h, "conv_buf": seq[:, 1:]}


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------

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


def rwkv6_init_state(cfg: ModelConfig, B: int, dtype, device="cuda"):
    Hn, hd = _heads(cfg)
    device = resolve_device(device)
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
