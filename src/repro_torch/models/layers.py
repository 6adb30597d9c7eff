"""Shared neural layers: initializers, RMS norm, rotary embeddings,
whisper's sinusoidal positions, GQA attention (naive, flash and
single-token decode), SwiGLU and the GELU feed-forward; the port of
``repro/models/layers.py``.

Plain functions on tensors in the JAX package's layouts: activations
(B, S, D), queries (B, S, H, hd), keys and values (B, S, KV, hd), weight
matrices (d_in, d_out). Random initialisers draw from an explicit
``torch.Generator`` and fill a tensor the caller allocated on its device.

``attention(impl="auto")`` dispatches as the JAX function does: naive for
short sequences, single-token steps and ring-buffer caches, flash
otherwise. Flash is ``repro_torch.kernels.ops.flash_attention``: the
hand-written CUDA kernel for a CUDA tensor, its plain PyTorch version for a
CPU tensor.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init_(out: torch.Tensor, gen: torch.Generator, *,
                scale: float = 1.0) -> torch.Tensor:
    """Fill ``out`` (..., d_in, d_out) in place with the JAX package's
    truncated-normal fan-in init: N(0, 1) cut at +-2, times
    ``scale / sqrt(d_in)``, drawn in fp32 one (d_in, d_out) slice at a time
    (so that a stacked bf16 weight needs no fp32 copy of itself) and then
    cast to ``out``'s dtype."""
    std = scale / math.sqrt(out.shape[-2])
    for sl in out.view(-1, *out.shape[-2:]):
        tmp = torch.empty(sl.shape, dtype=torch.float32, device=out.device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
        sl.copy_(tmp.mul_(std))
    return out


def embed_init_(out: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Fill ``out`` (vocab, d) in place with N(0, 0.02^2), drawn in fp32."""
    tmp = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    tmp.normal_(0.0, 1.0, generator=gen)
    return out.copy_(tmp.mul_(0.02))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """The (head_dim / 2,) fp32 frequencies, computed on the CPU (whose
    fp32 pow the tests hold against JAX's) and copied to ``device`` once.
    The card's pow rounds a few of them (at head dim 112) an ulp the
    other way, and an ulp of a frequency moves position p's angle by p
    ulps, ~1e-4 at p 2048. Made outside inference mode, so that a
    first call under ``torch.inference_mode`` (serving) leaves a tensor
    that autograd may use later (training)."""
    with torch.inference_mode(False):
        freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                              dtype=torch.float32)
                                 / head_dim))
        return freqs.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, N, hd); positions: (B, S) or (S,)."""
    if theta <= 0.0:  # arch without rope (whisper)
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)      # (hd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs          # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(seq: int, d: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    """Whisper-style sinusoidal absolute position encodings (S, D), fp32,
    for positions offset .. offset + seq - 1: the JAX function's formula,
    computed in fp64 and rounded once to fp32. In fp32 an ulp of a
    frequency moves the angle of position p by p ulps, ~1e-4 at p 2048,
    and the card's exp and sin round otherwise than the CPU's; in fp64
    both give the same fp32 table."""
    pos = torch.arange(seq, dtype=torch.float64, device=device) + offset
    half = d // 2
    inv = torch.exp(-torch.arange(half, dtype=torch.float64, device=device)
                    * (math.log(10000.0) / max(half - 1, 1)))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _soft_cap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0.0:
        return torch.tanh(scores / cap) * cap
    return scores


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, H, hd) by repeating groups."""
    kv = k.shape[-2]
    if kv == num_heads:
        return k
    return k.repeat_interleave(num_heads // kv, dim=-2)


def naive_attention(q, k, v, *, causal: bool, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    kv_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Reference attention. q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd).

    ``q_offset``: absolute position of q[0] (for decode: Skv-1).
    ``kv_positions``: (B, Skv) absolute positions for ring-buffer caches.
    """
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(hd)
    scores = _soft_cap(scores, softcap)
    qpos = torch.arange(Sq, device=q.device) + q_offset          # (Sq,)
    if kv_positions is None:
        kpos = torch.arange(Skv, device=q.device)[None, :]       # (1, Skv)
    else:
        kpos = kv_positions                                      # (B, Skv)
    mask = torch.ones((1, Sq, Skv) if kv_positions is None
                      else (B, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[None, :, None] >= kpos[:, None, :]
    if window and window > 0:
        mask &= qpos[None, :, None] - kpos[:, None, :] < window
    scores = torch.where(mask[:, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def _pick_chunk(S: int, target: int) -> int:
    """Largest divisor of S that is <= target, preferring powers of two
    (handles VLM prefix lengths like 33024 = 2^8 * 129)."""
    target = min(target, S)
    if S % target == 0:
        return target
    c = 1
    while c * 2 <= target and S % (c * 2) == 0:
        c *= 2
    best = c
    for d in range(target, 0, -1):       # any divisor beats a tiny pow2
        if S % d == 0:
            best = max(best, d)
            break
    return best


# ``attention(impl="auto")`` takes flash from this many (query, key) pairs
FLASH_MIN_PAIRS = 2048 * 2048


def attention(q, k, v, *, causal: bool, window: int = 0,
              softcap: float = 0.0, impl: str = "auto", q_offset: int = 0,
              kv_positions=None) -> torch.Tensor:
    """Dispatch. ``auto``: flash for long sequences, naive for
    short/decode."""
    Sq, Skv = q.shape[1], k.shape[1]
    if impl == "naive" or (impl == "auto" and (Sq * Skv < FLASH_MIN_PAIRS
                                               or Sq == 1
                                               or kv_positions is not None)):
        return naive_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset,
                               kv_positions=kv_positions)
    if q_offset != 0 or kv_positions is not None:
        raise ValueError("flash attention takes a whole sequence from "
                         "position 0 (no q_offset, no kv_positions)")
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def decode_attention(q, k_cache, v_cache, kv_positions, *, window: int = 0,
                     softcap: float = 0.0, q_position=None) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffer) cache.

    q: (B, 1, H, hd); caches: (B, C, KV, hd); kv_positions: (B, C) absolute
    positions of cache slots (-1 = empty). q_position: (B,) absolute
    position of the new token.
    """
    B, _, H, hd = q.shape
    k = _repeat_kv(k_cache, H)
    v = _repeat_kv(v_cache, H)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) / math.sqrt(hd)
    scores = _soft_cap(scores, softcap)
    valid = kv_positions >= 0
    if q_position is not None:
        valid &= kv_positions <= q_position[:, None]
        if window and window > 0:
            valid &= q_position[:, None] - kv_positions < window
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    """x: (..., D); wi/wg: (D, F); wo: (F, D)."""
    h = F.silu(x @ wg) * (x @ wi)
    return h @ wo


def gelu_ffn(x: torch.Tensor, wi: torch.Tensor,
             wo: torch.Tensor) -> torch.Tensor:
    """x: (..., D); wi: (D, F); wo: (F, D). ``jax.nn.gelu``'s default is
    the tanh approximation, so this is too (torch's default, the erf
    form, is another function)."""
    return F.gelu(x @ wi, approximate="tanh") @ wo
