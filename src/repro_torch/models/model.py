"""The language model over all ten archs of the JAX package; the port of
``repro/models/model.py``'s ``LM``.

Layers are grouped into scan units (``cfg.group_size()``) whose
per-position pattern ``(mixer, ffn_kind)`` comes from the config: the
llama family (minitron, granite, command-r, yi) = 1-position groups of
(attn, swiglu); grok and kimi = (attn, moe); rwkv6 = (rwkv6, swiglu);
jamba = 8-position groups of Mamba and attention mixers, MoE and SwiGLU
feed-forwards; whisper = (attn, gelu) with a bidirectional encoder and a
cross-attention after each mixer; internvl takes its (stub) patch
embeddings as a prefix of the token sequence.

Parameters keep the JAX package's pytree as nested dicts, with each layer
parameter stacked over the ``G`` scan groups, so that a JAX checkpoint
converts leaf by leaf (``repro_torch.convert.lm_params_from_numpy``). A
Python loop over the groups takes the place of ``lax.scan`` and takes
group ``g``'s view of each stacked tensor (a view, not a copy).

The decode cache is a dict as in JAX, with an entry per mixer position:
an attention layer's ``groups/pos{p}/k|v`` of shape (G, B, C, KV, hd), an
RWKV6 layer's ``groups/pos{p}/S`` (G, B, Hn, hd, hd) fp32 and ``x_prev``
(G, B, D), a Mamba layer's ``groups/pos{p}/h`` (G, B, di, ds) fp32 and
``conv_buf`` (G, B, w - 1, di), and with cross-attention the encoder's
keys and values ``ck|cv`` (G, B, F, KV, hd) beside them; ``pos`` (B, C)
the absolute position held by each ring slot (-1 empty), present only
when some layer attends; and ``t`` the next token's position, a Python
int. Decode writes slot ``t % C`` and the recurrent states in place and
returns the same dict.

A MoE feed-forward's parameters sit under ``groups/pos{p}/moe``, a dense
one's under ``ffn``, as in JAX. ``hidden`` returns the prefix length and
the MoE routers' aux loss summed over the layers, as the JAX function
does; the trainer's loss reads the latter.

``cfg.remat`` checkpoints each scan group under grad (``hidden``'s
docstring says how), as JAX's ``jax.checkpoint`` of its scan body.

The front-ends' inputs come in ``extra``, as in JAX: ``patch_embs`` (B,
Pf, D) for vision, ``frames`` (B, F, D) for audio. Both are cast to the
model's dtype; JAX casts the patches alone and runs a bf16 model's
encoder on fp32 frames (the same values in fp32).
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T

PORTED_ARCHS = tuple(ARCH_IDS)
# each recurrent mixer's (prefill, decode) step
_RECURRENT = {"rwkv6": (ssm.rwkv6_apply_state, ssm.rwkv6_decode),
              "mamba": (ssm.mamba_apply_state, ssm.mamba_decode)}
_INIT = {"attn": T.attn_init, "rwkv6": ssm.rwkv6_init,
         "mamba": ssm.mamba_init}
# the products that JAX's dots_with_no_batch_dims_saveable keeps: the
# unbatched matrix products, which the (B, S, D) @ (D, F) projections
# reach as aten.mm
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


# cfg.remat_policy -> the checkpoint's context: "nothing" keeps the
# group's input alone, "dots" also the outputs of its unbatched products
_REMAT_CONTEXT = {
    "nothing": noop_context_fn,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              _save_dots)}


def _ffn_key(kind: str) -> str:
    """Where a position's feed-forward sits in the group's parameters."""
    return "moe" if kind == "moe" else "ffn"


class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.spec = self._group_spec()

    # ------------------------------------------------------------------
    def _group_spec(self) -> List[Tuple[str, str]]:
        cfg = self.cfg
        pat = cfg.layer_pattern()
        gs = cfg.group_size()
        # extend the mixer pattern to the (possibly lcm-extended) group
        mixers = [pat[i % len(pat)] for i in range(gs)]
        spec = []
        for p in range(gs):
            if cfg.is_moe and p % cfg.moe_every == cfg.moe_every - 1:
                ffn = "moe"
            elif cfg.arch_type == "audio":
                ffn = "gelu"
            else:
                ffn = "swiglu"
            spec.append((mixers[p], ffn))
        return spec

    @property
    def num_groups(self) -> int:
        return self.cfg.num_groups()

    @property
    def dtype(self) -> torch.dtype:
        return T.model_dtype(self.cfg)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Dict:
        """Random parameters on ``gen``'s device, with the JAX package's
        distributions: embeddings N(0, 0.02^2), weights truncated-normal
        fan-in, norm scales 0 (fp32)."""
        cfg = self.cfg
        G, D, dev = self.num_groups, cfg.d_model, gen.device

        def embed():
            out = torch.empty((cfg.vocab_size, D), dtype=self.dtype,
                              device=dev)
            return L.embed_init_(out, gen)

        params: Dict = {"embed": {"tok": embed()},
                        "final_norm": torch.zeros((D,), device=dev)}
        if not cfg.tie_embeddings:
            params["out_embed"] = embed()
        groups: Dict = {}
        for p, (mixer, ffnk) in enumerate(self.spec):
            gp = {"ln1": torch.zeros((G, D), device=dev),
                  "ln2": torch.zeros((G, D), device=dev),
                  mixer: _INIT[mixer](gen, cfg, batch_dims=(G,)),
                  _ffn_key(ffnk): T.ffn_init(gen, cfg, ffnk,
                                             batch_dims=(G,))}
            if cfg.cross_attention:
                gp["ln_ca"] = torch.zeros((G, D), device=dev)
                gp["cross"] = T.attn_init(gen, cfg, batch_dims=(G,))
            groups[f"pos{p}"] = gp
        params["groups"] = groups
        if cfg.cross_attention:
            params["enc"] = T.encoder_init(gen, cfg)
        return params

    def out_embed(self, params):
        return params.get("out_embed", params["embed"]["tok"])

    # ------------------------------------------------------------------
    # train / prefill forward
    # ------------------------------------------------------------------
    def hidden(self, params, tokens, extra=None, *, impl="auto",
               collect_cache=False):
        """tokens: (B, S) integer ids; ``extra`` the front-end's inputs
        (see the module docstring). Returns (h (B, S_tot, D) after the
        final norm, the prefix length Pf (S_tot = Pf + S), aux,
        cache_ys). aux is the feed-forwards' aux loss, a () fp32 tensor:
        each group's layers summed in order, then the groups (the JAX
        function's order; 0 without MoE). With ``collect_cache``,
        cache_ys holds each position's cache entries stacked over the
        groups, an attention layer's keys and values ``{"k", "v": (G, B,
        S_tot, KV, hd)}``, an RWKV6 layer's final state ``{"S": (G, B, Hn,
        hd, hd), "x_prev": (G, B, D)}`` and a Mamba layer's ``{"h": (G,
        B, di, ds), "conv_buf": (G, B, w - 1, di)}``, and with
        cross-attention the encoder's ``{"ck", "cv": (G, B, F, KV, hd)}``,
        under ``"pos{p}"``; else None. Autograd follows the whole
        forward: on the CPU through the kernels' plain versions, on the
        card through the flash, WKV and scan kernels'
        ``autograd.Function``s, whose backwards are kernels
        (``repro_torch.kernels.ops``).

        With ``cfg.remat`` and grad mode on, each scan group runs under
        ``torch.utils.checkpoint`` (non-reentrant), JAX's
        ``jax.checkpoint`` of the group body: policy ``nothing`` keeps
        only the group's input and recomputes its forward in the
        backward, ``dots`` also keeps the outputs of its unbatched matrix
        products. The recompute runs the sequence kernels' forwards again
        (their launches a step are twice the layers'); the encoder and
        the vision prefix stay outside, as in JAX. Without grad (serving,
        ``inference_mode``) nothing changes."""
        cfg = self.cfg
        h = params["embed"]["tok"][tokens.long()]
        prefix, enc_out = 0, None
        if cfg.frontend == "vision":
            patch = extra["patch_embs"].to(h.dtype)          # (B, Pf, D)
            prefix = patch.shape[1]
            h = torch.cat([patch, h], dim=1)
        elif cfg.frontend == "audio":
            enc_out = T.encoder_apply(params["enc"],
                                      extra["frames"].to(h.dtype), cfg)
        if cfg.rope_theta <= 0.0:  # sinusoidal absolute positions (whisper)
            h = h + L.sinusoid_positions(h.shape[1], cfg.d_model,
                                         device=h.device)[None].to(h.dtype)
        positions = torch.arange(h.shape[1], device=h.device)
        ys: Dict[str, Dict[str, list]] = {}
        auxs = []
        body = functools.partial(self._group, positions=positions,
                                 enc_out=enc_out, impl=impl)
        remat = cfg.remat and torch.is_grad_enabled()
        for gp in T.unstack(params["groups"], self.num_groups):
            if remat:
                h, aux, ents = checkpoint(
                    body, h, gp, use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=_REMAT_CONTEXT[cfg.remat_policy])
            else:
                h, aux, ents = body(h, gp)
            if collect_cache:
                for pk, ent in ents.items():
                    for n, x in ent.items():
                        ys.setdefault(pk, {}).setdefault(n, []).append(x)
            auxs.append(aux)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        aux = torch.stack(auxs).sum()
        if not collect_cache:
            return h, prefix, aux, None
        return h, prefix, aux, {
            pk: {n: torch.stack(xs) for n, xs in ent.items()}
            for pk, ent in ys.items()}

    def _group(self, h, gp, *, positions, enc_out, impl):
        """One scan group on the residual stream: (h, gp: the group's
        parameters) -> (h, aux: its feed-forwards' aux losses summed in
        order, {"pos{p}": the position's cache entries})."""
        cfg = self.cfg
        aux = torch.zeros((), device=h.device)
        ents = {}
        for p, (mixer, ffnk) in enumerate(self.spec):
            lp = gp[f"pos{p}"]
            hn = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
            if mixer == "attn":
                a, (k, v) = T.attn_apply(lp["attn"], hn, cfg,
                                         positions=positions,
                                         window=cfg.window, impl=impl)
                ent = {"k": k, "v": v}
            else:
                a, ent = _RECURRENT[mixer][0](lp[mixer], hn, cfg)
            h = h + a
            if cfg.cross_attention:
                ck, cv = T.cross_kv(lp["cross"], enc_out, cfg)
                hc = L.rms_norm(h, lp["ln_ca"], cfg.norm_eps)
                h = h + T.cross_attn_apply(lp["cross"], hc, ck, cv, cfg)
                ent = {**ent, "ck": ck, "cv": cv}
            ents[f"pos{p}"] = ent
            hn2 = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
            f, al = T.ffn_apply(lp[_ffn_key(ffnk)], hn2, cfg, ffnk)
            h = h + f
            aux = aux + al
        return h, aux, ents

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def cache_shapes(self, B: int, C: int, *, frames: int = 0) -> Dict:
        """(shape, dtype) of every cache leaf but ``t``. C = cache length
        for attention layers; ``pos`` only when some layer attends;
        ``frames`` the encoder's length (cross-attention)."""
        cfg = self.cfg
        G = self.num_groups
        KV, hd = cfg.num_kv_heads, cfg.head_dim_
        Hn, rhd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        di, ds = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim
        kv = ((G, B, C, KV, hd), self.dtype)
        groups = {}
        for p, (mixer, _) in enumerate(self.spec):
            if mixer == "attn":
                ent = {"k": kv, "v": kv}
            elif mixer == "mamba":
                ent = {"h": ((G, B, di, ds), torch.float32),
                       "conv_buf": ((G, B, cfg.ssm_conv_width - 1, di),
                                    self.dtype)}
            else:
                ent = {"S": ((G, B, Hn, rhd, rhd), torch.float32),
                       "x_prev": ((G, B, cfg.d_model), self.dtype)}
            if cfg.cross_attention:
                ent["ck"] = ent["cv"] = ((G, B, frames, KV, hd), self.dtype)
            groups[f"pos{p}"] = ent
        shapes = {"groups": groups}
        if any(mixer == "attn" for mixer, _ in self.spec):
            shapes["pos"] = ((B, C), torch.int32)
        return shapes

    def init_cache(self, B: int, C: int, *, frames: int = 0,
                   device) -> Dict:
        shapes = self.cache_shapes(B, C, frames=frames)
        cache = {"groups": {pk: {n: torch.zeros(s, dtype=dt, device=device)
                                 for n, (s, dt) in ent.items()}
                            for pk, ent in shapes["groups"].items()},
                 "t": 0}
        if "pos" in shapes:
            s, dt = shapes["pos"]
            cache["pos"] = torch.full(s, -1, dtype=dt, device=device)
        return cache

    def decode_step(self, params, cache, token):
        """token: (B, 1) ids. Returns (logits (B, 1, V), cache), the cache
        updated in place: slot t % C of every attention layer and of
        ``pos``, every RWKV6 and Mamba layer's state, then t + 1.
        Cross-attention reads the cached ``ck|cv``."""
        cfg = self.cfg
        t = cache["t"]
        h = params["embed"]["tok"][token.long()]             # (B, 1, D)
        if cfg.rope_theta <= 0.0:
            h = h + L.sinusoid_positions(1, cfg.d_model, offset=t,
                                         device=h.device)[None].to(h.dtype)
        kv_pos = cache.get("pos")
        if kv_pos is not None:
            C = kv_pos.shape[1]
            kv_pos[:, t % C] = t
            window = self._serve_window(C)
        for g, gp in enumerate(T.unstack(params["groups"], self.num_groups)):
            for p, (mixer, ffnk) in enumerate(self.spec):
                lp = gp[f"pos{p}"]
                cc = cache["groups"][f"pos{p}"]
                hn = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
                if mixer == "attn":
                    a, _, _ = T.attn_decode(lp["attn"], hn, cc["k"][g],
                                            cc["v"][g], kv_pos, t, cfg,
                                            window=window)
                else:
                    a, st = _RECURRENT[mixer][1](
                        lp[mixer], hn, {n: c[g] for n, c in cc.items()},
                        cfg)
                    for n, x in st.items():
                        cc[n][g] = x
                h = h + a
                if cfg.cross_attention:
                    hc = L.rms_norm(h, lp["ln_ca"], cfg.norm_eps)
                    h = h + T.cross_attn_apply(lp["cross"], hc, cc["ck"][g],
                                               cc["cv"][g], cfg)
                hn2 = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
                h = h + T.ffn_apply(lp[_ffn_key(ffnk)], hn2, cfg, ffnk)[0]
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = h @ self.out_embed(params).T
        cache["t"] = t + 1
        return logits, cache

    def _serve_window(self, cache_len: int) -> int:
        """Ring caches shorter than the context imply a sliding window
        equal to the cache length; full caches use the config's train
        window."""
        cfg = self.cfg
        if cache_len <= cfg.serve_long_window:
            return cache_len
        return cfg.window

    # ------------------------------------------------------------------
    def prefill(self, params, tokens, extra=None, *,
                cache_len: Optional[int] = None):
        """Run the full prompt (after the vision prefix, if any), return
        (cache, last_hidden (B, S_tot, D)). The cache holds ``cache_len``
        slots (default S_tot + 64), the first S_tot filled; ``t`` = S_tot."""
        B, S = tokens.shape
        h, prefix, _, cache_ys = self.hidden(params, tokens, extra,
                                             impl="auto", collect_cache=True)
        S_tot = S + prefix
        C = cache_len or S_tot + 64
        frames = (extra["frames"].shape[1] if self.cfg.frontend == "audio"
                  else 0)
        cache = self.init_cache(B, C, frames=frames, device=h.device)
        for pk, ent in cache_ys.items():
            tgt = cache["groups"][pk]
            for n, x in ent.items():
                if n in ("k", "v"):
                    tgt[n][:, :, :S_tot] = x
                else:          # a recurrent state, or the encoder's ck|cv
                    tgt[n].copy_(x)
        if "pos" in cache:
            pos = torch.arange(C, dtype=torch.int32, device=h.device)
            cache["pos"][:] = torch.where(pos < S_tot, pos, -1)
        cache["t"] = S_tot
        return cache, h


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
