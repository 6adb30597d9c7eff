"""The language model of the llama family (attention + SwiGLU layers), of
rwkv6 (RWKV6 + SwiGLU layers) and of jamba (8-layer groups of Mamba and
attention mixers, MoE and SwiGLU feed-forwards); the port of
``repro/models/model.py``'s ``LM`` for those specs.

Parameters keep the JAX package's pytree as nested dicts, with each layer
parameter stacked over the ``G`` scan groups, so that a JAX checkpoint
converts leaf by leaf (``repro_torch.convert.lm_params_from_numpy``). A
Python loop over the groups takes the place of ``lax.scan`` and takes
group ``g``'s view of each stacked tensor (a view, not a copy).

The decode cache is a dict as in JAX, with an entry per mixer position:
an attention layer's ``groups/pos{p}/k|v`` of shape (G, B, C, KV, hd), an
RWKV6 layer's ``groups/pos{p}/S`` (G, B, Hn, hd, hd) fp32 and ``x_prev``
(G, B, D), a Mamba layer's ``groups/pos{p}/h`` (G, B, di, ds) fp32 and
``conv_buf`` (G, B, w - 1, di); ``pos`` (B, C) the absolute position held
by each ring slot (-1 empty), present only when some layer attends; and
``t`` the next token's position, a Python int. Decode writes slot
``t % C`` and the recurrent states in place and returns the same dict.

A MoE feed-forward's parameters sit under ``groups/pos{p}/moe``, a dense
one's under ``ffn``, as in JAX. ``hidden`` returns the MoE routers' aux
loss summed over the layers, as the JAX function does; the trainer's
loss reads it. Cross-attention and the vision and audio
front-ends raise ``NotImplementedError`` naming the ROADMAP item that
holds them, and ``build_model`` builds only the archs whose parity with
the JAX package the port's tests hold (``PORTED_ARCHS``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T

PORTED_ARCHS = ("yi-6b", "rwkv6-7b", "jamba-1.5-large-398b")
MIXERS = ("attn", "rwkv6", "mamba")
_NOT_PORTED = "is not ported yet (ROADMAP Q1 item 7)"
# each recurrent mixer's (prefill, decode) step
_RECURRENT = {"rwkv6": (ssm.rwkv6_apply_state, ssm.rwkv6_decode),
              "mamba": (ssm.mamba_apply_state, ssm.mamba_decode)}


def _ffn_key(kind: str) -> str:
    """Where a position's feed-forward sits in the group's parameters."""
    return "moe" if kind == "moe" else "ffn"


def _groups(tree, G: int) -> list:
    """Each of the ``G`` groups' views of every stacked tensor of
    ``tree``. The tensors are split once (``unbind``), so that under
    autograd the groups' gradients are stacked once; indexing group by
    group would give each group a zero-filled gradient of the whole
    stacked tensor to add up (``select``'s backward)."""
    if isinstance(tree, dict):
        per = {k: _groups(v, G) for k, v in tree.items()}
        return [{k: per[k][g] for k in per} for g in range(G)]
    return list(tree.unbind(0))


class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.spec = self._group_spec()

    # ------------------------------------------------------------------
    def _group_spec(self) -> List[Tuple[str, str]]:
        cfg = self.cfg
        if cfg.frontend != "none":
            raise NotImplementedError(
                f"the {cfg.frontend} front-end {_NOT_PORTED}")
        if cfg.cross_attention:
            raise NotImplementedError(f"cross-attention {_NOT_PORTED}")
        pat = cfg.layer_pattern()
        gs = cfg.group_size()
        mixers = [pat[i % len(pat)] for i in range(gs)]
        spec = []
        for p in range(gs):
            if mixers[p] not in MIXERS:
                raise NotImplementedError(
                    f"the {mixers[p]} mixer {_NOT_PORTED}")
            moe = cfg.is_moe and p % cfg.moe_every == cfg.moe_every - 1
            spec.append((mixers[p], "moe" if moe else "swiglu"))
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
        init = {"attn": T.attn_init, "rwkv6": ssm.rwkv6_init,
                "mamba": ssm.mamba_init}
        for p, (mixer, ffnk) in enumerate(self.spec):
            groups[f"pos{p}"] = {
                "ln1": torch.zeros((G, D), device=dev),
                "ln2": torch.zeros((G, D), device=dev),
                mixer: init[mixer](gen, cfg, batch_dims=(G,)),
                _ffn_key(ffnk): T.ffn_init(gen, cfg, ffnk, batch_dims=(G,))}
        params["groups"] = groups
        return params

    def out_embed(self, params):
        return params.get("out_embed", params["embed"]["tok"])

    # ------------------------------------------------------------------
    # train / prefill forward
    # ------------------------------------------------------------------
    def hidden(self, params, tokens, *, impl="auto", collect_cache=False):
        """tokens: (B, S) integer ids. Returns (h (B, S, D) after the final
        norm, aux, cache_ys). aux is the feed-forwards' aux loss, a () fp32
        tensor: each group's layers summed in order, then the groups (the
        JAX function's order; 0 without MoE). With ``collect_cache``,
        cache_ys holds each
        position's cache entries stacked over the groups, an attention
        layer's keys and values ``{"k", "v": (G, B, S, KV, hd)}``, an
        RWKV6 layer's final state ``{"S": (G, B, Hn, hd, hd), "x_prev":
        (G, B, D)}`` and a Mamba layer's ``{"h": (G, B, di, ds),
        "conv_buf": (G, B, w - 1, di)}``, under ``"pos{p}"``; else None.
        Autograd follows the whole forward: on the CPU through the
        kernels' plain versions, on the card through the flash, WKV and
        scan kernels' ``autograd.Function``s, whose backwards are kernels
        (``repro_torch.kernels.ops``)."""
        cfg = self.cfg
        h = params["embed"]["tok"][tokens.long()]
        positions = torch.arange(h.shape[1], device=h.device)
        ys: Dict[str, Dict[str, list]] = {}
        auxs = []
        for gp in _groups(params["groups"], self.num_groups):
            aux = torch.zeros((), device=h.device)
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
                if collect_cache:
                    for n, x in ent.items():
                        ys.setdefault(f"pos{p}", {}).setdefault(
                            n, []).append(x)
                h = h + a
                hn2 = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
                f, al = T.ffn_apply(lp[_ffn_key(ffnk)], hn2, cfg, ffnk)
                h = h + f
                aux = aux + al
            auxs.append(aux)
        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        aux = torch.stack(auxs).sum()
        if not collect_cache:
            return h, aux, None
        return h, aux, {pk: {n: torch.stack(xs) for n, xs in ent.items()}
                        for pk, ent in ys.items()}

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def cache_shapes(self, B: int, C: int) -> Dict:
        """(shape, dtype) of every cache leaf but ``t``. C = cache length
        for attention layers; ``pos`` only when some layer attends."""
        cfg = self.cfg
        G = self.num_groups
        KV, hd = cfg.num_kv_heads, cfg.head_dim_
        Hn, rhd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        di, ds = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim
        kv = ((G, B, C, KV, hd), self.dtype)
        groups = {}
        for p, (mixer, _) in enumerate(self.spec):
            if mixer == "attn":
                groups[f"pos{p}"] = {"k": kv, "v": kv}
            elif mixer == "mamba":
                groups[f"pos{p}"] = {
                    "h": ((G, B, di, ds), torch.float32),
                    "conv_buf": ((G, B, cfg.ssm_conv_width - 1, di),
                                 self.dtype)}
            else:
                groups[f"pos{p}"] = {
                    "S": ((G, B, Hn, rhd, rhd), torch.float32),
                    "x_prev": ((G, B, cfg.d_model), self.dtype)}
        shapes = {"groups": groups}
        if any(mixer == "attn" for mixer, _ in self.spec):
            shapes["pos"] = ((B, C), torch.int32)
        return shapes

    def init_cache(self, B: int, C: int, *, device) -> Dict:
        shapes = self.cache_shapes(B, C)
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
        ``pos``, every RWKV6 and Mamba layer's state, then t + 1."""
        cfg = self.cfg
        t = cache["t"]
        h = params["embed"]["tok"][token.long()]             # (B, 1, D)
        kv_pos = cache.get("pos")
        if kv_pos is not None:
            C = kv_pos.shape[1]
            kv_pos[:, t % C] = t
            window = self._serve_window(C)
        for g, gp in enumerate(_groups(params["groups"], self.num_groups)):
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
    def prefill(self, params, tokens, *, cache_len: Optional[int] = None):
        """Run the full prompt, return (cache, last_hidden)."""
        B, S = tokens.shape
        h, _, cache_ys = self.hidden(params, tokens, impl="auto",
                                     collect_cache=True)
        C = cache_len or S + 64
        cache = self.init_cache(B, C, device=h.device)
        for pk, ent in cache_ys.items():
            tgt = cache["groups"][pk]
            if "k" in ent:
                tgt["k"][:, :, :S] = ent["k"]
                tgt["v"][:, :, :S] = ent["v"]
            else:                  # a recurrent state: RWKV6's or Mamba's
                for n, x in ent.items():
                    tgt[n].copy_(x)
        if "pos" in cache:
            pos = torch.arange(C, dtype=torch.int32, device=h.device)
            cache["pos"][:] = torch.where(pos < S, pos, -1)
        cache["t"] = S
        return cache, h


def build_model(cfg: ModelConfig) -> LM:
    if cfg.name not in PORTED_ARCHS:
        raise NotImplementedError(
            f"{cfg.name} {_NOT_PORTED}: the port builds {PORTED_ARCHS}")
    return LM(cfg)
