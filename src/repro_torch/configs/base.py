"""Config system: architecture configs, input shapes, CARLS settings.

A copy of ``repro/configs/base.py`` (dataclasses only, no JAX), kept in the
port so that it imports nothing of the JAX package.

Every assigned architecture gets one ``<id>.py`` module in this package that
exports ``CONFIG`` built from :class:`ModelConfig`. ``registry.py`` maps
``--arch <id>`` to these. A ``reduced()`` transform produces the CPU smoke
variant (2 layers, d_model<=512, <=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CarlsConfig:
    """Knowledge-bank / CARLS settings attached to every run."""
    kb_entries: int = 1 << 16          # rows in the knowledge bank
    kb_dim: int = 0                    # 0 => d_model
    num_neighbors: int = 8             # K neighbors fetched per example
    reg_weight: float = 0.1            # graph regularizer weight (alpha)
    lazy_update: bool = True           # paper §3.2 lazy gradient update
    lazy_lr: float = 0.1               # lr applied to cached KB gradients
    outlier_zmax: float = 3.0          # reject cached grads > z sigma of norm
    maker_refresh_steps: int = 20      # async runtime: maker ckpt reload period
    nn_k: int = 8                      # top-k for nearest-neighbor lookup


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 => d_model // num_heads
    source: str = ""                   # citation from the assignment table

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1                 # apply MoE FFN every k-th layer (jamba: 2)

    # --- SSM / hybrid ---
    ssm_type: str = "none"             # none | rwkv6 | mamba
    attn_every: int = 0                # hybrid: attention at layer i%attn_every==attn_offset
    attn_offset: int = 3               # jamba puts attn at position 3 of each 8-block
    ssm_state_dim: int = 16            # mamba d_state
    ssm_expand: int = 2                # mamba d_inner = expand * d_model
    ssm_conv_width: int = 4
    rwkv_head_dim: int = 64

    # --- modality frontend (STUB per assignment carve-out) ---
    frontend: str = "none"             # none | vision | audio
    num_frontend_tokens: int = 0       # patches (vlm) / frames (audio)
    cross_attention: bool = False      # whisper-style enc-dec
    enc_layers: int = 0

    # --- attention ---
    rope_theta: float = 1e6
    window: int = 0                    # training/prefill sliding window (0=full)
    serve_long_window: int = 8192      # window used by the long_500k serve variant
    logit_softcap: float = 0.0         # grok-style tanh soft-capping

    # --- numerics / training ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    remat: bool = True
    remat_policy: str = "nothing"      # nothing | dots (save matmul outputs)
    scan_layers: bool = True
    tie_embeddings: bool = False

    carls: CarlsConfig = field(default_factory=CarlsConfig)

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def dec_layers(self) -> int:
        return self.num_layers

    def layer_pattern(self) -> Tuple[str, ...]:
        """Mixer type per layer position inside one scan group."""
        if self.ssm_type == "none" or self.attn_every == 0:
            if self.ssm_type != "none":
                return (self.ssm_type,) * self.group_size()
            return ("attn",) * self.group_size()
        pat = []
        for i in range(self.attn_every):
            pat.append("attn" if i == self.attn_offset else self.ssm_type)
        return tuple(pat)

    def group_size(self) -> int:
        """Layers per lax.scan step (heterogeneous archs scan over groups)."""
        if self.ssm_type != "none" and self.attn_every:
            g = self.attn_every
            if self.is_moe and self.moe_every > 1:
                g = _lcm(g, self.moe_every)
            return g
        if self.is_moe and self.moe_every > 1:
            return self.moe_every
        return 1

    def num_groups(self) -> int:
        g = self.group_size()
        assert self.num_layers % g == 0, (self.name, self.num_layers, g)
        return self.num_layers // g

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic total parameter count (embeddings included)."""
        D, H, KV, hd, F, V, L = (self.d_model, self.num_heads, self.num_kv_heads,
                                 self.head_dim_, self.d_ff, self.vocab_size,
                                 self.num_layers)
        total = V * D + (0 if self.tie_embeddings else V * D)  # in + out embed
        pat = self.layer_pattern()
        groups = self.num_groups()
        for gi in range(groups):
            for li, mixer in enumerate(pat):
                layer = gi * len(pat) + li
                if mixer == "attn":
                    total += D * (H + 2 * KV) * hd + H * hd * D
                elif mixer == "rwkv6":
                    a = self.d_model
                    total += 6 * D * a + a * D + 5 * D  # r,k,v,g,w,o (+decay params)
                elif mixer == "mamba":
                    di = self.ssm_expand * D
                    total += D * 2 * di + di * self.ssm_conv_width
                    total += di * (2 * self.ssm_state_dim + 1) + di * self.ssm_state_dim
                    total += di * D
                # FFN
                if self.is_moe and (layer % self.moe_every == self.moe_every - 1
                                    or self.moe_every == 1):
                    total += self.num_experts * 3 * D * F + D * self.num_experts
                else:
                    total += 3 * D * F
                total += 2 * D  # norms
        if self.cross_attention:  # whisper encoder + cross-attn stacks
            total += self.enc_layers * (4 * D * D + 3 * D * F + 2 * D)
            total += self.num_layers * (4 * D * D + D)  # cross-attn per dec layer
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        moe_layers = self.num_layers // self.moe_every
        expert_p = 3 * self.d_model * self.d_ff
        dead = moe_layers * (self.num_experts - self.experts_per_token) * expert_p
        return int(full - dead)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """CPU smoke variant of the same family: 2 layers, d<=512, <=4 experts."""
        g = self.group_size()
        layers = max(2, g)  # keep one full pattern group for hybrids
        changes = dict(
            num_layers=layers,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            num_frontend_tokens=min(self.num_frontend_tokens, 16),
            enc_layers=min(self.enc_layers, 2),
            dtype="float32",
            remat=False,
            carls=dataclasses.replace(self.carls, kb_entries=256, num_neighbors=4),
        )
        if self.num_kv_heads == 1:
            changes["num_kv_heads"] = 1
        if self.ssm_type == "rwkv6":
            changes["rwkv_head_dim"] = 32
        return dataclasses.replace(self, **changes)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _lcm(a: int, b: int) -> int:
    import math
    return a * b // math.gcd(a, b)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}
