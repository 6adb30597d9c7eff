"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2. Mamba+attention 1:7 interleave (attention at
position 3 of every 8-layer block), MoE FFN every other layer.
[arXiv:2403.19887]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_every=2,                 # MoE FFN on odd layers, dense FFN on even
    ssm_type="mamba",
    attn_every=8,                # 1 attention layer per 8 (1:7 attn:mamba)
    attn_offset=3,
    ssm_state_dim=16,
    ssm_expand=2,
    source="arXiv:2403.19887",
)
