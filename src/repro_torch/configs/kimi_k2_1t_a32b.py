"""kimi-k2-1t-a32b [moe] — 61L d7168 64H (GQA kv=8) d_ff=2048 (per expert)
vocab=163840, MoE 384 experts top-8. Trillion-param MoE (paper-table).
[arXiv:2501.kimi2]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,                # 7168 / 64 (not 128-aligned; see roofline notes)
    d_ff=2048,
    vocab_size=163840,
    num_experts=384,
    experts_per_token=8,
    source="arXiv:2501.kimi2",
)
