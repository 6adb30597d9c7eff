"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536.
Finch: data-dependent decay WKV recurrence. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    arch_type="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                # 64 wkv heads of 64 dims
    num_kv_heads=64,
    head_dim=64,
    rwkv_head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    ssm_type="rwkv6",
    source="arXiv:2404.05892",
)
