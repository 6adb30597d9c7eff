"""internvl2-2b [vlm] — 24L d2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
InternViT + InternLM2; vision frontend is a STUB per the assignment carve-out:
``input_specs`` provides precomputed patch embeddings. [arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    num_frontend_tokens=256,     # 16x16 patch grid from the (stubbed) InternViT
    source="arXiv:2404.16821",
)
