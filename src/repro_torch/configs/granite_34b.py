"""granite-34b [dense] — 88L d6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
Llama-arch, code model. [arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    arch_type="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,              # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    source="arXiv:2405.04324",
)
