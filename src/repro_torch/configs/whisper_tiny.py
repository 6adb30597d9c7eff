"""whisper-tiny [audio] — 4L d384 6H d_ff=1536 vocab=51865. Encoder-decoder
with conv/mel frontend STUBBED per the assignment carve-out: ``input_specs``
provides precomputed frame embeddings (1500 frames). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,                # decoder layers
    enc_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    frontend="audio",
    num_frontend_tokens=1500,    # 30 s of audio at 50 frames/s (post-conv)
    cross_attention=True,
    rope_theta=0.0,              # whisper uses learned/sinusoidal abs positions
    source="arXiv:2212.04356",
)
