"""whisper-small — encoder-decoder; conv frontend is a STUB per the
assignment (``input_specs`` supplies precomputed frame embeddings).
[arXiv:2212.04356; unverified]
12L d_model=768 12H (MHA kv=12) d_ff=3072 vocab=51865."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,           # decoder layers
    encoder_layers=12,
    is_encoder_decoder=True,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    rope_theta=10_000.0,     # backbone uses rope in this repro (see DESIGN)
)
