"""llama-3.2-vision-11b — decoder with cross-attention image layers.
The vision frontend is a STUB per the assignment: ``input_specs`` supplies
precomputed patch embeddings [B, 1601, d_model].
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_every=5,      # 8 cross-attention blocks over 40 layers
    num_image_tokens=1601,   # 1600 patches + 1 cls (560px / 14 tiles)
    rope_theta=500_000.0,
)
