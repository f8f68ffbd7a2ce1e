"""zamba2-2.7b — hybrid: Mamba2 backbone + one SHARED attention block
applied periodically (zamba-style weight sharing).
[arXiv:2411.15242; hf]
54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    shared_attn_every=6,     # 9 applications of the shared block over 54L
    chunk_size=32,
)
