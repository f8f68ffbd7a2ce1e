"""rwkv6-7b — Finch: attention-free RNN with data-dependent decay.
[arXiv:2404.05892; hf]  32L d_model=4096 d_ff=14336 vocab=65536."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,            # wkv heads = d_model / 64
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    ssm_head_dim=64,
    ssm_state=64,            # marks the recurrent family (state = hd x hd)
    chunk_size=32,
    causal=True,
)
