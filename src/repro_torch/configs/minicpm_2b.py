"""minicpm-2b — llama-like dense with WSD schedule.
[arXiv:2404.06395; hf]  40L d_model=2304 36H (MHA) d_ff=5760 vocab=122753."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    rope_theta=10_000.0,
    optimizer="adamw_wsd",   # the paper's WSD schedule
)
