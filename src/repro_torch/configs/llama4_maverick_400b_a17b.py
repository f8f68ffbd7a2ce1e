"""llama4-maverick-400b-a17b — large-scale MoE, 128 experts top-1,
MoE layers interleaved every other layer (matches the 400B-total /
17B-active budget of the name).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_layer_period=2,      # dense / MoE interleave
    rope_theta=500_000.0,
    fsdp=True,               # 390B params: shard weights over data too
    sequence_parallel=True,  # keeps the residual sharded
)
