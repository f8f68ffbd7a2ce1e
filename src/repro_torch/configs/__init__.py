"""Architecture registry: ``--arch <id>`` resolves through ARCHS."""

from .base import (LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K, DECODE_32K,
                   ModelConfig, ShapeSpec, cell_is_runnable, model_flops)
from .granite_moe_1b_a400m import CONFIG as GRANITE_MOE
from .llama3_8b import CONFIG as LLAMA3_8B
from .llama4_maverick_400b_a17b import CONFIG as LLAMA4_MAVERICK
from .llama_3_2_vision_11b import CONFIG as LLAMA32_VISION
from .minicpm_2b import CONFIG as MINICPM_2B
from .mistral_large_123b import CONFIG as MISTRAL_LARGE
from .qwen2_5_14b import CONFIG as QWEN25_14B
from .rwkv6_7b import CONFIG as RWKV6_7B
from .whisper_small import CONFIG as WHISPER_SMALL
from .zamba2_2_7b import CONFIG as ZAMBA2_27B

ARCHS = {c.name: c for c in [
    RWKV6_7B, MINICPM_2B, MISTRAL_LARGE, LLAMA3_8B, QWEN25_14B,
    ZAMBA2_27B, GRANITE_MOE, LLAMA4_MAVERICK, LLAMA32_VISION, WHISPER_SMALL,
]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "get_config", "ModelConfig", "ShapeSpec", "SHAPES",
           "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "cell_is_runnable", "model_flops"]
