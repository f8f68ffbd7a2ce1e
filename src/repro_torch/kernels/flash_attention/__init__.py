from .flash_attention import flash_attention
from .ops import gqa_attention
from .ref import attention_ref, flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain", "attention_ref",
           "gqa_attention"]
