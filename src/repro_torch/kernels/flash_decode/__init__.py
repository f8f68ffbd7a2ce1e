from .flash_decode import flash_decode
from .ops import decode_attention
from .ref import flash_decode_ref

__all__ = ["flash_decode", "flash_decode_ref", "decode_attention"]
