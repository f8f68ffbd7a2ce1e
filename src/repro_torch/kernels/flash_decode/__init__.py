from .flash_decode import flash_decode
from .ops import decode_attention, merge_over_ranks, merge_partials
from .ref import flash_decode_ref

__all__ = ["flash_decode", "flash_decode_ref", "decode_attention",
           "merge_partials", "merge_over_ranks"]
