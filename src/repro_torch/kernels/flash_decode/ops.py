"""Drop-in decode attention for the serving path: the kernel or its plain version."""

from __future__ import annotations

from .flash_decode import flash_decode
from .ref import flash_decode_ref


def decode_attention(q, k_cache, v_cache, lengths, *, use_kernel: bool = True):
    if use_kernel:
        return flash_decode(q, k_cache, v_cache, lengths)
    return flash_decode_ref(q, k_cache, v_cache, lengths)


__all__ = ["flash_decode", "flash_decode_ref", "decode_attention"]
