"""Grouped-query attention through the flash-attention kernel.

The reference's ``gqa_attention`` is a jitted wrapper that repeats K and V
to the query heads before its kernel. The port's kernel reads kv head
``h // G`` itself, so on the kernel's path no repeated copy is made; the
plain path (``use_kernel=False``) repeats, as the reference does, before
``attention_ref``.

The reference's ``interpret`` argument is not taken: it picks Pallas's
interpreter, where the port picks its route by device (a CPU tensor takes
the kernel's plain version, a CUDA tensor launches the kernel or raises).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .ref import attention_ref


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, use_kernel: bool = True,
                  q_off: int = 0) -> torch.Tensor:
    """Grouped-query attention: q [B, Hq, S, d], k/v [B, Hkv, Skv, d].

    With ``use_kernel`` the causal mask is the kernel's (top left, q's row r
    at key row ``q_off + r``), without it ``attention_ref``'s (bottom
    right), as in the reference; the two agree at Sq == Skv and q_off 0."""
    hq, hkv = q.shape[1], k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if use_kernel:
        return flash_attention(q, k, v, causal=causal, q_off=q_off)
    if q_off:
        raise ValueError("attention_ref takes no q_off (its causal mask is "
                         "bottom right)")
    if hq != hkv:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    return attention_ref(q, k, v, causal=causal)


__all__ = ["flash_attention", "attention_ref", "gqa_attention"]
