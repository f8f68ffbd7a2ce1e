"""Plain PyTorch version of the flash-decode kernel (the tests' oracle)."""

from __future__ import annotations

import torch


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor
                     ) -> torch.Tensor:
    """q [B,KV,G,hd] vs cache [B,KV,T,hd] with per-seq frontier masking."""
    hd = q.shape[-1]
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), k_cache.float()) / (hd ** 0.5)
    t = k_cache.shape[2]
    mask = torch.arange(t, device=q.device)[None, :] < lengths[:, None]  # [B, T]
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,bktd->bkgd", p, v_cache.float()).to(q.dtype)
