"""Plain PyTorch version of the flash-decode kernel (the tests' oracle)."""

from __future__ import annotations

import torch


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     return_lse: bool = False):
    """q [B,KV,G,hd] vs cache [B,KV,T,hd] with per-seq frontier masking.

    As the kernel: a length of 0 gives output 0, and ``return_lse`` (the
    partial form) gives the output in f32 and each row's log-sum-exp
    [B,KV,G] in f32 (natural log; -inf at length 0)."""
    hd = q.shape[-1]
    s = torch.einsum("bkgd,bktd->bkgt", q.float(), k_cache.float()) / (hd ** 0.5)
    t = k_cache.shape[2]
    mask = torch.arange(t, device=q.device)[None, :] < lengths[:, None]  # [B, T]
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    live = (lengths > 0)[:, None, None]                             # [B,1,1]
    out = torch.einsum("bkgt,bktd->bkgd", p, v_cache.float())
    out = torch.where(live[..., None], out, 0.0)
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.where(live, torch.logsumexp(s, dim=-1), float("-inf"))
    return out, lse
