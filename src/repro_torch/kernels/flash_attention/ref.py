"""Plain PyTorch versions of flash attention.

Two plain versions, kept apart on purpose:

* ``attention_ref`` is a faithful copy of the JAX package's oracle, including
  its bottom-right causal alignment (``tril(k=Skv-Sq)``).
* ``flash_attention_plain`` computes what the kernel (and the Pallas kernel it
  replaces) computes: a top-left causal mask (``row >= col``), only keys below
  Skv, f32 inside, output in q's dtype.

The two agree whenever Sq == Skv or the call is not causal; at causal
Sq != Skv they differ, and the kernel is held to the second.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Naive softmax attention over [B, H, S, d] (f32 internally)."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (d ** 0.5)
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_off: int = 0
                          ) -> torch.Tensor:
    """The kernel's function: q [B, H, S, d] against k, v [B, KV, Skv, d].

    KV may divide H (query head h reads kv head h // (H // KV)); the group
    axis is a reshape, so no repeated copy of K and V is made. q's row r is
    the keys' row ``q_off + r`` under the causal mask (a slice of a longer
    sequence's rows).
    """
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, sq, d).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * (1.0 / d ** 0.5)
    if causal:
        rows = q_off + torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(rows < cols, NEG_INF)
    # Under a top-left mask row r (>= 0) always sees key 0, so no row is fully
    # masked while Skv >= 1 (the kernel's `l == 0 -> 1` guard never fires
    # there); with Skv == 0 the sum below is empty and rows give 0, as in
    # the kernel.
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)
