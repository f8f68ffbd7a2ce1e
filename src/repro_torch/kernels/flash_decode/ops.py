"""Drop-in decode attention for the serving path: the kernel or its plain
version; and the merge of the kernel's partial states over cache shards."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from .flash_decode import flash_decode
from .ref import flash_decode_ref


def decode_attention(q, k_cache, v_cache, lengths, *, use_kernel: bool = True):
    if use_kernel:
        return flash_decode(q, k_cache, v_cache, lengths)
    return flash_decode_ref(q, k_cache, v_cache, lengths)


def _weights(lse: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """exp(lse - top), an empty state (lse = -inf) weighing 0, also when
    every state is empty (top = -inf)."""
    return torch.where(lse == float("-inf"), 0.0, torch.exp(lse - top))


def merge_partials(outs: Sequence[torch.Tensor],
                   lses: Sequence[torch.Tensor]) -> torch.Tensor:
    """The attention over the union of cache shards from each shard's
    partial state (``flash_decode(..., return_lse=True)``: f32 outputs
    [..., hd] and log-sum-exps [...]): the outputs weighed by exp(lse - max
    lse) in f32, the combine kernel's rule; a row whose every shard is
    empty gives 0. Returns f32: the caller rounds once to its dtype."""
    lse = torch.stack([x.float() for x in lses])
    w = _weights(lse, lse.amax(0))
    num = (w[..., None] * torch.stack([o.float() for o in outs])).sum(0)
    den = w.sum(0)
    return num / torch.where(den == 0, 1.0, den)[..., None]


def merge_over_ranks(out: torch.Tensor, lse: torch.Tensor, groups
                     ) -> torch.Tensor:
    """``merge_partials`` over the ranks of ``groups`` (process groups, the
    mesh dims that shard the cache's slots), each rank holding one shard's
    state: an f32 all-reduce MAX of lse, then one SUM of the rescaled
    outputs with their weights. Every rank gets the merged output, in
    f32."""
    top = lse.float().clone()
    for g in groups:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
    w = _weights(lse.float(), top)
    packed = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    for g in groups:
        dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=g)
    den = packed[..., -1:]
    return packed[..., :-1] / torch.where(den == 0, 1.0, den)


__all__ = ["flash_decode", "flash_decode_ref", "decode_attention",
           "merge_partials", "merge_over_ranks"]
