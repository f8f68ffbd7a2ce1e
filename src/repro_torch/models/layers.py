"""Transformer building blocks of every family's serving and training path.

Every layer is a plain function over a params subtree (a dict of tensors built
from the matching ``*_defs`` builder), with the JAX package's layouts and
numerics: norms and softmax in f32, the half-split rotary embedding, scores in
f32 masked with -1e30.

Attention runs one of five ways:

* with a KV cache and one query token under ``cfg.use_flash``: the
  ``flash_decode`` CUDA kernel;
* with a KV cache otherwise: an einsum directly in cache layout;
* without a cache, by ``impl``: the ``flash_attention`` CUDA kernel
  through ``gqa_attention`` (``"flash"``, the training path), online softmax over 512-row blocks in
  plain torch (``"blockwise"``) or the full-score einsum (``"einsum"``).

On DTensors both kernels run on each rank's shards through ``local_map``
(``_local_decode``, ``_local_attention``): a cache sharded on its slots
takes the kernel's partial form on each rank's slots and merges the partial
states over the ranks, a cache sharded on its head dim is gathered for the
call, and a layout the kernel cannot take raises; no branch switches to
another quietly.

Cross-attention (``memory=``) takes keys and values from the memory and
ropes neither side. MoE is the reference's capacity-based grouped routing:
an f32 router, top-k with renormalised gates, a stable sort of the
(token, choice) pairs by expert into a dense [B, E, capacity, D] block
(pairs past an expert's capacity are dropped), the experts' SwiGLU as
batched products, and a token-side gather to combine.

Activations carry the reference's logical sharding constraints (``shard``)
and weights its ZeRO-3 gather at use (``GW``), at the reference's sites with
its logical axes. Both are the identity on plain tensors; on DTensors they
redistribute to the placements the active rules give. Tensors the model makes
itself (positions, masks, iotas, zero states) go beside a DTensor through
``replicate_like``, replicated on its mesh.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch import trace
from repro_torch.distributed.sharding import (flatten, gather_weight as GW,
                                              linear, replicate_like, shard,
                                              unflatten)
from repro_torch.kernels.flash_attention import gqa_attention
from repro_torch.kernels.flash_decode import flash_decode, merge_over_ranks
from .params import ParamDef

Tree = Dict[str, Any]

_NEG_INF = -1e30

# ---------------------------------------------------------------------------
# norms


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


def norm_defs(d: int, with_bias: bool = False,
              prefix: Tuple[int, ...] = ()) -> Tree:
    ax = ("layers",) * len(prefix)
    out = {"scale": ParamDef(prefix + (d,), ax + ("embed",), init="ones")}
    if with_bias:
        out["bias"] = ParamDef(prefix + (d,), ax + ("embed",), init="zeros")
    return out


def apply_norm(p: Tree, x: torch.Tensor, eps: float) -> torch.Tensor:
    if "bias" in p:
        return layer_norm(x, p["scale"], p["bias"], eps)
    return rms_norm(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (absolute token indices).

    Half-split rotation: the first half of hd pairs with the second half."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = replicate_like(torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=torch.float32,
                                        device=x.device) / half), x)
    ang = positions[..., None].float() * freqs                  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention


def attention_defs(cfg, layers: int = 0) -> Tree:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    pre = (layers,) if layers else ()
    ax = ("layers",) if layers else ()
    out = {
        "wq": ParamDef(pre + (d, hq * hd), ax + ("embed", "qkv")),
        "wk": ParamDef(pre + (d, hkv * hd), ax + ("embed", "qkv")),
        "wv": ParamDef(pre + (d, hkv * hd), ax + ("embed", "qkv")),
        "wo": ParamDef(pre + (hq * hd, d), ax + ("qkv", "embed"),
                       scale=1.0 / max(1, 2 * cfg.num_layers) ** 0.5),
    }
    if cfg.qkv_bias:
        for n, w in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            out[n] = ParamDef(pre + (w * hd,), ax + ("qkv",), init="zeros")
    return out


def _local_attention(fn, q, k, v, *, causal: bool) -> torch.Tensor:
    """``fn(q, k, v, causal=, q_off=)`` (an attention without a cache: q
    [B,S,KV,G,hd], k and v [B,T,KV,hd]) on each rank's shards of DTensors,
    through ``local_map``; plain tensors go to ``fn`` as they are.

    Each mesh dim keeps q's shard where the attention splits along it
    without talking: the batch (k and v sharded alike), the kv heads (when
    k and v hold them evenly), or q's rows (k and v gathered whole on it;
    ``q_off`` is the rank's first row, for the causal mask). Anything else
    is gathered. DTensor would run the products itself, but some of its
    versions cannot reshape a tensor whose batch and head dims are both
    sharded, as the products' bmm asks."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, causal=causal)
    mesh = q.device_mesh
    pq, pk, gk = [], [], []          # gk: k's and v's gradients
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p.is_shard(0) or (p.is_shard(2) and k.shape[2] % n == 0):
            pq.append(p), pk.append(p), gk.append(p)
        elif p.is_shard(1):          # each rank's rows see every key
            pq.append(p), pk.append(Replicate()), gk.append(Partial())
        else:
            pq.append(Replicate()), pk.append(Replicate())
            gk.append(Replicate())
    row, rows = 0, 1
    for i, p in enumerate(pq):
        if p.is_shard(1):
            row = row * mesh.size(i) + mesh.get_local_rank(i)
            rows *= mesh.size(i)
    q_off = row * (q.shape[1] // rows)

    def local(q, k, v):
        return fn(q, k, v, causal=causal, q_off=q_off)
    return local_map(local, out_placements=pq, in_placements=(pq, pk, pk),
                     in_grad_placements=(pq, gk, gk), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def _flash_attention(q, k, v, *, causal: bool, q_off: int = 0
                     ) -> torch.Tensor:
    """q [B,S,KV,G,hd] x k, v [B,T,KV,hd] through the flash_attention
    kernel. [B, S, H, hd] seen as [B, H, S, hd] through strides: the kernel
    reads and writes the model's layout, and its output transposed back is
    a view. It reads kv head h // G itself, where the reference's
    gqa_attention repeats K and V first."""
    b, s, kvh, g, hd = q.shape
    o = gqa_attention(q.reshape(b, s, kvh * g, hd).transpose(1, 2),
                      k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                      q_off=q_off)
    return o.transpose(1, 2).reshape(b, s, kvh, g, hd)


def _einsum_attention(q, k, v, *, causal: bool, q_off: int = 0
                      ) -> torch.Tensor:
    """q [B,S,KV,G,hd] x k, v [B,S,KV,hd] -> [B,S,KV,G,hd] in q's dtype;
    q's rows are the keys' rows from ``q_off`` on."""
    hd, sq = q.shape[-1], q.shape[1]
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        rows = q_off + torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(rows < cols, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.float()).to(q.dtype)


def _blockwise_attention(q, k, v, *, causal: bool, bq: int = 512,
                         bk: int = 512, q_off: int = 0) -> torch.Tensor:
    """Online-softmax attention over [bq, bk] blocks (plain torch).

    The reference's ``lax.map`` over query blocks and ``lax.scan`` over KV
    blocks become two Python loops; padding, the -1e30 mask and the
    ``l == 0 -> 1`` guard are the reference's. q's rows are the keys' rows
    from ``q_off`` on.
    """
    b, sq, kvh, g, hd = q.shape
    skv = k.shape[1]
    sqp, skp = -(-sq // bq) * bq, -(-skv // bk) * bk
    qp = F.pad(q, (0, 0, 0, 0, 0, 0, 0, sqp - sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, skp - skv))
    vp = F.pad(v, (0, 0, 0, 0, 0, skp - skv)).float()
    scale = 1.0 / math.sqrt(hd)
    blocks = []
    for qi in range(sqp // bq):
        qt = qp[:, qi * bq:(qi + 1) * bq].float()
        m = torch.full((b, kvh, g, bq), _NEG_INF, device=q.device)
        l = torch.zeros((b, kvh, g, bq), device=q.device)
        acc = torch.zeros((b, kvh, g, bq, hd), device=q.device)
        rows = q_off + qi * bq + torch.arange(bq, device=q.device)[:, None]
        for ki in range(skp // bk):
            kt = kp[:, ki * bk:(ki + 1) * bk].float()
            s = torch.einsum("bskgd,btkd->bkgst", qt, kt) * scale
            cols = ki * bk + torch.arange(bk, device=q.device)[None, :]
            mask = cols < skv
            if causal:
                mask = mask & (rows >= cols)
            s = s.masked_fill(~mask, _NEG_INF)
            m2 = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m2)
            p = torch.exp(s - m2[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgst,btkd->bkgsd", p, vp[:, ki * bk:(ki + 1) * bk])
            m = m2
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out = acc / l[..., None]                        # [b,kvh,g,bq,hd]
        blocks.append(out.permute(0, 3, 1, 2, 4))       # [b,bq,kvh,g,hd]
    return torch.cat(blocks, dim=1)[:, :sq].to(q.dtype)


def _slot_range(c: DTensor) -> Tuple[int, int]:
    """This rank's first slot of the cache ``c`` [..., T, hd] and its
    count. A slot dim sharded on several mesh dims splits in mesh order,
    each split as ``torch.chunk`` splits: DTensor's ``Shard`` in both torch
    versions the port runs on (2.11 and 2.13); a shard that disagrees
    raises."""
    dim, mesh = c.ndim - 2, c.device_mesh
    coord = mesh.get_coordinate()
    lo, n = 0, c.shape[dim]
    for i, p in enumerate(c.placements):
        if p.is_shard(dim):
            step = -(-n // mesh.size(i))
            first = min(step * coord[i], n)
            lo, n = lo + first, min(step, n - first)
    if n != c.to_local().shape[dim]:
        raise RuntimeError(f"cache shard of {c.to_local().shape[dim]} slots "
                           f"where torch.chunk gives {n}: {c.placements}")
    return lo, n


def _local_decode(qg: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                  frontier: int) -> torch.Tensor:
    """``flash_decode`` of one token's q [B, 1, KV, G, hd] against the cache
    [B, KV, T, hd] below slot ``frontier``; returns [B, 1, KV, G, hd].

    Plain tensors go to the kernel as they are. DTensors run it on each
    rank's shards through ``local_map``, a mesh dim by the cache's
    placement:

    * batch (split evenly): q takes the same shard, the call is local;
    * slots: each rank runs the kernel's partial form on its slots [lo, lo
      + n), with its own frontier clamp(frontier - lo, 0, n) (0 where the
      shard lies wholly past it), and the ranks merge their (output,
      log-sum-exp) states (``merge_over_ranks``: an all-reduce MAX, then a
      SUM), as the kernel's combine pass merges its splits;
    * head dim: the kernel cannot contract over part of hd, so K and V are
      gathered for the call (what an opaque kernel under jit gets);
    * anything else raises, naming the placements.

    The frontiers are built on the device from the host's ``frontier``:
    nothing is read back."""
    if not isinstance(ck, DTensor):
        lens = torch.full((qg.shape[0],), frontier, dtype=torch.int32,
                          device=qg.device)
        return flash_decode(qg[:, 0], ck, cv, lens)[:, None]
    mesh = ck.device_mesh
    if tuple(cv.placements) != tuple(ck.placements):
        raise NotImplementedError(f"flash_decode: K cache {ck.placements} "
                                  f"and V cache {cv.placements} differ")
    pq, pc, slot_dims = [], [], []
    for i, p in enumerate(ck.placements):
        if p.is_replicate():
            pq.append(Replicate()), pc.append(p)
        elif p.is_shard(0) and ck.shape[0] % mesh.size(i) == 0:
            pq.append(p), pc.append(p)
        elif p.is_shard(2):
            pq.append(Replicate()), pc.append(p), slot_dims.append(i)
        elif p.is_shard(3):
            pq.append(Replicate()), pc.append(Replicate())
        else:
            raise NotImplementedError(
                f"flash_decode cannot take a cache [B, KV, T, hd] of shape "
                f"{tuple(ck.shape)} with placements {ck.placements} on "
                f"{mesh}: it takes batch shards that split evenly, slot "
                f"shards and head-dim shards (gathered)")
    lo, n = _slot_range(ck) if slot_dims else (0, ck.shape[2])
    groups = [mesh.get_group(i) for i in slot_dims]

    def local(q, k, v):
        lens = (torch.full((q.shape[0],), frontier - lo, dtype=torch.int32,
                           device=q.device)).clamp_(0, n)
        if not groups:
            return flash_decode(q[:, 0], k, v, lens)[:, None]
        out, lse = flash_decode(q[:, 0], k, v, lens, return_lse=True)
        return merge_over_ranks(out, lse, groups).to(q.dtype)[:, None]
    return local_map(local, out_placements=pq, in_placements=(pq, pc, pc),
                     device_mesh=mesh, redistribute_inputs=True)(qg, ck, cv)


def write_slots(c: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """Write ``new`` [B, KV, s, hd] into the cache ``c`` [B, KV, T, hd] at
    slots ``pos`` to ``pos + s``, in place (the reference's
    ``dynamic_update_slice``).

    A DTensor cache sharded on its slots is written on each rank's own
    shard: ``new`` goes to the cache's placements with its slot dim
    replicated, and each rank copies the slots its shard holds (a write may
    straddle two ranks, or miss a rank). Slice assignment into a DTensor
    writes a redistributed copy and leaves the cache as it was."""
    s = new.shape[2]
    if not isinstance(c, DTensor):
        c[:, :, pos:pos + s] = new.to(c.dtype)
        return
    mesh, dim = c.device_mesh, c.ndim - 2
    want = [Replicate() if p.is_shard(dim) else p for p in c.placements]
    new = replicate_like(new.to(c.dtype), c).redistribute(mesh, want)
    lo, n = _slot_range(c)
    a, b = max(pos, lo), min(pos + s, lo + n)
    if a < b:
        c.to_local()[:, :, a - lo:b - lo].copy_(
            new.to_local()[:, :, a - pos:b - pos])


def cache_attention(qg: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention in f32 directly in cache layout: q [B, S, KV, G, hd]
    against K/V [B, KV, T, hd] (transposing a full cache would read and
    write it twice per step), the keys limited by ``mask`` [S, T] where
    given. Returns [B, S, KV, G, hd] in q's dtype."""
    sc = torch.einsum("bskgd,bktd->bkgst", qg.float(),
                      ck.float()) / math.sqrt(qg.shape[-1])
    if mask is not None:
        sc = sc.masked_fill(replicate_like(~mask, sc), _NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    return torch.einsum("bkgst,bktd->bskgd", pr, cv.float()).to(qg.dtype)


def attention(p: Tree, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              causal: bool = True, memory: Optional[torch.Tensor] = None,
              cache: Optional[Tree] = None, cache_pos: Optional[int] = None,
              impl: str = "einsum") -> Tuple[torch.Tensor, Optional[Tree]]:
    """Self- or cross-attention, the former with an optional KV cache.

    x: [B, S, D]. memory: [B, T, D] for cross-attention (keys and values
    come from it, and neither q nor k is rope'd); it takes no cache (decode
    reads precomputed cross K/V). cache: dict with "k"/"v" [B, KV, S_max,
    hd], written in place at ``cache_pos`` (the reference's
    ``dynamic_update_slice`` returns a new cache; updating in place saves a
    copy of the whole cache per step). Returns (y [B, S, D], the cache or
    None).
    """
    if memory is not None and cache is not None:
        raise ValueError("cross-attention takes no cache")
    with trace.span("attention"):
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        g = hq // hkv

        src = x if memory is None else memory
        q = linear(x, GW(p["wq"]))
        k = linear(src, GW(p["wk"]))
        v = linear(src, GW(p["wv"]))
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = shard(q, "batch", "seq", "qkv")
        # a head split that cannot keep a DTensor's shard moves it to seq
        q = unflatten(q, 2, (hq, hd), spill=1)
        k = unflatten(k, 2, (hkv, hd), spill=1)
        v = unflatten(v, 2, (hkv, hd), spill=1)

        if memory is None:
            q = rope(q, positions, cfg.rope_theta)
            if cache is None:
                kpos = positions
            else:
                kpos = replicate_like(
                    (cache_pos + torch.arange(s, device=x.device))[None, :],
                    x)
            k = rope(k, kpos, cfg.rope_theta)

        qg = unflatten(q, 2, (hkv, g), spill=1)
        if cache is not None:
            ck, cv = cache["k"], cache["v"]
            t = ck.shape[2]
            if cache_pos + s > t:
                raise ValueError(f"cache of {t} slots cannot take {s} "
                                 f"tokens at position {cache_pos}")
            write_slots(ck, k.transpose(1, 2), cache_pos)
            write_slots(cv, v.transpose(1, 2), cache_pos)
        if cache is not None and s == 1 and cfg.use_flash:
            # single-token decode through the flash_decode kernel: streams
            # the cache once, no score traffic to device memory
            out = _local_decode(qg, ck, cv, cache_pos + 1)    # [B,1,KV,G,hd]
        elif cache is not None:
            rows = cache_pos + torch.arange(s, device=x.device)[:, None]
            cols = torch.arange(t, device=x.device)[None, :]
            mask = cols < cache_pos + s                      # frontier
            if causal:
                mask = mask & (rows >= cols)
            out = cache_attention(qg, ck, cv, mask)
        elif impl == "flash":
            out = _local_attention(_flash_attention, qg, k, v,
                                   causal=causal)
        elif impl == "blockwise":
            out = _local_attention(_blockwise_attention, qg, k, v,
                                   causal=causal)
        elif impl == "einsum":
            out = _local_attention(_einsum_attention, qg, k, v,
                                   causal=causal)
        else:
            raise ValueError(f"unknown attention impl {impl!r}")

        out = shard(flatten(out, 2, 3, spill=1), "batch", "seq", "qkv")
        y = linear(out, GW(p["wo"]))
        return shard(y, "batch", "seq", "embed"), cache


# ---------------------------------------------------------------------------
# MLP


def mlp_defs(cfg, gated: bool = True, layers: int = 0) -> Tree:
    d, f = cfg.d_model, cfg.d_ff
    pre = (layers,) if layers else ()
    ax = ("layers",) if layers else ()
    out = {
        "w_up": ParamDef(pre + (d, f), ax + ("embed", "mlp")),
        "w_down": ParamDef(pre + (f, d), ax + ("mlp", "embed"),
                           scale=1.0 / max(1, 2 * cfg.num_layers) ** 0.5),
    }
    if gated:
        out["w_gate"] = ParamDef(pre + (d, f), ax + ("embed", "mlp"))
    return out


def mlp(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """In the activation dtype: SwiGLU, silu(x @ w_gate) * (x @ w_up), or
    without ``w_gate`` gelu(x @ w_up) in the tanh approximation (the
    default of the reference's ``jax.nn.gelu``)."""
    up = linear(x, GW(p["w_up"]))
    if "w_gate" in p:
        h = F.silu(linear(x, GW(p["w_gate"]))) * up
    else:
        h = F.gelu(up, approximate="tanh")
    h = shard(h, "batch", "seq", "mlp")
    return shard(linear(h, GW(p["w_down"])), "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# MoE (capacity-based grouped routing, gather-only dataflow)


def moe_defs(cfg, layers: int = 0) -> Tree:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    pre = (layers,) if layers else ()
    ax = ("layers",) if layers else ()
    return {
        "router": ParamDef(pre + (d, e), ax + ("embed", None),
                           dtype=torch.float32),
        "w_gate": ParamDef(pre + (e, d, f), ax + ("expert", "embed", "mlp")),
        "w_up": ParamDef(pre + (e, d, f), ax + ("expert", "embed", "mlp")),
        "w_down": ParamDef(pre + (e, f, d), ax + ("expert", "mlp", "embed"),
                           scale=1.0 / max(1, 2 * cfg.num_layers) ** 0.5),
    }


def moe_capacity(cfg, s: int) -> int:
    """Slots an expert has per sequence: ceil(s * k / e * capacity_factor)."""
    return int(math.ceil(s * cfg.experts_per_token / cfg.num_experts
                         * cfg.capacity_factor))


def moe_route(p: Tree, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router: an f32 softmax over experts, the top k with their gates
    renormalised, and the Switch load-balance loss over the first choice
    (e * sum_e f_e * p_e). Returns (gates [B,S,k] f32, choice [B,S,k],
    aux)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(linear(x.float(), p["router"]), dim=-1)  # [B,S,E]
    # the top k's values taken by a gather: the gradient of topk builds a
    # plain zero tensor, which a DTensor probs cannot take in some versions
    choice = torch.topk(probs, k, dim=-1)[1]
    gates = probs.gather(-1, choice)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    experts = replicate_like(torch.arange(e, device=x.device), choice)
    density = (choice[..., :1] == experts).float().mean(dim=(0, 1))
    aux = e * (density * probs.mean(dim=(0, 1))).sum()
    return gates, choice, aux


def moe_dispatch(ids: torch.Tensor, e: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Pseudo-tokens ids [B, T] (token-major expert choices) sorted by
    expert, stably, so that each expert keeps its earliest tokens. Returns
    (order [B,T], counts [B,E], starts [B,E], rank [B,T]): the sort, the
    tokens an expert got, where its group starts in the sort, and each
    pseudo-token's place within its expert's group."""
    b, t = ids.shape
    order = torch.argsort(ids, dim=1, stable=True)
    # out of place: DTensor cannot scatter in place into a tensor whose
    # placements the scatter changes
    counts = replicate_like(
        torch.zeros((b, e), dtype=ids.dtype, device=ids.device), ids
    ).scatter_add(1, ids, torch.ones_like(ids))
    starts = counts.cumsum(1) - counts
    rank_sorted = (replicate_like(torch.arange(t, device=ids.device), ids)
                   [None, :] - starts.gather(1, ids.gather(1, order)))
    # order is a permutation of each row: the scatter writes every slot
    rank = rank_sorted.scatter(1, order, rank_sorted)
    return order, counts, starts, rank


def _expert_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each expert's product, x [B, E, C, K] by w [E, K, N] (the einsum
    "becd,edf->becf"). On DTensors it runs on each rank's shards through
    ``local_map`` (some versions of DTensor leave a local tensor its own
    product cannot view), its placements a mesh dim by x's as in
    ``linear``: a shard of the experts meets w's; one of the batch or the
    capacity stays and gathers w (w's gradient a partial sum); one of K
    meets w's K (a partial product); a whole x keeps w's shard of N, or is
    cut to meet w's experts or K."""
    if not isinstance(x, DTensor):
        return torch.einsum("becd,edf->becf", x, w)
    spec = []          # (x, w, the product, x's gradient, w's gradient)
    for i, p in enumerate(x.placements):
        q = w.placements[i] if isinstance(w, DTensor) else Replicate()
        if p.is_shard(1):
            spec.append((p, Shard(0), p, p, Shard(0)))
        elif p.is_shard(3):
            spec.append((p, Shard(1), Partial(), p, Shard(1)))
        elif p.is_shard():
            spec.append((p, Replicate(), p, p, Partial()))
        elif p.is_partial():
            spec.append((p, Replicate(), p, Replicate(), Partial()))
        elif q.is_shard(2):
            spec.append((p, q, Shard(3), Partial(), q))
        elif q.is_shard(0) or q.is_shard(1):
            d = 1 if q.is_shard(0) else 3
            spec.append((Shard(d), q, Shard(1) if d == 1 else Partial(),
                         Shard(d), q))
        else:
            spec.append((p, p, p, p, p))
    px, pw, po, gx, gw = (list(t) for t in zip(*spec))
    return local_map(partial(torch.einsum, "becd,edf->becf"),
                     out_placements=po, in_placements=(px, pw),
                     in_grad_placements=(gx, gw), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w)


def moe_ffn(p: Tree, x: torch.Tensor, cfg
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, load-balance aux loss). Routing groups are
    sequences: tokens go into a dense [B, E, capacity, D] block, pairs past
    an expert's capacity are dropped (their output is 0), and each token
    sums its experts' outputs weighted by its gates. A decode step (S = 1,
    capacity 1) runs every expert, as in the reference."""
    with trace.span("moe"):
        return _moe_ffn(p, x, cfg)


def _moe_ffn(p: Tree, x: torch.Tensor, cfg
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = moe_capacity(cfg, s)
    with trace.span("moe.route"):
        gates, choice, aux = moe_route(p, x, cfg)

    with trace.span("moe.dispatch"):
        # ---- pseudo-token dispatch along seq ----------------------------
        t = s * k
        ids = choice.reshape(b, t)
        order, counts, starts, rank = moe_dispatch(ids, e)
        if trace.counting_on():
            trace.count("moe.pairs", b * t)
            trace.count("moe.pairs_dropped", (rank >= cap).sum())
            trace.count("moe.slots", b * e * cap)

        # ---- gather tokens into [B, E, cap, D] ---------------------------
        slots = replicate_like(torch.arange(cap, device=x.device), x)
        slot_i = (starts[:, :, None] + slots).clamp(0, t - 1)  # [B,E,cap]
        valid = slots[None, None, :] < counts[:, :, None]
        slot_tok = order.gather(1, slot_i.reshape(b, e * cap))
        src_tok = (slot_tok // k).clamp(0, s - 1)              # [B,E*cap]
        xe = x.gather(1, src_tok[..., None].expand(b, e * cap, d))
        xe = xe.reshape(b, e, cap, d).masked_fill(~valid[..., None], 0)
        xe = shard(xe, "batch", "expert", "capacity", "embed")

    with trace.span("moe.experts"):
        h = _expert_product(xe, p["w_gate"])
        h = F.silu(h) * _expert_product(xe, p["w_up"])
        h = shard(h, "batch", "expert", "capacity", "mlp")
        ye = _expert_product(h, p["w_down"])
        ye = shard(ye, "batch", "expert", "capacity", "embed")

    with trace.span("moe.combine"):
        # ---- token-side gather from [B, E*cap, D] ------------------------
        tok_slot = (ids * cap + rank).clamp(0, e * cap - 1)    # [B,T]
        yp = ye.reshape(b, e * cap, d).gather(
            1, tok_slot[..., None].expand(b, t, d))
        yp = yp.masked_fill(~(rank < cap)[..., None], 0).reshape(b, s, k, d)
        y = (yp * gates[..., None].to(yp.dtype)).sum(dim=2)
        return shard(y.to(x.dtype), "batch", "seq", "embed"), aux


# ---------------------------------------------------------------------------
# embeddings


def embed_defs(cfg) -> Tree:
    d = cfg.d_model
    return {
        # input table D-sharded (tiny per-device slice, gather stays local)
        "tok": ParamDef((cfg.padded_vocab, d), ("vocab_rep", "embed_shard"),
                        scale=1.0, fan_in=d),
        # unembed vocab-sharded: logits come out vocab-sharded
        "out": ParamDef((d, cfg.padded_vocab), ("embed", "vocab")),
    }


def embed(p: Tree, tokens: torch.Tensor) -> torch.Tensor:
    return shard(F.embedding(tokens, p["tok"]), "batch", "seq", "embed")


def unembed(p: Tree, x: torch.Tensor) -> torch.Tensor:
    return shard(linear(x, GW(p["out"])), "batch", "seq", "vocab")
