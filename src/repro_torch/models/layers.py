"""Transformer building blocks of the dense serving path.

Every layer is a plain function over a params subtree (a dict of tensors built
from the matching ``*_defs`` builder), with the JAX package's layouts and
numerics: norms and softmax in f32, the half-split rotary embedding, scores in
f32 masked with -1e30.

Attention runs one of five ways:

* with a KV cache and one query token under ``cfg.use_flash``: the
  ``flash_decode`` CUDA kernel;
* with a KV cache otherwise: an einsum directly in cache layout;
* without a cache, by ``impl``: the ``flash_attention`` CUDA kernel
  (``"flash"``, the training path), online softmax over 512-row blocks in
  plain torch (``"blockwise"``) or the full-score einsum (``"einsum"``).

MoE is not ported yet (ROADMAP: the LM substrate queue).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
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
    out = {"scale": ParamDef(prefix + (d,), init="ones")}
    if with_bias:
        out["bias"] = ParamDef(prefix + (d,), init="zeros")
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
    freqs = torch.exp(-math.log(theta) *
                      torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
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
    out = {
        "wq": ParamDef(pre + (d, hq * hd)),
        "wk": ParamDef(pre + (d, hkv * hd)),
        "wv": ParamDef(pre + (d, hkv * hd)),
        "wo": ParamDef(pre + (hq * hd, d),
                       scale=1.0 / max(1, 2 * cfg.num_layers) ** 0.5),
    }
    if cfg.qkv_bias:
        for n, w in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            out[n] = ParamDef(pre + (w * hd,), init="zeros")
    return out


def _einsum_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """q [B,S,KV,G,hd] x k, v [B,S,KV,hd] -> [B,S,KV,G,hd] in q's dtype."""
    hd, sq = q.shape[-1], q.shape[1]
    s = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(rows < cols, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.float()).to(q.dtype)


def _blockwise_attention(q, k, v, *, causal: bool, bq: int = 512,
                         bk: int = 512) -> torch.Tensor:
    """Online-softmax attention over [bq, bk] blocks (plain torch).

    The reference's ``lax.map`` over query blocks and ``lax.scan`` over KV
    blocks become two Python loops; padding, the -1e30 mask and the
    ``l == 0 -> 1`` guard are the reference's.
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
        rows = qi * bq + torch.arange(bq, device=q.device)[:, None]
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


def attention(p: Tree, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              causal: bool = True, cache: Optional[Tree] = None,
              cache_pos: Optional[int] = None, impl: str = "einsum"
              ) -> Tuple[torch.Tensor, Optional[Tree]]:
    """Self-attention (causal unless ``causal=False``) with an optional KV
    cache.

    x: [B, S, D]. cache: dict with "k"/"v" [B, KV, S_max, hd], written in
    place at ``cache_pos`` (the reference's ``dynamic_update_slice`` returns
    a new cache; updating in place saves a copy of the whole cache per
    step). Returns (y [B, S, D], the cache or None).
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    g = hq // hkv

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)

    q = rope(q, positions, cfg.rope_theta)
    if cache is None:
        kpos = positions
    else:
        kpos = (cache_pos + torch.arange(s, device=x.device))[None, :]
    k = rope(k, kpos, cfg.rope_theta)

    qg = q.reshape(b, s, hkv, g, hd)
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        t = ck.shape[2]
        if cache_pos + s > t:
            raise ValueError(f"cache of {t} slots cannot take {s} tokens at "
                             f"position {cache_pos}")
        ck[:, :, cache_pos:cache_pos + s] = k.transpose(1, 2).to(ck.dtype)
        cv[:, :, cache_pos:cache_pos + s] = v.transpose(1, 2).to(cv.dtype)
    if cache is not None and s == 1 and cfg.use_flash:
        # single-token decode through the flash_decode kernel: streams the
        # cache once, no score traffic to device memory
        lens = torch.full((b,), cache_pos + 1, dtype=torch.int32,
                          device=x.device)
        out = flash_decode(qg[:, 0], ck, cv, lens)[:, None]   # [B,1,KV,G,hd]
    elif cache is not None:
        # attention directly in cache layout [B, KV, T, hd]: transposing
        # the full cache would read and write it twice per step
        sc = torch.einsum("bskgd,bktd->bkgst", qg.float(),
                          ck.float()) / math.sqrt(hd)
        rows = cache_pos + torch.arange(s, device=x.device)[:, None]
        cols = torch.arange(t, device=x.device)[None, :]
        mask = cols < cache_pos + s                      # frontier
        if causal:
            mask = mask & (rows >= cols)
        sc = sc.masked_fill(~mask, _NEG_INF)
        pr = torch.softmax(sc, dim=-1)
        out = torch.einsum("bkgst,bktd->bskgd", pr, cv.float()).to(x.dtype)
    elif impl == "flash":
        # [B, S, H, hd] seen as [B, H, S, hd] through strides: the kernel
        # reads and writes the model's layout, and its output transposed
        # back is a view. It reads kv head h // G itself, where the
        # reference's ops.gqa_attention repeats K and V first.
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal)
        out = o.transpose(1, 2).reshape(b, s, hkv, g, hd)
    elif impl == "blockwise":
        out = _blockwise_attention(qg, k, v, causal=causal)
    elif impl == "einsum":
        out = _einsum_attention(qg, k, v, causal=causal)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")

    y = out.reshape(b, s, hq * hd) @ p["wo"]
    return y, cache


# ---------------------------------------------------------------------------
# MLP


def mlp_defs(cfg, layers: int = 0) -> Tree:
    d, f = cfg.d_model, cfg.d_ff
    pre = (layers,) if layers else ()
    return {
        "w_up": ParamDef(pre + (d, f)),
        "w_down": ParamDef(pre + (f, d),
                           scale=1.0 / max(1, 2 * cfg.num_layers) ** 0.5),
        "w_gate": ParamDef(pre + (d, f)),
    }


def mlp(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU in the activation dtype: silu(x @ w_gate) * (x @ w_up)."""
    up = x @ p["w_up"]
    h = F.silu(x @ p["w_gate"]) * up
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# embeddings


def embed_defs(cfg) -> Tree:
    d = cfg.d_model
    return {
        "tok": ParamDef((cfg.padded_vocab, d), scale=1.0, fan_in=d),
        "out": ParamDef((d, cfg.padded_vocab)),
    }


def embed(p: Tree, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, p["tok"])


def unembed(p: Tree, x: torch.Tensor) -> torch.Tensor:
    return x @ p["out"]
