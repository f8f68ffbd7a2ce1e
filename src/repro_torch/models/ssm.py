"""Sub-quadratic sequence mixers: RWKV6 (Finch) and Mamba2 (SSD).

Both use the reference's chunked-recurrence strategy: the sequence is split
into chunks of ``cfg.chunk_size``; a Python loop (the reference's
``lax.scan``) carries the recurrent state across chunks while each chunk
computes its intra-chunk interactions with a masked pairwise-decay tensor.
Every pairwise exponent is of the form ``logA[t-1] - logA[i]`` with
i <= t-1 and logA non-increasing, taken through ``exp(min(diff, 0))``, so
no ``exp`` argument is positive (``torch.minimum`` splits the gradient at
a tie, as ``jnp.minimum`` does). The recurrences run in f32; a ragged last
chunk is padded with the identity (zero inputs, decay 1). Decode runs the
chunked form with t = 1, as the reference does.

State shapes (per layer, carried through decode and written in place by
the model):
  RWKV6  : wkv [B, nh, hd, hd] f32 (key-dim x value-dim outer-product
           state), shift_tm / shift_cm [B, D] (the last *normed* input of
           the time and channel mixes)
  Mamba2 : ssm [B, nh, hd, st] f32 (head-dim x ssm-state outer-product
           state), conv [B, W-1, di + 2 st] (the causal conv's history)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.sharding import (flatten, linear, pinned,
                                              replicate_like, shard,
                                              unflatten, unsharded)
from .layers import rms_norm
from .params import ParamDef

Tree = Dict[str, Any]

LORA_MAA = 32        # rwkv6 token-shift lora rank
LORA_DECAY = 64      # rwkv6 data-dependent decay lora rank


# (batch dim, heads dim) of each argument and result of the chunked scans
_RWKV_DIMS = (((0, 2),) * 4 + ((None, 0), (0, 1)), ((0, 2), (0, 1)))
_MAMBA_DIMS = (((0, 2), (0, None), (0, None), (0, 2), (0, 1)),
               ((0, 2), (0, 1)))


def _local_scan(fn, args, dims, chunk: int):
    """``fn(*args, chunk)`` (a chunked scan) on each rank's shards of
    DTensors, through ``local_map``; plain tensors go to ``fn`` as they
    are. ``dims`` gives each argument's and result's (batch, heads) dims.
    Each mesh dim keeps the first argument's shard of the batch or of the
    heads (where they split evenly), the others following it, and gathers
    anything else: the recurrence runs along the whole time axis. On
    DTensors the loop would take each chunk's products through DTensor,
    whose bmm some of its versions refuse with the batch and heads both
    sharded."""
    x = args[0]
    if not isinstance(x, DTensor):
        return fn(*args, chunk)
    mesh = x.device_mesh
    (batch, heads), nh = dims[0][0], x.shape[dims[0][0][1]]
    modes = [0 if p.is_shard(batch) else
             1 if p.is_shard(heads) and nh % mesh.size(i) == 0 else None
             for i, p in enumerate(x.placements)]

    def placements(d, grad=False):
        # an argument whole on a mesh dim that splits the others gets a
        # partial sum of gradients there
        return tuple(Shard(d[m]) if m is not None and d[m] is not None
                     else Partial() if grad and m is not None
                     else Replicate() for m in modes)
    return local_map(lambda *a: fn(*a, chunk),
                     out_placements=tuple(placements(d) for d in dims[1]),
                     in_placements=tuple(placements(d) for d in dims[0]),
                     in_grad_placements=tuple(placements(d, True)
                                              for d in dims[0]),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _pad_time(a: torch.Tensor, tp: int) -> torch.Tensor:
    """Zero-pad dim 1 (time) of ``a`` up to ``tp``."""
    pad = [0, 0] * (a.dim() - 2) + [0, tp - a.shape[1]]
    return F.pad(a, pad)


# ===========================================================================
# RWKV6 (Finch) — data-dependent decay linear attention
# ===========================================================================


def rwkv_defs(cfg, layers: int) -> Tree:
    d = cfg.d_model
    nh = d // cfg.ssm_head_dim
    hd = cfg.ssm_head_dim
    f = cfg.d_ff
    out_scale = 1.0 / max(1, 2 * cfg.num_layers) ** 0.5

    def w(shape, axes, **kw):
        return ParamDef((layers,) + shape, ("layers",) + axes, **kw)

    return {
        "ln1": {"scale": w((d,), ("embed",), init="ones")},
        "ln2": {"scale": w((d,), ("embed",), init="ones")},
        # token-shift ddlerp
        "maa_x": w((d,), ("embed",), init="zeros"),
        "maa_rkvwg": w((5, d), (None, "embed"), init="zeros"),
        "maa_w1": w((d, 5 * LORA_MAA), ("embed", "lora")),
        "maa_w2": w((5, LORA_MAA, d), (None, "lora", "embed"),
                    fan_in=LORA_MAA),
        # data-dependent decay
        "decay": w((d,), ("embed",), init="const", scale=-6.0),
        "td_w1": w((d, LORA_DECAY), ("embed", "lora")),
        "td_w2": w((LORA_DECAY, d), ("lora", "embed"), fan_in=LORA_DECAY),
        "bonus": w((nh, hd), ("ssm_heads", None)),     # time_faaaa / u
        # projections
        "wr": w((d, d), ("embed", "ssm_inner")),
        "wk": w((d, d), ("embed", "ssm_inner")),
        "wv": w((d, d), ("embed", "ssm_inner")),
        "wg": w((d, d), ("embed", "ssm_inner")),
        "wo": w((d, d), ("ssm_inner", "embed"), scale=out_scale),
        "ln_x": {"scale": w((d,), ("embed",), init="ones")},
        # channel mix
        "cm_maa_k": w((d,), ("embed",), init="zeros"),
        "cm_maa_r": w((d,), ("embed",), init="zeros"),
        "cm_wk": w((d, f), ("embed", "mlp")),
        "cm_wv": w((f, d), ("mlp", "embed"), scale=out_scale),
        "cm_wr": w((d, d), ("embed", "ssm_inner")),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x[t-1] stream: prev is the last token of the previous segment."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def rwkv_wkv_chunked(r, k, v, w_log, u, state, chunk: int):
    """WKV recurrence, chunked.

    r/k/v/w_log: [B, T, nh, hd]; u: [nh, hd]; state: [B, nh, hd, hd].
    out_t = r_t . (S_t + u*k_t (x) v_t);  S_{t+1} = diag(w_t) S_t + k_t (x) v_t
    Returns out [B, T, nh, hd] in r's dtype, and the final state in f32.
    """
    b, t, nh, hd = r.shape
    c = min(chunk, t)
    tp = -(-t // c) * c
    if tp != t:
        # identity padding: k=v=r=0 contribute nothing, w_log=0 is decay 1
        r, k, v, w_log = (_pad_time(a, tp) for a in (r, k, v, w_log))
    idx = torch.arange(c, device=r.device)
    below = (idx[:, None] > idx[None, :])[None, :, :, None, None]
    u32 = u.float()
    state = state.float()
    outs = []
    for i in range(0, tp, c):
        rr, kk, vv, ww = (a[:, i:i + c].float() for a in (r, k, v, w_log))
        log_a = torch.cumsum(ww, dim=1)               # inclusive
        log_a_prev = log_a - ww                       # exclusive
        # inter-chunk: state contribution
        inter = torch.einsum("bcnd,bnde->bcne", rr * torch.exp(log_a_prev),
                             state)
        # intra-chunk pairwise (strictly lower-triangular)
        diff = log_a_prev[:, :, None] - log_a[:, None]    # [B,c,c,nh,hd]
        dec = torch.exp(torch.minimum(diff, diff.new_zeros(()))) * below
        scores = (rr[:, :, None] * kk[:, None] * dec).sum(-1)   # [B,t,i,nh]
        intra = torch.einsum("btin,bine->btne", scores, vv)
        # bonus (current token)
        bonus = (rr * u32 * kk).sum(-1)
        intra = intra + bonus[..., None] * vv
        # state update
        k_dec = kk * torch.exp(log_a[:, -1:] - log_a)
        state = state * torch.exp(log_a[:, -1])[..., None] + \
            torch.einsum("bind,bine->bnde", k_dec, vv)
        outs.append((inter + intra).to(r.dtype))
    return torch.cat(outs, dim=1)[:, :t], state


def rwkv_block(p: Tree, x: torch.Tensor, cfg, state: Optional[Tree] = None
               ) -> Tuple[torch.Tensor, Optional[Tree]]:
    """One RWKV6 layer (time mix + channel mix). ``state`` carries {"wkv",
    "shift_tm", "shift_cm"} for prefill and decode; None in training (the
    shift sees zeros before t=0). Returns (y, the new state or None); the
    caller writes the new state where it keeps it."""
    b, t, d = x.shape
    nh, hd = d // cfg.ssm_head_dim, cfg.ssm_head_dim
    eps = cfg.norm_eps
    decode = state is not None

    # ---- time mix -------------------------------------------------------
    xn = rms_norm(x, p["ln1"]["scale"], eps)
    prev_tm = state["shift_tm"] if decode else x.new_zeros((b, d))
    xprev = _token_shift(xn, prev_tm.to(xn.dtype))
    dx = xprev - xn
    xxx = xn + dx * p["maa_x"]
    ddd = unflatten(torch.tanh(linear(xxx, p["maa_w1"])), 2, (5, LORA_MAA),
                    spill=1)
    # the einsum merges batch and time, which some versions of DTensor
    # cannot do with both sharded (the sequence-parallel rules): time is
    # gathered, and the gradient comes back so
    ddd = pinned(torch.einsum("btfl,fld->btfd", unsharded(ddd, 1),
                              p["maa_w2"]))
    mixed = xn[:, :, None, :] + dx[:, :, None, :] * \
        (p["maa_rkvwg"][None, None] + ddd)
    xr, xk, xv, xw, xg = unsharded(mixed, 2).unbind(2)

    r = unflatten(linear(xr, p["wr"]), 2, (nh, hd), spill=1)
    k = unflatten(linear(xk, p["wk"]), 2, (nh, hd), spill=1)
    v = unflatten(linear(xv, p["wv"]), 2, (nh, hd), spill=1)
    g = F.silu(linear(xg, p["wg"]))
    r = shard(r, "batch", "seq", "ssm_heads", None)
    k = shard(k, "batch", "seq", "ssm_heads", None)
    v = shard(v, "batch", "seq", "ssm_heads", None)

    dd = p["decay"] + linear(torch.tanh(linear(xw, p["td_w1"])), p["td_w2"])
    w_log = unflatten(-torch.exp(dd.float()), 2, (nh, hd),
                      spill=1)                         # log decay, < 0

    wkv0 = state["wkv"] if decode else replicate_like(
        torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device), x)
    out, wkv = _local_scan(rwkv_wkv_chunked,
                           (r, k, v, w_log, p["bonus"], wkv0),
                           _RWKV_DIMS, min(cfg.chunk_size, t))
    out = rms_norm(flatten(out, 2, 2, spill=1), p["ln_x"]["scale"], eps) * g
    x = shard(x + linear(out, p["wo"]), "batch", "seq", "embed")

    # ---- channel mix ----------------------------------------------------
    xn2 = rms_norm(x, p["ln2"]["scale"], eps)
    prev_cm = state["shift_cm"] if decode else x.new_zeros((b, d))
    dx2 = _token_shift(xn2, prev_cm.to(xn2.dtype)) - xn2
    xk2 = xn2 + dx2 * p["cm_maa_k"]
    xr2 = xn2 + dx2 * p["cm_maa_r"]
    kk = shard(torch.square(torch.relu(linear(xk2, p["cm_wk"]))),
               "batch", "seq", "mlp")
    x = x + torch.sigmoid(linear(xr2, p["cm_wr"])) * linear(kk, p["cm_wv"])
    x = shard(x, "batch", "seq", "embed")

    new_state = None
    if decode:
        new_state = {"wkv": wkv, "shift_tm": xn[:, -1], "shift_cm": xn2[:, -1]}
    return x, new_state


def rwkv_state_defs(cfg, batch: int, layers: int) -> Tree:
    d = cfg.d_model
    nh, hd = d // cfg.ssm_head_dim, cfg.ssm_head_dim
    return {
        "wkv": ParamDef((layers, batch, nh, hd, hd),
                        ("layers", "cache_batch", "ssm_heads", None, None),
                        dtype=torch.float32, init="zeros"),
        "shift_tm": ParamDef((layers, batch, d),
                             ("layers", "cache_batch", "embed"), init="zeros"),
        "shift_cm": ParamDef((layers, batch, d),
                             ("layers", "cache_batch", "embed"), init="zeros"),
    }


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================


def mamba_defs(cfg, layers: int) -> Tree:
    d, di, st = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_heads
    wconv = cfg.ssm_conv_width

    def w(shape, axes, **kw):
        return ParamDef((layers,) + shape, ("layers",) + axes, **kw)

    return {
        "ln": {"scale": w((d,), ("embed",), init="ones")},
        # in_proj -> [z (di), x (di), B (st), C (st), dt (nh)]
        "w_in": w((d, 2 * di + 2 * st + nh), ("embed", "ssm_inner")),
        "conv_w": w((wconv, di + 2 * st), ("conv", "ssm_inner"),
                    fan_in=wconv),
        "conv_b": w((di + 2 * st,), ("ssm_inner",), init="zeros"),
        "a_log": w((nh,), ("ssm_heads",), init="const", scale=0.5),
        "dt_bias": w((nh,), ("ssm_heads",), init="zeros"),
        "d_skip": w((nh,), ("ssm_heads",), init="ones"),
        "norm": {"scale": w((di,), ("ssm_inner",), init="ones")},
        "w_out": w((di, d), ("ssm_inner", "embed"),
                   scale=1.0 / max(1, 2 * cfg.num_layers) ** 0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 buf: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time. x: [B, T, C]; w: [W, C].
    buf: [B, W-1, C] history for decode (None -> zero history). Returns
    (silu(conv + b), the last W-1 inputs)."""
    wlen = w.shape[0]
    hist = x.new_zeros((x.shape[0], wlen - 1, x.shape[2])) if buf is None \
        else buf.to(x.dtype)
    xp = torch.cat([hist, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(wlen))
    return F.silu(out + b), xp[:, -(wlen - 1):, :]


def mamba_ssd_chunked(xh, B, C, log_a, state, chunk: int):
    """SSD scan. xh: [B,T,nh,hd] (dt-scaled inputs), B/C: [B,T,st],
    log_a: [B,T,nh] (log decay <= 0), state: [B,nh,hd,st]. Returns
    (y [B,T,nh,hd] f32, the final state f32)."""
    b, t, nh, hd = xh.shape
    c = min(chunk, t)
    tp = -(-t // c) * c
    if tp != t:
        # identity padding: x=B=C=0 contribute nothing, logA=0 is decay 1
        xh, B, C, log_a = (_pad_time(a, tp) for a in (xh, B, C, log_a))
    idx = torch.arange(c, device=xh.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    state = state.float()
    outs = []
    for i in range(0, tp, c):
        xx, bb, cc, aa = (a[:, i:i + c].float() for a in (xh, B, C, log_a))
        log_c = torch.cumsum(aa, dim=1)               # [B,c,nh] inclusive
        # inter: y_t += exp(logA_t) * C_t . state
        inter = torch.einsum("bts,bnds->btnd", cc, state) * \
            torch.exp(log_c)[..., None]
        # intra (i <= t): dec[t,i] = exp(logA_t - logA_i)
        diff = log_c[:, :, None] - log_c[:, None]     # [B,c,c,nh]
        dec = torch.exp(torch.minimum(diff, diff.new_zeros(()))) * causal
        scores = torch.einsum("bts,bis->bti", cc, bb)[..., None] * dec
        intra = torch.einsum("btin,bind->btnd", scores, xx)
        # state update
        x_dec = xx * torch.exp(log_c[:, -1:] - log_c)[..., None]
        state = state * torch.exp(log_c[:, -1])[..., None, None] + \
            torch.einsum("bind,bis->bnds", x_dec, bb)
        outs.append(inter + intra)
    return torch.cat(outs, dim=1)[:, :t], state


def mamba_block(p: Tree, x: torch.Tensor, cfg,
                state: Optional[Tree] = None
                ) -> Tuple[torch.Tensor, Optional[Tree]]:
    """One Mamba2 layer. ``state``: {"ssm", "conv"} for prefill and decode,
    None in training. Returns (y, the new state or None)."""
    b, t, d = x.shape
    di, stt, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = cfg.ssm_head_dim
    decode = state is not None

    xn = rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
    proj = shard(linear(xn, p["w_in"]), "batch", "seq", "ssm_inner")
    z, xin, Bc, Cc, dt = torch.split(proj, [di, di, stt, stt, nh], dim=-1)
    conv_out, conv_buf = _causal_conv(
        torch.cat([xin, Bc, Cc], dim=-1), p["conv_w"], p["conv_b"],
        state["conv"] if decode else None)
    xin, Bc, Cc = torch.split(conv_out, [di, stt, stt], dim=-1)

    # softplus as the reference's jax.nn.softplus, log(1 + e^x), in f32
    dt = dt.float() + p["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))              # [B,T,nh]
    log_a = -torch.exp(p["a_log"].float())[None, None] * dt
    xh = unflatten(xin, 2, (nh, hd), spill=1)
    xh_dt = xh.float() * dt[..., None]

    ssm0 = state["ssm"] if decode else replicate_like(
        torch.zeros((b, nh, hd, stt), dtype=torch.float32, device=x.device), x)
    y, ssm = _local_scan(mamba_ssd_chunked, (xh_dt, Bc, Cc, log_a, ssm0),
                         _MAMBA_DIMS, min(cfg.chunk_size, t))
    y = y + p["d_skip"].float()[None, None, :, None] * xh.float()
    y = flatten(y, 2, 2, spill=1).to(x.dtype)
    y = rms_norm(y, p["norm"]["scale"], cfg.norm_eps) * F.silu(z)
    y = shard(y, "batch", "seq", "ssm_inner")
    out = shard(x + linear(y, p["w_out"]), "batch", "seq", "embed")

    new_state = None
    if decode:
        new_state = {"ssm": ssm, "conv": conv_buf}
    return out, new_state


def mamba_state_defs(cfg, batch: int, layers: int) -> Tree:
    di, stt, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = cfg.ssm_head_dim
    wconv = cfg.ssm_conv_width
    return {
        "ssm": ParamDef((layers, batch, nh, hd, stt),
                        ("layers", "cache_batch", "ssm_heads", None, None),
                        dtype=torch.float32, init="zeros"),
        "conv": ParamDef((layers, batch, wconv - 1, di + 2 * stt),
                         ("layers", "cache_batch", None, "ssm_inner"),
                         init="zeros"),
    }
