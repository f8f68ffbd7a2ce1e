"""LM — one model class covering every architecture family of the JAX package.

Families and their block stacks (the reference's, with the parameters
stacked along a leading layer axis; a Python loop over layers takes the
place of ``lax.scan``):

  dense   (llama3 / qwen2.5 / minicpm / mistral-large): L identical pre-norm
          blocks (GQA attention + SwiGLU MLP).
  moe     (granite / llama4-maverick): groups of (period-1) dense layers + 1
          MoE layer.
  ssm     (rwkv6): RWKV6 time-mix / channel-mix layers.
  hybrid  (zamba2): groups of Mamba2 layers, one SHARED attention+MLP block
          applied after each group (its weights are not stacked).
  vlm     (llama-3.2-vision): groups of self-attention layers, each followed
          by a cross-attention block (into stub image embeddings, no
          self-attention in it).
  audio   (whisper): a bidirectional encoder over stub frame embeddings, then
          a decoder of causal self-attention + cross-attention into the
          encoder's output; biased layer norms, gelu MLPs.

Entry points, as in the reference:
  ``loss``         — training loss (next-token cross-entropy + z-loss, plus
                     ``router_aux_coef`` x the MoE load-balance aux)
  ``forward``      — no-cache logits and the summed MoE aux
  ``prefill``      — forward + cache fill, returns last-position logits
  ``decode_step``  — one token per sequence against the cache

``cfg.remat`` wraps the layers the reference's remat policy wraps:
``"full"`` recomputes a layer in backward (``torch.utils.checkpoint``),
``"dots"`` keeps the outputs of its matrix products and recomputes the rest
(selective checkpointing, the reference's ``checkpoint_dots``), ``"none"``
keeps its activations.

``shapes`` / ``logical_axes`` and ``cache_shapes`` / ``cache_logical_axes``
give the parameter and cache trees as meta tensors and logical-axis tuples
(nothing allocated), which ``launch.steps`` resolves to placements on a
``DeviceMesh``.

Caches are preallocated (``init_cache``) and written in place: KV caches at
the step's position, recurrent states (RWKV's ``wkv`` and token shifts,
Mamba2's ``ssm`` and conv history) and the cross-attention K/V (computed
at prefill) whole, so a decode step reads and writes the same tensors
every step.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import trace
from repro_torch.configs.base import AUDIO_FRAMES, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (flatten, get_rules, linear,
                                              replicate_like, unflatten,
                                              use_rules)
from . import layers as Lyr
from . import ssm as Ssm
from .params import (ParamDef, Tree, init_params, param_logical_axes,
                     param_shapes)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def layer_slice(tree: Tree, i: int) -> Tree:
    """One layer's view of a tree of stacked [L, ...] tensors."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def layer_list(tree: Tree, n: int) -> list:
    """Every layer's view of a tree of stacked [L, ...] tensors at once.

    ``unbind`` gives one backward that stacks the layers' gradients, where
    indexing each layer apart would allocate a zero [L, ...] gradient per
    layer and sum them."""
    flat = {k: layer_list(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _write(dst: Tree, src: Tree) -> None:
    """Copy a tree of tensors into a preallocated tree of the same paths."""
    for k, v in dst.items():
        if isinstance(v, dict):
            _write(v, src[k])
        else:
            v.copy_(src[k])


# What the port's ``@`` and ``einsum`` lower to: the matrix products whose
# outputs ``remat="dots"`` keeps.
DOT_OPS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                     torch.ops.aten.addmm.default,
                     torch.ops.aten.baddbmm.default))


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.checkpoint_dots``: save the products'
    outputs, recompute everything else. The flash_attention Function is no
    product (as a ``pallas_call`` is no dot to jax): it is recomputed."""
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, policy: str):
    """The reference's ``_maybe_remat`` for one layer."""
    if policy == "none":
        return fn
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    kw = {} if policy == "full" else {"context_fn": partial(
        create_selective_checkpoint_contexts, _save_dots)}

    def run(*args):
        if not torch.is_grad_enabled():      # nothing to save: same compute
            return fn(*args)
        rules = get_rules()

        def body(*a):
            # the recompute may run on the backward's thread, where the
            # sharding rules (thread-local) are not the forward's
            with use_rules(rules):
                return fn(*a)
        return checkpoint(body, *args, use_reentrant=False, **kw)
    return run


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                             f"have {FAMILIES}")
        self.cfg = cfg

    def _impl(self, s: int) -> str:
        """Attention implementation for a query length of s."""
        cfg = self.cfg
        if cfg.attn_impl != "auto":
            return cfg.attn_impl
        if cfg.use_flash and s > 1:
            return "flash"
        return "blockwise" if s >= 4096 else "einsum"

    # ------------------------------------------------------------------
    # parameter definitions

    def param_defs(self) -> Tree:
        cfg = self.cfg
        L, d, fam = cfg.num_layers, cfg.d_model, cfg.family
        defs: Tree = {"embed": Lyr.embed_defs(cfg),
                      "final_norm": Lyr.norm_defs(
                          d, with_bias=fam == "audio")}
        if fam == "ssm":
            defs["blocks"] = Ssm.rwkv_defs(cfg, L)
        elif fam == "hybrid":
            defs["blocks"] = Ssm.mamba_defs(cfg, L)
            defs["shared_attn"] = self._dense_block_defs(layers=0)
        elif fam == "audio":
            defs["encoder"] = self._dense_block_defs(
                layers=cfg.encoder_layers or L, gated=False, with_bias=True)
            defs["blocks"] = self._dense_block_defs(
                layers=L, gated=False, with_bias=True, cross=True)
            defs["enc_final_norm"] = Lyr.norm_defs(d, with_bias=True)
        elif fam == "vlm":
            defs["blocks"] = self._dense_block_defs(layers=L)
            # llama3.2-style cross layers: cross-attn + MLP, no self-attn
            defs["cross_blocks"] = self._dense_block_defs(
                layers=L // cfg.cross_attn_every, cross=True, cross_only=True)
        elif fam == "moe":
            n_moe = L // cfg.moe_layer_period
            if cfg.moe_layer_period > 1:
                defs["blocks"] = self._dense_block_defs(layers=L - n_moe)
            defs["moe_blocks"] = self._dense_block_defs(layers=n_moe, moe=True)
        else:
            defs["blocks"] = self._dense_block_defs(layers=L)
        return defs

    def _dense_block_defs(self, layers: int, gated: bool = True,
                          with_bias: bool = False, moe: bool = False,
                          cross: bool = False, cross_only: bool = False
                          ) -> Tree:
        cfg = self.cfg
        d = cfg.d_model
        pre = (layers,) if layers else ()
        out = {"ln2": Lyr.norm_defs(d, with_bias, pre)}
        if not cross_only:
            out["ln1"] = Lyr.norm_defs(d, with_bias, pre)
            out["attn"] = Lyr.attention_defs(cfg, layers=layers)
        out["ffn"] = (Lyr.moe_defs(cfg, layers=layers) if moe else
                      Lyr.mlp_defs(cfg, gated=gated, layers=layers))
        if cross:
            out["ln_x"] = Lyr.norm_defs(d, with_bias, pre)
            out["xattn"] = Lyr.attention_defs(cfg, layers=layers)
        return out

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Tree:
        """Random weights from ``generator``, which must live on ``device``."""
        return init_params(self.param_defs(), generator,
                           resolve_device(device))

    def shapes(self) -> Tree:
        return param_shapes(self.param_defs())

    def logical_axes(self) -> Tree:
        return param_logical_axes(self.param_defs())

    # ------------------------------------------------------------------
    # block appliers (p = one layer's param slice)

    def _dense_block(self, p: Tree, x, positions, *, impl, causal=True,
                     memory=None, cache=None, cache_pos=None,
                     xmemory_kv=None):
        """Pre-norm block: self-attention (if the block has one), then
        cross-attention (if it has one: into ``memory``, or in decode into
        the precomputed ``xmemory_kv``), then the MLP or MoE. Returns (x,
        the MoE aux or None)."""
        cfg = self.cfg
        if "attn" in p:
            h = Lyr.apply_norm(p["ln1"], x, cfg.norm_eps)
            a, _ = Lyr.attention(p["attn"], h, cfg, positions=positions,
                                 causal=causal, cache=cache,
                                 cache_pos=cache_pos, impl=impl)
            x = x + a
        if "xattn" in p:
            h = Lyr.apply_norm(p["ln_x"], x, cfg.norm_eps)
            if xmemory_kv is not None:       # decode: precomputed cross K/V
                xa = self._cross_from_kv(p["xattn"], h, xmemory_kv)
            else:
                xa, _ = Lyr.attention(p["xattn"], h, cfg, positions=positions,
                                      causal=False, memory=memory,
                                      impl="einsum")
            x = x + xa
        h = Lyr.apply_norm(p["ln2"], x, cfg.norm_eps)
        if "router" in p["ffn"]:
            m, aux = Lyr.moe_ffn(p["ffn"], h, cfg)
            return x + m, aux
        return x + Lyr.mlp(p["ffn"], h), None

    def _cross_from_kv(self, p: Tree, x, kv: Tree) -> torch.Tensor:
        """Cross-attention against precomputed K/V [B, KV, T, hd], read in
        that layout (the reference's einsum attention, no mask)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        q = linear(x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        out = Lyr.cache_attention(unflatten(q, 2, (hkv, hq // hkv, hd),
                                            spill=1),
                                  kv["k"], kv["v"])
        return linear(flatten(out, 2, 3, spill=1), p["wo"])

    def _cross_kv(self, p: Tree, memory: torch.Tensor) -> Tree:
        """Cross K/V of ``memory`` for decode, [B, KV, T, hd] each."""
        cfg = self.cfg
        b, t, _ = memory.shape
        hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
        k = linear(memory, p["wk"])
        v = linear(memory, p["wv"])
        if "bk" in p:
            k, v = k + p["bk"], v + p["bv"]
        return {"k": unflatten(k, 2, (hkv, hd), spill=1).transpose(1, 2),
                "v": unflatten(v, 2, (hkv, hd), spill=1).transpose(1, 2)}

    def _attn_layers(self, params: Tree) -> List[Tree]:
        """The attention + FFN layers of a dense or moe stack in depth
        order (moe: (period-1) dense layers, then one MoE layer, a group)."""
        cfg = self.cfg
        if cfg.family != "moe":
            return layer_list(params["blocks"], cfg.num_layers)
        period = cfg.moe_layer_period
        n_moe = cfg.num_layers // period
        dense = layer_list(params["blocks"], cfg.num_layers - n_moe) \
            if period > 1 else []
        out = []
        for g, moe in enumerate(layer_list(params["moe_blocks"], n_moe)):
            out += dense[g * (period - 1):(g + 1) * (period - 1)] + [moe]
        return out

    # ------------------------------------------------------------------
    # forward (training / no-cache)

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits [B,S,V], the summed MoE aux; 0 without MoE)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = replicate_like(
            torch.arange(s, device=tokens.device)[None].expand(b, s), tokens)
        with trace.span("embed"):
            x = Lyr.embed(params["embed"], tokens)
        impl = self._impl(s)
        fam = cfg.family
        aux = None
        if fam == "ssm":
            body = _remat(lambda x, p: Ssm.rwkv_block(p, x, cfg)[0],
                          cfg.remat)
            for p in layer_list(params["blocks"], cfg.num_layers):
                x = body(x, p)
        elif fam == "hybrid":
            x = self._hybrid_forward(params, x, positions, impl)
        elif fam == "audio":
            x = self._audio_forward(params, batch, x, positions, impl)
        elif fam == "vlm":
            x = self._vlm_forward(params, batch, x, positions, impl)
        else:                       # dense, moe
            x, aux = self._moe_forward(params, x, positions, impl)
        with trace.span("head"):
            x = Lyr.apply_norm(params["final_norm"], x, cfg.norm_eps)
            logits = Lyr.unembed(params["embed"], x)
        if aux is None:
            aux = replicate_like(
                torch.zeros((), dtype=torch.float32, device=x.device), x)
        return logits, aux

    def _block_fn(self, positions, impl, remat: bool, **kw):
        """``_dense_block`` as f(x, p) -> (x, aux), remat'd if asked."""
        def block(x, p):
            return self._dense_block(p, x, positions, impl=impl, **kw)
        return _remat(block, self.cfg.remat) if remat else block

    def _hybrid_forward(self, params, x, positions, impl):
        """Mamba2 layers, the shared block (not remat'd) after each group of
        ``shared_attn_every``."""
        cfg = self.cfg
        k = cfg.shared_attn_every or cfg.num_layers
        inner = _remat(lambda x, p: Ssm.mamba_block(p, x, cfg)[0], cfg.remat)
        shared = self._block_fn(positions, impl, remat=False)
        for i, p in enumerate(layer_list(params["blocks"], cfg.num_layers)):
            x = inner(x, p)
            if (i + 1) % k == 0:
                x, _ = shared(x, params["shared_attn"])
        return x

    def _moe_forward(self, params, x, positions, impl):
        """Dense layers, and for moe (period-1) dense layers then one MoE
        layer a group; returns (x, the summed aux or None). Under period 1
        the reference remats its group (one MoE layer), under period > 1
        the dense layers only."""
        cfg = self.cfg
        dense = self._block_fn(positions, impl, remat=True)
        moe = self._block_fn(positions, impl,
                             remat=cfg.moe_layer_period == 1)
        aux = None
        for p in self._attn_layers(params):
            x, a = (moe if "router" in p["ffn"] else dense)(x, p)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def _vlm_forward(self, params, batch, x, positions, impl):
        """Self-attention layers, a cross-attention block (not remat'd) into
        ``image_embeds`` after each group of ``cross_attn_every``."""
        cfg = self.cfg
        memory = batch["image_embeds"].to(x.dtype)
        k = cfg.cross_attn_every
        inner = self._block_fn(positions, impl, remat=True)
        cross_fn = self._block_fn(positions, impl, remat=False,
                                  memory=memory)
        cross = layer_list(params["cross_blocks"], cfg.num_layers // k)
        for i, p in enumerate(layer_list(params["blocks"], cfg.num_layers)):
            x, _ = inner(x, p)
            if (i + 1) % k == 0:
                x, _ = cross_fn(x, cross[i // k])
        return x

    def _audio_forward(self, params, batch, x, positions, impl):
        """The decoder over the encoder's output of ``frames``."""
        memory = self._encode(params, batch["frames"].to(x.dtype))
        body = self._block_fn(positions, impl, remat=True, memory=memory)
        for p in layer_list(params["blocks"], self.cfg.num_layers):
            x, _ = body(x, p)
        return x

    def _encode(self, params: Tree, frames: torch.Tensor) -> torch.Tensor:
        """Whisper encoder over stub frame embeddings [B, T, D]:
        bidirectional self-attention blocks, then a biased layer norm."""
        cfg = self.cfg
        b, t, _ = frames.shape
        pos = replicate_like(
            torch.arange(t, device=frames.device)[None].expand(b, t), frames)
        body = self._block_fn(pos, self._impl(t), remat=True, causal=False)
        x = frames
        for p in layer_list(params["encoder"],
                            cfg.encoder_layers or cfg.num_layers):
            x, _ = body(x, p)
        return Lyr.apply_norm(params["enc_final_norm"], x, cfg.norm_eps)

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Mean next-token NLL plus ``z_loss * mean(lse^2)``, in f32, plus
        ``router_aux_coef * aux`` for MoE models.

        The true logit is gathered instead of the reference's one-hot
        product: the same value, without a [B, S, V] f32 one-hot (4.2 GB at
        batch 2 x 4096 tokens of a 128k vocab)."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch)
        with trace.span("loss"):
            logits = logits.float()
            lse = torch.logsumexp(logits, dim=-1)
            # subtracted before the trailing dim is dropped: on vocab-sharded
            # DTensor logits the gather is a masked partial sum, which
            # DTensor reduces only at the gather's own shape
            true_logit = logits.gather(-1, batch["labels"][..., None].long())
            nll = (lse[..., None] - true_logit)[..., 0]
            loss = nll.mean() + cfg.z_loss * (lse * lse).mean()
            if cfg.num_experts:
                loss = loss + cfg.router_aux_coef * aux
            return loss

    # ------------------------------------------------------------------
    # serving: cache defs / prefill / decode

    def cache_defs(self, batch: int, max_seq: int) -> Tree:
        cfg = self.cfg
        L, fam = cfg.num_layers, cfg.family

        def kv(layers, seq):
            shape = (layers, batch, cfg.num_kv_heads, seq,
                     cfg.resolved_head_dim)
            ax = ("layers", "cache_batch", "cache_heads", "cache_seq",
                  "cache_hd")
            return {"k": ParamDef(shape, ax, init="zeros"),
                    "v": ParamDef(shape, ax, init="zeros")}

        if fam == "ssm":
            return Ssm.rwkv_state_defs(cfg, batch, L)
        if fam == "hybrid":
            groups = L // (cfg.shared_attn_every or L)
            return {"mamba": Ssm.mamba_state_defs(cfg, batch, L),
                    "shared": kv(groups, max_seq)}
        if fam == "audio":
            return {"self": kv(L, max_seq),
                    "cross": kv(L, AUDIO_FRAMES)}
        if fam == "vlm":
            return {"self": kv(L, max_seq),
                    "cross": kv(L // cfg.cross_attn_every,
                                cfg.num_image_tokens)}
        return {"self": kv(L, max_seq)}

    def init_cache(self, batch: int, max_seq: int,
                   device: Optional[torch.device] = None) -> Tree:
        return init_params(self.cache_defs(batch, max_seq), None,
                           resolve_device(device))

    def cache_shapes(self, batch: int, max_seq: int) -> Tree:
        return param_shapes(self.cache_defs(batch, max_seq))

    def cache_logical_axes(self, batch: int, max_seq: int) -> Tree:
        return param_logical_axes(self.cache_defs(batch, max_seq))

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor],
                cache: Tree) -> Tuple[torch.Tensor, Tree]:
        """Run the full prompt, filling the cache (vlm: ``image_embeds``,
        audio: ``frames`` give the cross K/V); returns (last logits, cache).
        Recurrent states start from the cache's, as in the reference."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = replicate_like(
            torch.arange(s, device=tokens.device)[None].expand(b, s), tokens)
        x = Lyr.embed(params["embed"], tokens)
        x = self._stack_with_cache(params, batch, x, positions, cache,
                                   cache_pos=0, impl=self._impl(s))
        x = Lyr.apply_norm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        logits = Lyr.unembed(params["embed"], x)
        return logits[:, 0], cache

    def decode_step(self, params: Tree, batch: Dict[str, torch.Tensor],
                    cache: Tree, pos: int) -> Tuple[torch.Tensor, Tree]:
        """One token step. batch["tokens"]: [B, 1]; pos: the frontier."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b = tokens.shape[0]
        positions = replicate_like(
            torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device),
            tokens)
        x = Lyr.embed(params["embed"], tokens)
        x = self._stack_with_cache(params, batch, x, positions, cache,
                                   cache_pos=pos, impl="einsum")
        x = Lyr.apply_norm(params["final_norm"], x, cfg.norm_eps)
        logits = Lyr.unembed(params["embed"], x)
        return logits[:, 0], cache

    def _stack_with_cache(self, params, batch, x, positions, cache,
                          cache_pos, impl):
        """Every layer against the cache, written in place; returns x."""
        cfg = self.cfg
        fam, L = cfg.family, cfg.num_layers

        def attn_block(p, x, kv, i, **kw):
            return self._dense_block(
                p, x, positions, impl=impl, cache=layer_slice(kv, i),
                cache_pos=cache_pos, **kw)[0]

        if fam == "ssm":
            for i, p in enumerate(layer_list(params["blocks"], L)):
                st = layer_slice(cache, i)
                x, new = Ssm.rwkv_block(p, x, cfg, state=st)
                _write(st, new)
        elif fam == "hybrid":
            k = cfg.shared_attn_every or L
            for i, p in enumerate(layer_list(params["blocks"], L)):
                st = layer_slice(cache["mamba"], i)
                x, new = Ssm.mamba_block(p, x, cfg, state=st)
                _write(st, new)
                if (i + 1) % k == 0:
                    x = attn_block(params["shared_attn"], x, cache["shared"],
                                   i // k)
        elif fam == "vlm":
            k = cfg.cross_attn_every
            cross = layer_list(params["cross_blocks"], L // k)
            if "image_embeds" in batch:    # prefill: compute cross K/V now
                mem = batch["image_embeds"].to(x.dtype)
                for g, cp in enumerate(cross):
                    _write(layer_slice(cache["cross"], g),
                           self._cross_kv(cp["xattn"], mem))
            for i, p in enumerate(layer_list(params["blocks"], L)):
                x = attn_block(p, x, cache["self"], i)
                if (i + 1) % k == 0:
                    x, _ = self._dense_block(
                        cross[i // k], x, positions, impl=impl,
                        xmemory_kv=layer_slice(cache["cross"], i // k))
        elif fam == "audio":
            blocks = layer_list(params["blocks"], L)
            if "frames" in batch:          # prefill: encode + cross K/V
                mem = self._encode(params, batch["frames"].to(x.dtype))
                for i, p in enumerate(blocks):
                    _write(layer_slice(cache["cross"], i),
                           self._cross_kv(p["xattn"], mem))
            for i, p in enumerate(blocks):
                x = attn_block(p, x, cache["self"], i,
                               xmemory_kv=layer_slice(cache["cross"], i))
        else:
            for i, p in enumerate(self._attn_layers(params)):
                x = attn_block(p, x, cache["self"], i)
        return x
