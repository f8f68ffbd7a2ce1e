"""LM for the dense family (llama3 / qwen2.5 / minicpm / mistral-large).

A stack of L identical pre-norm blocks (GQA attention + SwiGLU MLP) with the
parameters stacked along a leading layer axis, as in the JAX package. A
Python loop over layers takes the place of ``lax.scan``.

Entry points, as in the reference:
  ``loss``         — training loss (next-token cross-entropy + z-loss)
  ``forward``      — no-cache logits (flash, blockwise or einsum attention)
  ``prefill``      — forward + KV-cache fill, returns last-position logits
  ``decode_step``  — one token per sequence against the cache

``cfg.remat`` wraps each layer of ``forward`` as the reference's remat
policy wraps its scanned body: ``"full"`` recomputes the layer in backward
(``torch.utils.checkpoint``), ``"none"`` keeps its activations.

The KV cache is preallocated as [L, B, KV, S_max, hd] and written in place.
Other families (moe, ssm, hybrid, vlm, audio) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from . import layers as Lyr
from .params import ParamDef, Tree, init_params


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


def _remat(fn, policy: str):
    """The reference's ``_maybe_remat`` for one layer."""
    if policy == "none":
        return fn
    if policy == "dots":
        raise NotImplementedError(
            'remat="dots" (save matmul outputs) is not ported yet (ROADMAP: '
            'queue 0, "dots" remat)')
    if policy != "full":
        raise ValueError(f"unknown remat policy {policy!r}")

    def run(*args):
        if not torch.is_grad_enabled():      # nothing to save: same compute
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)
    return run


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense" or cfg.num_experts:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet "
                "(ROADMAP: LM substrate queue); only dense models run")
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
        L, d = cfg.num_layers, cfg.d_model
        return {
            "embed": Lyr.embed_defs(cfg),
            "final_norm": Lyr.norm_defs(d),
            "blocks": {
                "ln2": Lyr.norm_defs(d, prefix=(L,)),
                "ln1": Lyr.norm_defs(d, prefix=(L,)),
                "attn": Lyr.attention_defs(cfg, layers=L),
                "ffn": Lyr.mlp_defs(cfg, layers=L),
            },
        }

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Tree:
        """Random weights from ``generator``, which must live on ``device``."""
        return init_params(self.param_defs(), generator,
                           resolve_device(device))

    # ------------------------------------------------------------------

    def _dense_block(self, p: Tree, x, positions, *, impl, cache=None,
                     cache_pos=None):
        cfg = self.cfg
        h = Lyr.apply_norm(p["ln1"], x, cfg.norm_eps)
        a, new_cache = Lyr.attention(p["attn"], h, cfg, positions=positions,
                                     cache=cache, cache_pos=cache_pos,
                                     impl=impl)
        x = x + a
        h = Lyr.apply_norm(p["ln2"], x, cfg.norm_eps)
        return x + Lyr.mlp(p["ffn"], h), new_cache

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits [B,S,V], moe_aux), aux being 0 for dense models."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        x = Lyr.embed(params["embed"], tokens)
        impl = self._impl(s)

        def body(x, p):
            return self._dense_block(p, x, positions, impl=impl)[0]
        body = _remat(body, cfg.remat)
        for p in layer_list(params["blocks"], cfg.num_layers):
            x = body(x, p)
        x = Lyr.apply_norm(params["final_norm"], x, cfg.norm_eps)
        logits = Lyr.unembed(params["embed"], x)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Mean next-token NLL plus ``z_loss * mean(lse^2)``, in f32.

        The true logit is gathered instead of the reference's one-hot
        product: the same value, without a [B, S, V] f32 one-hot (4.2 GB at
        batch 2 x 4096 tokens of a 128k vocab)."""
        cfg = self.cfg
        logits, _ = self.forward(params, batch)
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        true_logit = logits.gather(-1, batch["labels"][..., None].long())[..., 0]
        nll = lse - true_logit
        return nll.mean() + cfg.z_loss * (lse * lse).mean()

    # ------------------------------------------------------------------
    # serving: cache defs / prefill / decode

    def cache_defs(self, batch: int, max_seq: int) -> Tree:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_seq,
                 cfg.resolved_head_dim)
        return {"self": {"k": ParamDef(shape, init="zeros"),
                         "v": ParamDef(shape, init="zeros")}}

    def init_cache(self, batch: int, max_seq: int,
                   device: Optional[torch.device] = None) -> Tree:
        return init_params(self.cache_defs(batch, max_seq), None,
                           resolve_device(device))

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor],
                cache: Tree) -> Tuple[torch.Tensor, Tree]:
        """Run the full prompt, filling cache; returns (last logits, cache)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        x = Lyr.embed(params["embed"], tokens)
        x, cache = self._stack_with_cache(params, x, positions, cache,
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
        positions = torch.full((b, 1), pos, dtype=torch.int32,
                               device=tokens.device)
        x = Lyr.embed(params["embed"], tokens)
        x, cache = self._stack_with_cache(params, x, positions, cache,
                                          cache_pos=pos, impl="einsum")
        x = Lyr.apply_norm(params["final_norm"], x, cfg.norm_eps)
        logits = Lyr.unembed(params["embed"], x)
        return logits[:, 0], cache

    def _stack_with_cache(self, params, x, positions, cache, cache_pos, impl):
        kc, vc = cache["self"]["k"], cache["self"]["v"]
        for i in range(self.cfg.num_layers):
            x, _ = self._dense_block(layer_slice(params["blocks"], i), x,
                                     positions, impl=impl,
                                     cache={"k": kc[i], "v": vc[i]},
                                     cache_pos=cache_pos)
        return x, cache
