"""Step functions and sharding trees for training and serving.

The steps run eagerly (the reference's jit has no counterpart here). The
sharding trees are the reference's, over a ``DeviceMesh``: ``rules_for``
picks a config's rules, and ``train_shardings`` / ``serve_shardings`` give
``(mesh, placements)`` for every leaf of the state, the batch and the cache,
what ``distribute_tensor`` takes; ``place_tree`` lays a tree out by them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import trace
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data.pipeline import batch_logical_axes, batch_specs
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import LM
from repro_torch.models.params import Tree
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_state_axes,
                               adamw_state_shapes, adamw_update)
from repro_torch.optim.adamw import tree_leaves, tree_map


def rules_for(cfg: ModelConfig, *, params: bool = False) -> Dict[str, Any]:
    """Sharding rules for this config (activation rules by default; the
    param-only FSDP overlay with params=True).

    Profiles (hillclimb levers):
      "tp"      — Megatron TP over "model" (the baseline rules)
      "dp"      — pure data parallelism: the model axis joins the batch axes
                  and all weights replicate (layers too small to amortize TP
                  collectives)
      "zero3cp" — context parallelism plus output-dim ZeRO-3: activations
                  shard (batch, seq) and never the feature dims; weights are
                  stored sharded over (data x model) on their OUTPUT dim
                  (the "__reverse__" resolution) and gathered at use
    """
    rules = dict(shd.BASE_RULES)
    if cfg.sharding_profile == "dp":
        rules.update(
            batch=("pod", "data", "model"),
            cache_batch=("pod", "data", "model"),
            vocab=None, qkv=None, heads=None, mlp=None,
            ssm_inner=None, ssm_heads=None,
            embed_shard=None, cache_hd=None,
            expert="model" if cfg.num_experts else None,
        )
    elif cfg.sharding_profile == "zero3cp":
        rules.update(
            batch=("pod", "data"), seq="model",
            vocab=None, qkv=None, heads=None, mlp=None,
            ssm_inner=None, ssm_heads=None, embed_shard=None,
            expert="model" if cfg.num_experts else None,
            __gather_weights__=True,       # explicit gather at use
        )
        if params:
            two_d = ("data", "model")
            rules.update(qkv=two_d, mlp=two_d, embed=two_d, vocab=two_d,
                         vocab_rep=None, embed_shard=two_d,
                         ssm_inner=two_d, ssm_heads=two_d, lora=two_d,
                         __reverse__=True, __gather_weights__=False)
    if cfg.sequence_parallel:
        # residual/norm activations shard their seq axis over "model"
        rules["seq"] = "model"
    if cfg.decode_cache_shard == "seq":
        rules.update(cache_seq="model", cache_hd=None)
    if params and cfg.fsdp and cfg.sharding_profile == "tp":
        # ZeRO-3 overlay: weights' embed-ish axes also shard over data
        rules.update(embed="data", vocab_rep="data", mlp_fsdp="data")
    return rules


def make_optimizer_config(cfg: ModelConfig, total_steps: int = 10_000
                          ) -> AdamWConfig:
    from repro_torch.optim import make_optimizer
    return make_optimizer(cfg.optimizer, total_steps=total_steps,
                          grad_compress=cfg.grad_compress)


# ---------------------------------------------------------------------------
# training


def loss_and_grads(model: LM, params: Tree, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Tree]:
    """The loss (detached) and its gradients, a tree shaped like ``params``
    with the parameters' dtypes."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with trace.span("step.forward"):
            loss = model.loss(params, batch)
        with trace.span("step.backward"):
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model: LM, opt_cfg: AdamWConfig,
                    grad_specs: Optional[Tree] = None):
    """``train_step(state, batch) -> (state, loss)``: the loss and its
    gradients, then one AdamW update. The state's tensors are updated in
    place (see ``optim.adamw``); the returned state holds the same tensors
    and the new step count.

    ``grad_specs``: a tree of ``(mesh, placements)`` matching the params
    (the ``params`` subtree of ``train_shardings``' state). Each DTensor
    gradient is redistributed to its parameter's placements as autograd
    hands it over, so a gradient that comes out as a partial sum is synced
    by a reduce-scatter to the parameter's shard, not an all-reduce (the
    reference's constraint at the autodiff boundary)."""
    def train_step(state: Tree, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Tree, torch.Tensor]:
        loss, grads = loss_and_grads(model, state["params"], batch)
        if grad_specs is not None:
            grads = tree_map(_constrain, grads, grad_specs)
        with trace.span("step.optimizer"):
            params2, opt2 = adamw_update(state["params"], grads,
                                         state["opt"], opt_cfg)
        return {"params": params2, "opt": opt2}, loss
    return train_step


def _constrain(g: torch.Tensor, sharding: Tuple[DeviceMesh, Any]
               ) -> torch.Tensor:
    if not isinstance(g, DTensor):
        return g
    return g.redistribute(*sharding)


def train_state_shapes(model: LM, opt_cfg: AdamWConfig) -> Tree:
    ps = model.shapes()
    return {"params": ps, "opt": adamw_state_shapes(ps, opt_cfg)}


def train_state_axes(model: LM, opt_cfg: AdamWConfig) -> Tree:
    ax = model.logical_axes()
    return {"params": ax, "opt": adamw_state_axes(ax, opt_cfg)}


def train_shardings(model: LM, opt_cfg: AdamWConfig, mesh: DeviceMesh,
                    shape: ShapeSpec) -> Tuple[Tree, Tree]:
    """(state shardings, batch shardings) for this mesh: ``(mesh,
    placements)`` a leaf."""
    cfg = model.cfg
    with shd.use_mesh(mesh):
        st_specs = shd.specs_for_tree(train_state_axes(model, opt_cfg),
                                      train_state_shapes(model, opt_cfg),
                                      rules=rules_for(cfg, params=True))
        b_specs = shd.specs_for_tree(batch_logical_axes(cfg, shape),
                                     batch_specs(cfg, shape),
                                     rules=rules_for(cfg))
    return (shd.named_shardings(mesh, st_specs),
            shd.named_shardings(mesh, b_specs))


def place_tree(tree: Tree, shardings: Tree) -> Tree:
    """Lay out each leaf of ``tree`` as a DTensor by its ``(mesh,
    placements)`` in ``shardings`` (a tree of ``train_shardings`` or
    ``serve_shardings``: dicts, the optimizer's ``AdamWState``, ``None``
    where there is no subtree), a leaf at a time. A dict's entries are
    replaced in place, so the plain and the placed copies overlap by one
    leaf at most; a NamedTuple comes back anew around its placed subtrees.
    Under ``torch.inference_mode()`` the leaves are inference tensors, as
    the serve steps' outputs are."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        for k in tree:
            tree[k] = place_tree(tree[k], shardings[k])
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place_tree(t, sh)
                            for t, sh in zip(tree, shardings)))
    return distribute_tensor(tree, *shardings)


def init_train_state(model: LM, opt_cfg: AdamWConfig,
                     generator: torch.Generator,
                     device: Optional[torch.device] = None) -> Tree:
    """Random parameters from ``generator`` (which lives on ``device``) and
    a zero optimizer state."""
    params = model.init(generator, resolve_device(device))
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


# ---------------------------------------------------------------------------
# serving


def make_prefill_step(model: LM):
    @torch.inference_mode()
    def prefill_step(params: Tree, batch: Dict[str, torch.Tensor], cache: Tree
                     ) -> Tuple[torch.Tensor, Tree]:
        return model.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(model: LM):
    @torch.inference_mode()
    def decode_step(params: Tree, batch: Dict[str, torch.Tensor], cache: Tree,
                    pos: int) -> Tuple[torch.Tensor, Tree]:
        return model.decode_step(params, batch, cache, pos)
    return decode_step


def serve_shardings(model: LM, mesh: DeviceMesh, shape: ShapeSpec
                    ) -> Tuple[Tree, Tree, Tree]:
    """(param, batch, cache) shardings for a serve cell."""
    cfg = model.cfg
    rules = rules_for(cfg)
    b, s = shape.global_batch, shape.seq_len
    with shd.use_mesh(mesh):
        p_specs = shd.specs_for_tree(model.logical_axes(), model.shapes(),
                                     rules=rules_for(cfg, params=True))
        b_specs = shd.specs_for_tree(batch_logical_axes(cfg, shape),
                                     batch_specs(cfg, shape), rules=rules)
        c_specs = shd.specs_for_tree(model.cache_logical_axes(b, s),
                                     model.cache_shapes(b, s), rules=rules)
    return (shd.named_shardings(mesh, p_specs),
            shd.named_shardings(mesh, b_specs),
            shd.named_shardings(mesh, c_specs))
