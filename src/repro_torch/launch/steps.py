"""Step functions for training and serving.

One device, so the reference's sharding trees (``rules_for``,
``train_shardings``, ``serve_shardings``) and its jit are left out: the
steps run eagerly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.models.params import Tree
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map


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
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model: LM, opt_cfg: AdamWConfig):
    """``train_step(state, batch) -> (state, loss)``: the loss and its
    gradients, then one AdamW update. The state's tensors are updated in
    place (see ``optim.adamw``); the returned state holds the same tensors
    and the new step count."""
    def train_step(state: Tree, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Tree, torch.Tensor]:
        loss, grads = loss_and_grads(model, state["params"], batch)
        params2, opt2 = adamw_update(state["params"], grads, state["opt"],
                                     opt_cfg)
        return {"params": params2, "opt": opt2}, loss
    return train_step


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
