"""Step functions for serving."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import LM
from repro_torch.models.params import Tree


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
