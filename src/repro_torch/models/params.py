"""Parameter definitions and initialisation.

Models declare their weights as a nested dict of ``ParamDef`` leaves (shape,
*logical* sharding axes, dtype, initializer). From one definition tree come:

* ``init_params``        — the tensors, drawn on a device;
* ``param_shapes``       — meta tensors of the same shapes and dtypes (no
                           allocation; the reference's ShapeDtypeStructs);
* ``param_logical_axes`` — the logical-axis tuples, resolved to placements
                           on a ``DeviceMesh`` by ``repro_torch.distributed``.

Per-layer weights are stacked along a leading layer axis, as in the JAX
package, and the model indexes one layer at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis names
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                      # normal | zeros | ones | const
    scale: float = 1.0                        # stddev multiplier / const value
    fan_in: Optional[int] = None              # None -> last-but-one dim

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def _init_leaf(d: ParamDef, generator: Optional[torch.Generator],
               device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "const":
        return torch.full(d.shape, d.scale, dtype=d.dtype, device=device)
    fan = d.fan_in
    if fan is None:
        fan = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / (fan ** 0.5)
    w = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(std).to(d.dtype)


def map_defs(fn: Callable[[ParamDef], Any], tree: Tree) -> Tree:
    return {k: map_defs(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_params(defs: Tree, generator: Optional[torch.Generator],
                device: torch.device) -> Tree:
    """Draw every leaf in f32 on ``device`` from ``generator``, then cast.

    ``generator`` must live on ``device`` (it may be None when no leaf is
    drawn at random, as in a cache). Leaves are drawn in the order of the
    definition dict, so a seed gives the same weights on every run.
    """
    return map_defs(lambda d: _init_leaf(d, generator, device), defs)


def param_shapes(defs: Tree) -> Tree:
    """Meta tensors of every leaf's shape and dtype; nothing is allocated."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def param_logical_axes(defs: Tree) -> Tree:
    return map_defs(lambda d: d.axes, defs)


def param_count(defs: Tree) -> int:
    total = 0
    for v in defs.values():
        if isinstance(v, dict):
            total += param_count(v)
        else:
            n = 1
            for s in v.shape:
                n *= s
            total += n
    return total
