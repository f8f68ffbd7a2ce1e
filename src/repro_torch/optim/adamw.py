"""AdamW with global-norm clipping and optional int8 gradient compression
(error feedback).

Moments are f32 whatever the parameters' dtype, as in the reference, and
their logical axes are the parameters' (``adamw_state_axes``), so ZeRO-style
sharding falls out of the same rules that shard the weights;
``adamw_state_shapes`` gives the state as meta tensors.

``adamw_update`` updates the parameters, the moments and the error feedback
in place, leaf by leaf, where the reference returns new trees: at llama3-8b
width the moments alone are 8 bytes a parameter, and a second copy of them
would not fit beside the model on one card. Its arithmetic is the
reference's, in the reference's order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch

Tree = Dict[str, Any]


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    out: List[torch.Tensor] = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else [v])
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


class AdamWState(NamedTuple):
    step: torch.Tensor           # int32 scalar
    mu: Tree                     # first moment (f32)
    nu: Tree                     # second moment (f32)
    error: Optional[Tree]        # int8-compression error feedback (or None)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_compress: bool = False


def adamw_init(params: Tree, cfg: AdamWConfig) -> AdamWState:
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
    device = tree_leaves(params)[0].device
    err = tree_map(zeros32, params) if cfg.grad_compress else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros32, params),
                      nu=tree_map(zeros32, params), error=err)


def adamw_state_shapes(param_shapes: Tree, cfg: AdamWConfig) -> AdamWState:
    """The state's leaves as meta tensors, from the parameters' (meta)."""
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    err = tree_map(f32, param_shapes) if cfg.grad_compress else None
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=tree_map(f32, param_shapes),
                      nu=tree_map(f32, param_shapes), error=err)


def adamw_state_axes(param_axes: Tree, cfg: AdamWConfig) -> AdamWState:
    """Logical axes for the state tree: moments mirror the params."""
    ident = lambda t: tree_map(lambda a: a, t)
    err = ident(param_axes) if cfg.grad_compress else None
    return AdamWState(step=(), mu=ident(param_axes), nu=ident(param_axes),
                      error=err)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """(grads scaled to a global norm of at most max_norm, as f32; the norm)."""
    gnorm = global_norm(tree_leaves(grads))
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gnorm


def _compress_int8(g: torch.Tensor, err: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 quantize -> dequantize with error feedback (no randomness).

    The round trip models what would cross the wire in a bandwidth-compressed
    all-reduce; the residual is fed back next step."""
    g = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-9) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g - deq


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: AdamWState,
                 cfg: AdamWConfig) -> Tuple[Tree, AdamWState]:
    """One AdamW step, in place on ``params`` and ``state``'s trees.

    ``grads`` has the parameters' structure and dtypes. Returns the same
    parameter tree and a state with the new step count."""
    step = state.step + 1
    p_leaves = tree_leaves(params)
    g_leaves = tree_leaves(grads)
    if cfg.grad_compress:
        e_leaves = tree_leaves(state.error)
        deq = []
        for g, e in zip(g_leaves, e_leaves):
            d, e2 = _compress_int8(g, e)
            e.copy_(e2)
            deq.append(d)
        g_leaves = deq
    # clip_by_global_norm's arithmetic, but scaled leaf by leaf in the loop
    # below: its f32 copy of every gradient at once would take 4 bytes a
    # parameter beside the model
    scale = _clip_scale(global_norm(g_leaves), cfg.clip_norm)

    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    for p, g, m, v in zip(p_leaves, g_leaves, tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        update = update + cfg.weight_decay * p32
        p.copy_((p32 - lr * update).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu,
                              error=state.error)


def make_optimizer(name: str, total_steps: int = 10_000,
                   lr: float = 3e-4, **kw) -> AdamWConfig:
    from .schedules import cosine_schedule, wsd_schedule
    if name == "adamw_wsd":
        sched = wsd_schedule(lr, total_steps)
    else:
        sched = cosine_schedule(lr, total_steps)
    return AdamWConfig(lr=sched, **kw)
