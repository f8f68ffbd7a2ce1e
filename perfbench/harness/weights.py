"""Weights and caches made from the seed on the device, in a few large
calls: every drawn leaf of one dtype is a view of one buffer, filled by one
``normal_`` from a ``torch.Generator`` on the device, then scaled leaf by
leaf (a stacked leaf holds all layers); constant leaves are filled. Leaves
come in the dtype they are served in. The same seed and layout give the
same tensors, so the reference can make them again after the program's run.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from reference.common import Leaf

from .traffic import torch_seed


def items(tree: Dict, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from items(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _rebuild(tree: Dict, made: Dict[str, torch.Tensor], prefix: str = ""
             ) -> Dict:
    return {k: _rebuild(v, made, f"{prefix}{k}.") if isinstance(v, dict)
            else made[prefix + k] for k, v in tree.items()}


def make(layout: Dict, seed: int, stream: int, device) -> Dict:
    """The tensors of ``layout`` (a tree of ``Leaf``) drawn from (seed,
    stream) on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, stream))
    made: Dict[str, torch.Tensor] = {}
    drawn = [(n, l) for n, l in items(layout) if l.init == "normal"]
    for dtype in sorted({l.dtype for _, l in drawn}, key=str):
        group = [(n, l) for n, l in drawn if l.dtype == dtype]
        total = sum(math.prod(l.shape) for _, l in group)
        buf = torch.empty(total, dtype=dtype, device=device)
        buf.normal_(generator=gen)
        off = 0
        for name, leaf in group:
            n = math.prod(leaf.shape)
            view = buf[off:off + n].view(leaf.shape)
            if leaf.std != 1.0:
                view.mul_(leaf.std)
            made[name] = view
            off += n
    for name, leaf in items(layout):
        if leaf.init == "const":
            made[name] = torch.full(leaf.shape, leaf.value, dtype=leaf.dtype,
                                    device=device)
        elif leaf.init != "normal":
            raise ValueError(f"{name}: unknown draw {leaf.init!r}")
    return _rebuild(layout, made)


def check_layout(made: Dict, want: Dict, what: str) -> None:
    """Refuse tensors whose names, shapes or dtypes differ from the
    program's (``want``: meta tensors)."""
    got = {n: (tuple(t.shape), t.dtype) for n, t in items(made)}
    exp = {n: (tuple(t.shape), t.dtype) for n, t in items(want)}
    if got != exp:
        diff = sorted(set(got.items()) ^ set(exp.items()))
        raise ValueError(f"the benchmark's {what} differ from the program's: "
                         f"{diff[:6]}")


__all__ = ["Leaf", "make", "check_layout", "items"]
