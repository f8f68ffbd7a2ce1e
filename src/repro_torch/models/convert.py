"""Parameters of the JAX package as the port's parameters.

The reference's parameter tree (nested dicts of arrays, converted to numpy by
the caller) becomes the port's tree, name for name: ``embed.tok``,
``blocks.attn.wq`` and so on keep their paths, shapes and dtypes.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from .params import Tree


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    # numpy's bfloat16 (ml_dtypes) is unknown to torch.from_numpy: widen to
    # f32 and narrow back, which is exact.
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # a copy: the optimizer updates in place, and a CPU tensor made with
    # from_numpy would write through to the caller's array
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device, copy=True)


def params_from_reference(tree: Mapping[str, Any], device=None) -> Tree:
    """Nested dict of arrays -> the same nested dict of tensors on
    ``device``, each a copy of its array."""
    dev = resolve_device(device)
    return {k: params_from_reference(v, dev) if isinstance(v, Mapping)
            else _tensor(v, dev) for k, v in tree.items()}
