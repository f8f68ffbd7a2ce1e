"""Plain PyTorch version of the 3x3 stencil kernel (the tests' oracle)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stencil3x3_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same-padded 3x3 correlation (zero boundary), the nine terms summed
    in (dy, dx) order from 0."""
    h, width = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    w = w.to(x.dtype)
    acc = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            acc = acc + w[dy, dx] * xp[dy:dy + h, dx:dx + width]
    return acc
