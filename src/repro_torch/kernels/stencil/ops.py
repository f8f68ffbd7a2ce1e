"""Public stencil ops of the dense-app examples.

``gaussian_blur`` / ``sharpen`` / ``sobel_mag2`` mirror the CGRA benchmark
apps; they are the golden compute the apps' functional simulation is
checked against. The tensor's device chooses kernel or plain version.
"""

from __future__ import annotations

import torch

from .ref import stencil3x3_ref
from .stencil import stencil3x3

GAUSS3 = torch.tensor([[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]]) / 16.0
SHARPEN3 = torch.tensor([[0., -1., 0.], [-1., 5., -1.], [0., -1., 0.]])
SOBEL_X3 = torch.tensor([[-1., 0., 1.], [-2., 0., 2.], [-1., 0., 1.]])
SOBEL_Y3 = torch.tensor([[-1., -2., -1.], [0., 0., 0.], [1., 2., 1.]])


def gaussian_blur(x: torch.Tensor) -> torch.Tensor:
    return stencil3x3(x, GAUSS3)


def sharpen(x: torch.Tensor) -> torch.Tensor:
    return stencil3x3(x, SHARPEN3)


def sobel_mag2(x: torch.Tensor) -> torch.Tensor:
    """Squared gradient magnitude (Harris corner ingredient)."""
    gx = stencil3x3(x, SOBEL_X3)
    gy = stencil3x3(x, SOBEL_Y3)
    return gx * gx + gy * gy


__all__ = ["stencil3x3", "stencil3x3_ref", "gaussian_blur", "sharpen",
           "sobel_mag2", "GAUSS3", "SHARPEN3", "SOBEL_X3", "SOBEL_Y3"]
