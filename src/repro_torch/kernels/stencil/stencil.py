"""Wrapper of the CUDA 3x3 stencil kernel (``csrc/stencil.cu``).

Same-padded 3x3 correlation of an [H, W] f32 image: the dense CGRA apps'
golden compute. It replaces the Pallas TPU kernel of
``repro.kernels.stencil``; the source's header gives its bound on the card
and its design.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import stencil3x3_ref

__all__ = ["stencil3x3"]


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("stencil")
    lib.stencil3x3_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p]
    lib.stencil3x3_launch.restype = ctypes.c_int
    return lib


def stencil3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same-padded 3x3 correlation of a [H, W] image with a [3, 3] kernel.

    CPU tensors go to the plain version. A CUDA ``x`` launches the kernel,
    which takes contiguous float32 only and raises on anything else; ``w``
    may lie anywhere (its nine values are launch arguments: keep it on the
    CPU to avoid a device-to-host copy).
    """
    if x.dim() != 2 or tuple(w.shape) != (3, 3):
        raise ValueError(f"bad shapes {tuple(x.shape)}, {tuple(w.shape)}")
    if x.device.type == "cpu":
        return stencil3x3_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"stencil3x3 runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the stencil kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    h, width = x.shape
    if h == 0 or width == 0:
        raise ValueError(f"empty image {tuple(x.shape)}")
    weights = (ctypes.c_float * 9)(*w.detach().to(torch.float32)
                                   .reshape(9).tolist())
    out = torch.empty_like(x)
    err = _kernel_lib().stencil3x3_launch(
        x.data_ptr(), out.data_ptr(), h, width, weights,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stencil3x3 launch failed with CUDA error {err}")
    stencil3x3.launches += 1
    return out


stencil3x3.launches = 0
