"""Wrapper of the CUDA max-plus kernel (``csrc/maxplus.cu``).

``C[i, j] = max(NEG_INF, max_k (A[i, k] + B[k, j]))`` over the (max, +)
semiring, in f32: static timing analysis is a longest path, a fixpoint of
max-plus relaxation, and the product tiles like a GEMM. It replaces the
Pallas TPU kernel of ``repro.kernels.maxplus``; the source's header gives
its bound on the card and its design.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import NEG_INF, maxplus_matmul_plain

__all__ = ["NEG_INF", "maxplus_matmul"]


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("maxplus")
    lib.maxplus_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p])
    lib.maxplus_launch.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} x {tuple(b.shape)}")
    if 0 in a.shape or b.shape[1] == 0:
        raise ValueError(f"empty operand: {tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a and b must be float32, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a and b lie on different devices: {a.device}, "
                         f"{b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")


def maxplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[i, j] = max(NEG_INF, max_k (A[i, k] + B[k, j])).

    a [M, K], b [K, N], both float32 and contiguous; returns [M, N]. A masked
    k (the ragged edge) contributes nothing, as the TPU kernel's NEG_INF
    padding does. CPU tensors go to the plain version; CUDA tensors launch
    the kernel, and anything it does not take raises.
    """
    _check(a, b)
    if a.device.type == "cpu":
        return maxplus_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"maxplus_matmul runs on cuda or cpu, not {a.device}")
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    err = _kernel_lib().maxplus_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"maxplus launch failed with CUDA error {err}")
    maxplus_matmul.launches += 1
    return out


maxplus_matmul.launches = 0
