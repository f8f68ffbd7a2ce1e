"""Wrapper of the CUDA max-plus kernel (``csrc/maxplus.cu``).

``C[i, j] = max(NEG_INF, max_k (A[i, k] + B[k, j]))`` over the (max, +)
semiring, in f32: static timing analysis is a longest path, a fixpoint of
max-plus relaxation, and the product tiles like a GEMM. It replaces the
Pallas TPU kernel of ``repro.kernels.maxplus``; the source's header gives
its bound on the card and its design.

``plan`` picks the tile and the K split from the shape and the SM count, on
the host: 128 x 128 tiles once they alone give every SM a block, else
64 x 64 tiles, with K split over up to ``SPLIT_BLOCKS_PER_SM`` blocks an SM
(a second kernel then takes the splits' max). ``maxplus_matmul.launches``
counts wrapper calls, ``maxplus_matmul.device_launches`` the kernels they
launched (two for a split call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.device import sm_count

from .. import _build
from .ref import NEG_INF, maxplus_matmul_plain

__all__ = ["NEG_INF", "maxplus_matmul", "plan"]

TILES = (128, 64)
K_STEP = 16                 # the kernel's K slice; a split is whole slices
SPLIT_BLOCKS_PER_SM = 4     # a split call aims at about this many blocks an SM
MIN_SPLIT_K = K_STEP        # a split reduces at least one slice of K


class Plan(NamedTuple):
    tile: int               # BM = BN of a block
    k_chunk: int            # K rows a split reduces, a multiple of K_STEP
    splits: int             # ceil(K / k_chunk); 1 writes C directly


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, n: int, k: int, sms: int, *, tile: Optional[int] = None,
         splits: Optional[int] = None) -> Plan:
    """Tile and K split of one call: 128 x 128 tiles when they give each of
    the ``sms`` SMs a block, else 64 x 64 tiles with K split so that the
    grid holds about ``SPLIT_BLOCKS_PER_SM`` blocks an SM, each split at
    least ``MIN_SPLIT_K`` deep. ``tile`` and ``splits`` override the choice
    (the card's checks run every choice through ``_launch``); ``splits`` is
    rounded so that each split is whole K slices and none is empty."""
    if tile is None:
        tile = 128 if _cdiv(m, 128) * _cdiv(n, 128) >= sms else 64
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    if splits is None:
        if tile == 128:
            splits = 1
        else:
            tiles = _cdiv(m, tile) * _cdiv(n, tile)
            splits = min(SPLIT_BLOCKS_PER_SM * sms // tiles,
                         _cdiv(k, MIN_SPLIT_K))
    if splits < 1:
        splits = 1
    k_chunk = _cdiv(_cdiv(k, splits), K_STEP) * K_STEP
    return Plan(tile, k_chunk, _cdiv(k, k_chunk))


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("maxplus")
    lib.maxplus_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
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
    padding does; NaN propagates. CPU tensors go to the plain version; CUDA
    tensors launch the kernel, and anything it does not take raises.
    """
    _check(a, b)
    if a.device.type == "cpu":
        return maxplus_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"maxplus_matmul runs on cuda or cpu, not {a.device}")
    (m, k), n = a.shape, b.shape[1]
    return _launch(a, b, plan(m, n, k, sm_count(a.device)))


def _launch(a: torch.Tensor, b: torch.Tensor, p: Plan) -> torch.Tensor:
    """The kernel on CUDA tensors that passed ``_check``, tiled and split as
    ``p`` says (the card's checks pass every choice, not only ``plan``'s)."""
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    work = (torch.empty((p.splits, m, n), dtype=torch.float32,
                        device=a.device) if p.splits > 1 else None)
    err = _kernel_lib().maxplus_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), m, n, k, p.tile,
        p.k_chunk, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"maxplus launch failed with CUDA error {err}")
    maxplus_matmul.launches += 1
    maxplus_matmul.device_launches += 1 + (p.splits > 1)
    return out


maxplus_matmul.launches = 0
maxplus_matmul.device_launches = 0
