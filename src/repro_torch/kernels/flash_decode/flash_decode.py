"""Wrapper of the CUDA flash-decode kernel (``csrc/flash_decode.cu``).

Single-token GQA decode attention in the serving cache layout
([B, KV, T, hd]): the kernel streams each sequence's cache once, keeps the
online-softmax state in f32 on chip and never writes scores to device memory.
It replaces the Pallas TPU kernel of ``repro.kernels.flash_decode``; the
source's header gives its bound on the card and its known limits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import flash_decode_ref

MAX_SMEM_BYTES = 232_448          # opt-in shared memory per block on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    lib.flash_decode_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.flash_decode_smem_bytes.restype = ctypes.c_longlong
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    return lib


def _check(q, k_cache, v_cache, lengths, bk):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, KV, G, hd], got {tuple(q.shape)}")
    b, kv, g, hd = q.shape
    t = k_cache.shape[2] if k_cache.dim() == 4 else -1
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if tuple(c.shape) != (b, kv, t, hd) or t < 1:
            raise ValueError(f"{name} must be [B, KV, T, hd] = "
                             f"[{b}, {kv}, T, {hd}], got {tuple(c.shape)}")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 [{b}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"q, k_cache, v_cache must share one dtype of "
                        f"{list(_DTYPES)}, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if hd % 8 or hd > 256:
        raise ValueError(f"head dim must be a multiple of 8 up to 256, got {hd}")
    if bk < 1:
        raise ValueError(f"bk must be positive, got {bk}")
    devices = {x.device for x in (q, k_cache, v_cache, lengths)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    if not all(x.is_contiguous() for x in (q, k_cache, v_cache, lengths)):
        raise ValueError("inputs must be contiguous")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 bk: int = 32) -> torch.Tensor:
    """One-token GQA decode attention, cache-layout native.

    q:        [B, KV, G, hd]   (new token's query, grouped by kv head)
    k_cache:  [B, KV, T, hd]
    v_cache:  [B, KV, T, hd]
    lengths:  [B]  int32       (per-sequence frontier; slots >= len masked)
    returns   [B, KV, G, hd]   in q's dtype (float32 or bfloat16)

    ``bk`` is the number of cache rows per shared-memory tile. The kernel
    keeps two stages of K and V tiles, so the TPU kernel's 256 would need
    512 KB of shared memory at f32 and hd=128; 32 fits f32 at hd=256 for
    groups of up to 46 query heads. A bk that does not fit raises.

    A length of 0 is outside the contract: the reference kernel and its plain
    version disagree there (padded vs unpadded average), and the model always
    passes lengths >= 1.

    CPU tensors go to the plain version; CUDA tensors launch the kernel, and
    anything it does not take raises.
    """
    _check(q, k_cache, v_cache, lengths, bk)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    b, kv, g, hd = q.shape
    if any(x.data_ptr() % 16 for x in (q, k_cache, v_cache)):
        raise ValueError("q, k_cache and v_cache must be 16-byte aligned")
    lib = _kernel_lib()
    smem = lib.flash_decode_smem_bytes(q.element_size(), g, hd, bk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"bk={bk} needs {smem} bytes of shared memory per "
                         f"block, more than {MAX_SMEM_BYTES}; use a smaller bk")
    out = torch.empty_like(q)
    err = lib.flash_decode_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, kv, g, k_cache.shape[2], hd, bk,
        1.0 / (hd ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed with CUDA error {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
