"""Wrapper of the CUDA flash-decode kernel (``csrc/flash_decode.cu``).

Single-token GQA decode attention in the serving cache layout
([B, KV, T, hd]), split over the cache (flash-decoding): ``n_split`` blocks
share each (b, kv) pair's rows, each streams its chunk once and keeps its
online-softmax state in f32 on chip, and a second kernel combines the
partial states. No score reaches device memory. It replaces the Pallas TPU
kernel of ``repro.kernels.flash_decode``; the source's header gives its
bound on the card, its design and its known limits.

``plan`` sizes the grid on the host from the shapes and the SM count, never
from ``lengths`` (a device tensor: reading it would sync and break CUDA
graph capture). bf16 calls at head dims 16-128 with tiles of whole 16-row
units run on the tensor cores (mma.sync), the rest on CUDA cores.
``flash_decode.launches`` counts wrapper calls, ``tensor_core_launches`` and
``cuda_core_launches`` the same calls by route, ``lse_launches`` the calls in
the partial form (``return_lse=True``), and ``device_launches`` the kernels
they launched (two when the call was split).

The partial form returns each row's log-sum-exp beside the output, so that
the states of several cache shards (one a rank, when the cache's slots are
sharded over a mesh) combine as the kernel's own combine pass combines its
splits (``ops.merge_partials``, ``ops.merge_over_ranks``).

DTensors are refused: a wrapper on a DTensor would hand the kernel its null
``data_ptr()``. The model runs the kernel on each rank's shards through
``local_map`` (``models/layers.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.device import sm_count

from .. import _build, refuse_dtensors
from .ref import flash_decode_ref

MAX_SMEM_BYTES = 232_448          # opt-in shared memory per block on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' block: 4 consumer warps, a ring of at most 4 stages, 128
# bytes of barriers; 4 query heads on the CUDA cores, 16 (mma's M) on the
# tensor cores (csrc/flash_decode.cu: kWarps, kMaxStages, kBarBytes, kGB,
# kMmaHeads)
WARPS, MAX_STAGES, BAR_BYTES = 4, 4, 128
HEADS_PER_BLOCK = {False: 4, True: 16}
# the tensor-core kernel: bf16, these head dims, tiles of whole 16-row units
TENSOR_CORE_HEAD_DIMS = (16, 32, 64, 128)
SPLIT_BLOCKS_PER_SM = 2           # the most blocks an SM the split aims at


class Plan(NamedTuple):
    n_split: int                  # blocks a (b, kv, group of heads)
    stages: int                   # K/V tiles in flight per block
    smem: int                     # dynamic shared memory a block, bytes
    tensor_cores: bool            # the bf16 mma kernel, else CUDA cores


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tensor_cores(elem_size: int, hd: int, bk: int) -> bool:
    """Whether a call takes the tensor-core kernel: bf16, a head dim it
    takes, tiles of whole 16-row units."""
    return elem_size == 2 and hd in TENSOR_CORE_HEAD_DIMS and bk % 16 == 0


def smem_bytes(elem_size: int, hd: int, bk: int, stages: int,
               tensor_cores: bool = False) -> int:
    """A block's shared memory: barriers, the ring of K and V tiles, and the
    four warps' f32 states for the merge at the end of its chunk (the
    tensor-core kernel keeps them in the drained ring). The launch takes
    this size as the block's dynamic shared memory."""
    ring = 2 * stages * bk * hd * elem_size
    red = WARPS * HEADS_PER_BLOCK[tensor_cores] * (hd + 2) * 4
    return BAR_BYTES + (max(ring, red) if tensor_cores else ring + red)


@functools.lru_cache(maxsize=256)
def plan(b: int, kv: int, g: int, t: int, hd: int, elem_size: int, bk: int,
         sms: int, n_split: Optional[int] = None) -> Plan:
    """The split of a call, then as many ring stages (up to 4) as a split's
    tiles and shared memory allow. ``n_split`` overrides the split count.
    Raises if one stage does not fit.

    The split count: as many as put at most ``SPLIT_BLOCKS_PER_SM`` blocks
    on each of the ``sms`` SMs, and no more than the cache has tiles of
    ``bk`` rows. Memory-bound blocks that share an SM share its bandwidth,
    so a ragged wave costs: 9 splits of 32 (b, kv) pairs put 3 blocks on
    some SMs and 2 on the rest, and the call takes as long as the SMs with
    3 (``chip_smoke.py`` times the counts around the plan's)."""
    tc = tensor_cores(elem_size, hd, bk)
    blocks = b * kv * _cdiv(g, HEADS_PER_BLOCK[tc])
    tiles = _cdiv(t, bk)
    if n_split is None:
        n_split = max(1, min(tiles, SPLIT_BLOCKS_PER_SM * sms // blocks))
    if not 1 <= n_split <= 65535:
        raise ValueError(f"n_split must be in [1, 65535], got {n_split}")
    split_tiles = _cdiv(_cdiv(t, n_split), bk)
    stages = min(MAX_STAGES, split_tiles)
    while stages >= 1 and smem_bytes(elem_size, hd, bk, stages,
                                     tc) > MAX_SMEM_BYTES:
        stages -= 1
    if stages < 1:
        raise ValueError(f"bk={bk} needs {smem_bytes(elem_size, hd, bk, 1, tc)}"
                         f" bytes of shared memory per block, more than "
                         f"{MAX_SMEM_BYTES}; use a smaller bk")
    return Plan(n_split, stages, smem_bytes(elem_size, hd, bk, stages, tc), tc)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
        + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    return lib


def _check(q, k_cache, v_cache, lengths, bk):
    refuse_dtensors("flash_decode", q, k_cache, v_cache, lengths)
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
                 bk: int = 32, return_lse: bool = False
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token GQA decode attention, cache-layout native.

    q:        [B, KV, G, hd]   (new token's query, grouped by kv head)
    k_cache:  [B, KV, T, hd]
    v_cache:  [B, KV, T, hd]
    lengths:  [B]  int32       (per-sequence frontier; slots >= len masked)
    returns   [B, KV, G, hd]   in q's dtype (float32 or bfloat16); with
              ``return_lse`` (the partial form, whose states over several
              cache shards ``ops.merge_partials`` combines) the output in
              f32, so that a merge rounds once, and each row's log-sum-exp
              [B, KV, G] in f32 (natural log of sum_t exp(q.k_t / sqrt(hd))
              over the slots below the frontier).

    ``bk`` is the number of cache rows a shared-memory tile holds; a block
    keeps up to four tiles of K and V in flight, fewer where shared memory
    is short, and a bk whose single stage does not fit raises.

    A length of 0 (a cache shard wholly past the frontier) gives output 0
    and lse -inf. (The reference kernel and its plain version disagree there,
    padded vs unpadded average; the model's whole cache always has lengths
    >= 1.)

    CPU tensors go to the plain version; CUDA tensors launch the kernel, and
    anything it does not take (a DTensor included) raises.
    """
    _check(q, k_cache, v_cache, lengths, bk)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, lengths,
                                return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    b, kv, g, hd = q.shape
    return _launch(q, k_cache, v_cache, lengths, bk,
                   plan(b, kv, g, k_cache.shape[2], hd, q.element_size(), bk,
                        sm_count(q.device)), return_lse)


def _launch(q, k_cache, v_cache, lengths, bk: int, p: Plan,
            return_lse: bool = False):
    """The kernels on CUDA tensors that passed ``_check``, split as ``p``
    says (the card's checks pass other plans than ``plan``'s choice)."""
    b, kv, g, hd = q.shape
    if any(x.data_ptr() % 16 for x in (q, k_cache, v_cache)):
        raise ValueError("q, k_cache and v_cache must be 16-byte aligned")
    lib = _kernel_lib()
    out = torch.empty_like(q, dtype=torch.float32 if return_lse else None)
    lse = (torch.empty((b, kv, g), dtype=torch.float32, device=q.device)
           if return_lse else None)
    part_ml = part_acc = None
    if p.n_split > 1:
        part_ml = torch.empty((b * kv, p.n_split, g, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((b * kv, p.n_split, g, hd),
                               dtype=torch.float32, device=q.device)
    err = lib.flash_decode_launch(
        _DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(),
        None if part_acc is None else part_acc.data_ptr(),
        b, kv, g, k_cache.shape[2], hd, bk, p.n_split, p.stages,
        int(p.tensor_cores), p.smem, math.log2(math.e) / math.sqrt(hd),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed with CUDA error {err}")
    flash_decode.launches += 1
    flash_decode.device_launches += 1 + (p.n_split > 1)
    if p.tensor_cores:
        flash_decode.tensor_core_launches += 1
    else:
        flash_decode.cuda_core_launches += 1
    if lse is None:
        return out
    flash_decode.lse_launches += 1
    return out, lse


flash_decode.launches = 0
flash_decode.lse_launches = 0
flash_decode.device_launches = 0
flash_decode.tensor_core_launches = 0
flash_decode.cuda_core_launches = 0
