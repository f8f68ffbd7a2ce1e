"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Blocked online-softmax attention, the forward of the no-cache attention in
training: the kernel keeps scores, the running max and denominator and the
accumulator on chip in f32 and never writes a score to device memory. It
replaces the Pallas TPU kernel of ``repro.kernels.flash_attention``; the
source's header gives its bound on the card and its known limits.

The reference has no backward kernel (no ``custom_vjp``) and its kernel
cannot be differentiated, so none is written here: on CUDA tensors the
kernel sits in a ``torch.autograd.Function`` whose backward recomputes the
plain version (``flash_attention_plain``) and differentiates that, a few
kv heads at a time so the [B, H, S, Skv] score tensors stay bounded.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import flash_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
# The backward recomputes the plain version for as many kv heads at once as
# keep one [B, heads, Sq, Skv] f32 tensor within this many elements (1 GiB);
# autograd of the plain version holds a handful of such tensors at a time.
BACKWARD_CHUNK_ELEMS = 2 ** 28


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, S, d], got {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, kv, skv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"shape mismatch {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kv}")
    if sq < 1 or skv < 1:
        raise ValueError(f"empty sequence: Sq={sq}, Skv={skv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of {list(_DTYPES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {x.device for x in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def _launch(q, k, v, causal) -> torch.Tensor:
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's 65535")
    es = q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        if x.data_ptr() % 16 or any(s * es % 16 for s in x.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides of "
                             f"whole 16-byte chunks, got {x.stride()}")
    lib = _kernel_lib()
    out = torch.empty_like(q)     # q's layout: [B, S, H, d] views stay so
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    err = lib.flash_attention_launch(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, h, kv, sq, skv, d, int(causal),
        1.0 / (d ** 0.5), strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    return out


def _plain_backward(q, k, v, do, causal):
    """Gradients of the plain version, a few kv heads at a time."""
    b, h, sq, _ = q.shape
    kv, skv = k.shape[1], k.shape[2]
    g = h // kv
    per_kv = max(1, BACKWARD_CHUNK_ELEMS // (b * g * sq * skv))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    for j0 in range(0, kv, per_kv):
        j1 = min(kv, j0 + per_kv)
        qc = q[:, j0 * g:j1 * g].detach().requires_grad_()
        kc = k[:, j0:j1].detach().requires_grad_()
        vc = v[:, j0:j1].detach().requires_grad_()
        with torch.enable_grad():
            o = flash_attention_plain(qc, kc, vc, causal=causal)
            gq, gk, gv = torch.autograd.grad(o, (qc, kc, vc),
                                             do[:, j0 * g:j1 * g])
        dq[:, j0 * g:j1 * g] = gq
        dk[:, j0:j1] = gk
        dv[:, j0:j1] = gv
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*_plain_backward(q, k, v, do, ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention over q [B, H, S, d] with k, v [B, KV, Skv, d].

    KV may be H (the reference's contract) or divide it: query head h then
    reads kv head h // (H // KV), the same function as repeating K and V.
    The causal mask is top left (``row >= col``), as in the Pallas kernel.
    Inputs may be strided views (the model passes its [B, S, H, d]
    activations transposed); the output has q's layout.

    Head dims 32, 64 and 128 in f32 or bf16. The tile is fixed at 64 query
    rows by 64 keys, so the reference's ``bq`` / ``bk`` options (its TPU tile
    of 128) are not taken.

    CPU tensors take the plain version, with ordinary autograd; CUDA tensors
    launch the kernel (backward through the plain version), and anything the
    kernel does not take raises.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _FlashAttention.apply(q, k, v, causal)


flash_attention.launches = 0
