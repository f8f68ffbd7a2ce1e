"""Wrapper of the CUDA flash-attention kernels.

Blocked online-softmax attention, the forward of the no-cache attention in
training: the kernels keep scores, the running max and denominator and the
accumulator on chip in f32 and never write a score to device memory. They
replace the Pallas TPU kernel of ``repro.kernels.flash_attention``, by dtype:

* bf16 (the training path): ``csrc/flash_attention_wgmma.cu``, on the
  tensor cores (TMA loads, wgmma products, a warp-specialised block);
* f32: ``csrc/flash_attention_tf32.cu``, on the tensor cores in 3xTF32
  (each operand split into tf32 hi and lo, each product taken as lo.hi +
  hi.lo + hi.hi in f32: the same function as f32 FMAs to within f32's
  rounding; TMA loads, wgmma for Q K^T, mma.sync for P V).

Each source's header gives its bound on the card and its design. Both
routes share their tiling of the grid (128 query rows a block, on the grid's
y axis) and take TMA tensor maps. Both are counted:
``flash_attention.launches`` in all, and ``bf16_launches`` /
``tf32_launches`` by route.

Both take a query-row offset ``q_off`` for the causal mask: on a mesh whose
ranks each hold a slice of a sequence's rows, a rank's row r is the
sequence's row q_off + r. DTensors are refused (their ``data_ptr()`` is 0):
the model runs the kernel on each rank's shards through ``local_map``
(``models/layers.py`` ``_local_attention``).

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

from ... import trace
from .. import _build, refuse_dtensors
from .ref import flash_attention_plain

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = tuple(range(16, 129, 16))   # 16, 32, ..., 128
# Query rows a block of either kernel: q tiles run on the grid's y axis,
# B*H on x.
BQ = 128
GRID_Y_MAX, GRID_X_MAX = 65535, 2 ** 31 - 1
# A TMA tensor map takes byte strides below 2^40 and dims up to 2^32.
TMA_STRIDE_LIMIT, TMA_DIM_LIMIT = 2 ** 40, 2 ** 32
# The backward recomputes the plain version for as many kv heads at once as
# keep one [B, heads, Sq, Skv] f32 tensor within this many elements (1 GiB);
# autograd of the plain version holds a handful of such tensors at a time.
BACKWARD_CHUNK_ELEMS = 2 ** 28


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    for fn in (lib.flash_attention_bf16_launch,
               lib.flash_attention_tf32_launch):
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, q_off=0):
    refuse_dtensors("flash_attention", q, k, v)
    if not isinstance(q_off, int) or q_off < 0:
        raise ValueError(f"q_off must be an int >= 0, got {q_off!r}")
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
        raise TypeError(f"q, k, v must share one dtype of {_DTYPES}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {x.device for x in (q, k, v)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")


def _check_launch(q, k, v, q_off=0):
    """What only the kernels refuse, raised before any library is built."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {d}")
    if -(-sq // BQ) > GRID_Y_MAX or b * h > GRID_X_MAX:
        raise ValueError(f"{-(-sq // BQ)} q tiles x B*H = {b * h} exceed "
                         f"the grid's {GRID_Y_MAX} x {GRID_X_MAX}")
    es = q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        if x.data_ptr() % 16 or any(s * es % 16 for s in x.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides of "
                             f"whole 16-byte chunks, got {x.stride()}")
        if (any(s * es >= TMA_STRIDE_LIMIT for s in x.stride()[:3])
                or max(x.shape[:3]) > TMA_DIM_LIMIT):
            raise ValueError(f"{name}'s strides {x.stride()} or shape "
                             f"{tuple(x.shape)} exceed a TMA tensor map's "
                             f"limits (strides below 2^40 bytes)")
    if max(q_off + sq, skv) >= 2 ** 31:
        raise ValueError(f"sequence lengths {q_off} + {sq}, {skv} exceed "
                         f"int32")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(q, k, v, causal, q_off=0) -> torch.Tensor:
    """One kernel launch, chosen by dtype: bf16 or f32 (3xTF32), both on the
    tensor cores."""
    _check_launch(q, k, v, q_off)
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    lib = _kernel_lib()
    out = torch.empty_like(q)     # q's layout: [B, S, H, d] views stay so
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    bf16 = q.dtype == torch.bfloat16
    fn = (lib.flash_attention_bf16_launch if bf16
          else lib.flash_attention_tf32_launch)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
             kv, sq, skv, d, int(causal), q_off, 1.0 / (d ** 0.5), strides,
             _stream(q.device))
    if err == -1:
        raise RuntimeError("flash_attention: the CUDA driver has no "
                           "cuTensorMapEncodeTiled")
    if err <= -1000:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled refused "
                           f"a tensor map with CUresult {-1000 - err}")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err}")
    flash_attention.launches += 1
    if bf16:
        flash_attention.bf16_launches += 1
    else:
        flash_attention.tf32_launches += 1
    return out


def _plain_backward(q, k, v, do, causal, q_off=0):
    """Gradients of the plain version, a few kv heads at a time."""
    with trace.span("attention.backward"):
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
                o = flash_attention_plain(qc, kc, vc, causal=causal,
                                          q_off=q_off)
                gq, gk, gv = torch.autograd.grad(o, (qc, kc, vc),
                                                 do[:, j0 * g:j1 * g])
            dq[:, j0 * g:j1 * g] = gq
            dk[:, j0:j1] = gk
            dv[:, j0:j1] = gv
        return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_off):
        ctx.args = (causal, q_off)
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, causal, q_off)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*_plain_backward(q, k, v, do, *ctx.args), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_off: int = 0) -> torch.Tensor:
    """Attention over q [B, H, S, d] with k, v [B, KV, Skv, d].

    KV may be H (the reference's contract) or divide it: query head h then
    reads kv head h // (H // KV), the same function as repeating K and V.
    The causal mask is top left (``row >= col``), as in the Pallas kernel,
    with q's row r at key row ``q_off + r`` (``q_off`` >= 0: q holds rows
    q_off to q_off + S of a longer sequence). Inputs may be strided views
    (the model passes its [B, S, H, d] activations transposed); the output
    has q's layout.

    Head dims 16 to 128 in steps of 16 (``HEAD_DIMS``: zamba2's 80
    included), in f32 or bf16, with no padded copy. The tiles are fixed
    (bf16: 128 query rows by 128 keys; f32: 128 by 64), so the reference's
    ``bq`` / ``bk`` options are not taken.

    CPU tensors take the plain version, with ordinary autograd; CUDA tensors
    launch the kernel (backward through the plain version), and anything the
    kernel does not take (a DTensor included) raises.
    """
    _check(q, k, v, q_off)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_off=q_off)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _FlashAttention.apply(q, k, v, causal, q_off)


flash_attention.launches = 0
flash_attention.bf16_launches = 0
flash_attention.tf32_launches = 0
