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
cannot be differentiated. On CUDA tensors the kernel sits in a
``torch.autograd.Function`` whose backward is chosen by dtype and device:

* bf16 on CUDA: ``csrc/flash_attention_bwd.cu``, on the tensor cores. The
  forward's launch then also writes the row log-sum-exp and the output's
  low half (``_launch``'s ``for_backward``); the backward recomputes P from
  them, tile by tile, in three kernels: dQ (which first takes D = rowsum(dO o O)), then
  dK and dV, each summing the group's query heads. Counted:
  ``flash_attention.bwd_launches`` (a call, three kernels).
* anything else (f32, and CPU tensors that tests route through the
  Function): ``_plain_backward`` recomputes the plain version
  (``flash_attention_plain``) and differentiates that, a few kv heads at a
  time so the [B, H, S, Skv] score tensors stay bounded.

Both run inside the ``attention.backward`` span, once a call; under
``trace.counting()`` each call adds 1 to ``attention.backward_kernel`` or
``attention.backward_plain``.
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
# Query rows a block of either forward kernel (and keys a block of the
# backward's dK and dV): tiles run on the grid's y axis, B*H on x.
BQ = 128
GRID_Y_MAX, GRID_X_MAX = 65535, 2 ** 31 - 1
# A TMA tensor map takes byte strides below 2^40 and dims up to 2^32.
TMA_STRIDE_LIMIT, TMA_DIM_LIMIT = 2 ** 40, 2 ** 32
# The plain backward recomputes the plain version for as many kv heads at
# once as keep one [B, heads, Sq, Skv] f32 tensor within this many elements
# (1 GiB); autograd of the plain version holds a handful of such tensors at
# a time.
BACKWARD_CHUNK_ELEMS = 2 ** 28


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    tail = [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    for fn in (lib.flash_attention_bf16_launch,
               lib.flash_attention_tf32_launch):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + tail
    lib.flash_attention_bf16_lse_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + tail)
    lib.flash_attention_bf16_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + tail)
    for fn in (lib.flash_attention_bf16_launch, lib.flash_attention_tf32_launch,
               lib.flash_attention_bf16_lse_launch,
               lib.flash_attention_bf16_bwd_launch):
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


def _check_backward(q, k):
    """What only the backward kernels refuse beside the forward's checks:
    dK's and dV's key tiles of 128 on the grid's y axis."""
    if -(-k.shape[2] // BQ) > GRID_Y_MAX:
        raise ValueError(f"Skv = {k.shape[2]}: key tiles of {BQ} past the "
                         f"backward kernels' grid of {GRID_Y_MAX}")


def _padded(sq: int) -> int:
    """Rows of the log-sum-exp a head: every row of every 128-row tile."""
    return -(-sq // BQ) * BQ


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _strides(*xs) -> ctypes.Array:
    """The batch, head and row strides of each tensor, in order."""
    return (ctypes.c_longlong * (3 * len(xs)))(
        *(s for x in xs for s in x.stride()[:3]))


def _raise_for(err: int, what: str = "launch") -> None:
    if err == -1:
        raise RuntimeError("flash_attention: the CUDA driver has no "
                           "cuTensorMapEncodeTiled")
    if err <= -1000:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled refused "
                           f"a tensor map with CUresult {-1000 - err}")
    if err != 0:
        raise RuntimeError(f"flash_attention {what} failed with CUDA error "
                           f"{err}")


def _launch(q, k, v, causal, q_off=0, *, for_backward=False):
    """One kernel launch, chosen by dtype: bf16 or f32 (3xTF32), both on the
    tensor cores. Returns the output; with ``for_backward`` (bf16 only, the
    training forward) also what the backward kernels read: the output's
    low half, bf16(o - bf16(o)), and the row log-sum-exp in log2 units of
    the scaled scores, over every row of every 128-row tile: bf16 [B, H,
    Sq', d] in the kernel's fragment order (``csrc/flash_attention_wgmma.cu``
    ``Params``) and f32 [B, H, Sq'], Sq' = Sq padded to 128."""
    _check_launch(q, k, v, q_off)
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    lib = _kernel_lib()
    out = torch.empty_like(q)     # q's layout: [B, S, H, d] views stay so
    bf16 = q.dtype == torch.bfloat16
    args = (b, h, kv, sq, skv, d, int(causal), q_off, 1.0 / (d ** 0.5),
            _strides(q, k, v, out), _stream(q.device))
    if for_backward:
        _check_backward(q, k)
        o_lo = torch.empty(b, h, _padded(sq), d, dtype=torch.bfloat16,
                           device=q.device)
        lse = torch.empty(b, h, _padded(sq), dtype=torch.float32,
                          device=q.device)
        err = lib.flash_attention_bf16_lse_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            o_lo.data_ptr(), lse.data_ptr(), *args)
    else:
        fn = (lib.flash_attention_bf16_launch if bf16
              else lib.flash_attention_tf32_launch)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *args)
    _raise_for(err)
    flash_attention.launches += 1
    if bf16:
        flash_attention.bf16_launches += 1
    else:
        flash_attention.tf32_launches += 1
    return (out, o_lo, lse) if for_backward else out


def _tma_ready(x) -> bool:
    """Whether a bf16 tensor can be read through a tensor map as it is."""
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(s > 0 and s * 2 % 16 == 0 for s in x.stride()[:3]))


def _kernel_backward(q, k, v, o, o_lo, lse, do, causal, q_off=0):
    """Gradients of the bf16 kernel's function by the backward kernels."""
    with trace.span("attention.backward"):
        b, h, sq, d = q.shape
        kv, skv = k.shape[1], k.shape[2]
        if not _tma_ready(do):
            do = do.contiguous()
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        dsum = torch.empty_like(lse)
        err = _kernel_lib().flash_attention_bf16_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            o_lo.data_ptr(), do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kv, sq, skv, d,
            int(causal), q_off, 1.0 / (d ** 0.5),
            _strides(q, k, v, o, do, dq, dk, dv), _stream(q.device))
        _raise_for(err, "backward")
        flash_attention.bwd_launches += 1
        return dq, dk, dv


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
    """The kernel with a backward: bf16 CUDA inputs that need a gradient
    take the backward kernels, everything else the plain backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_off):
        ctx.args = (causal, q_off)
        if (q.is_cuda and q.dtype == torch.bfloat16
                and any(ctx.needs_input_grad[:3])):
            out, o_lo, lse = _launch(q, k, v, causal, q_off,
                                     for_backward=True)
            ctx.save_for_backward(q, k, v, out, o_lo, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, causal, q_off)

    @staticmethod
    def backward(ctx, do):
        saved = ctx.saved_tensors
        kernel = len(saved) == 6
        if trace.counting_on():
            trace.count("attention.backward_kernel" if kernel
                        else "attention.backward_plain", 1)
        grads = (_kernel_backward(*saved, do, *ctx.args) if kernel
                 else _plain_backward(*saved, do, *ctx.args))
        return (*grads, None, None)


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
    launch the kernel (backward: the bf16 kernels, or the plain version in
    f32), and anything the kernel does not take (a DTensor included)
    raises.
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
flash_attention.bwd_launches = 0
