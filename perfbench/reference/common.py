"""Plain-PyTorch pieces shared by the reference models.

Everything here is written from the published descriptions, in float32,
with no kernel, cache manager or batching trick of the program under test;
it imports nothing of the program. ``Numerics`` selects the precision of
the matrix products: ``"f32"`` (the reference) or ``"fp8"`` (the control:
each operand of a product rounded to float8 e4m3 with a per-tensor scale,
the step below bfloat16 that a faster port would be tempted to take).

Parameters are stored at the dtype the configuration states (bfloat16, the
router in float32) and computed with in float32: ``Numerics.w`` upcasts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8 e4m3fn value


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, returned in float32; the gradient passes
    straight through."""
    d = x.detach()
    scale = FP8_MAX / d.abs().amax().clamp(min=1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - d)


@dataclass(frozen=True)
class Numerics:
    precision: str = "f32"           # "f32" | "fp8"

    def __post_init__(self):
        if self.precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {self.precision!r}")

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return fp8_round(x) if self.precision == "fp8" else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., K] @ w [K, N] in the chosen precision, f32 out."""
        return self._in(x) @ self._in(w)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
        return torch.einsum(eq, self._in(a), self._in(b))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in the rotate-half convention: x [B, S, H, hd],
    pos [S] absolute positions."""
    hd = x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (pos.to(torch.float64)[:, None] * inv[None]).float()
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    a, b = x[..., :half].float(), x[..., half:].float()
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(num: Numerics, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor
              ) -> torch.Tensor:
    """Causal grouped-query attention by position: q [B, S, H, hd] at
    positions q_pos [S], k and v [B, T, KV, hd] at k_pos [T]; query head h
    reads kv head h // (H / KV). One batch row at a time, to bound the
    memory of the full score matrix. Returns [B, S, H, hd] f32."""
    h, kv, hd = q.shape[2], k.shape[2], q.shape[3]
    allowed = k_pos[None, :] <= q_pos[:, None]                # [S, T]
    out = []
    for i in range(q.shape[0]):
        kk = k[i].float().repeat_interleave(h // kv, dim=1)   # [T, H, hd]
        vv = v[i].float().repeat_interleave(h // kv, dim=1)
        s = num.einsum("shd,thd->hst", q[i], kk) / math.sqrt(hd)
        s = s.masked_fill(~allowed, float("-inf"))
        out.append(num.einsum("hst,thd->shd", torch.softmax(s, dim=-1), vv))
    return torch.stack(out)


def swiglu(num: Numerics, x: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    return num.mm(F.silu(num.mm(x, w_gate)) * num.mm(x, w_up), w_down)


def lm_loss_row(num: Numerics, x: torch.Tensor, norm: torch.Tensor,
                w_out: torch.Tensor, labels: torch.Tensor, eps: float,
                z_loss: float) -> torch.Tensor:
    """Summed next-token NLL and summed z-loss term of one row: x [S, D]
    after the last layer, logits over the whole (padded) table."""
    logits = num.mm(rms_norm(x, norm, eps), w_out)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, labels[:, None]).squeeze(-1)
    return nll.sum() + z_loss * (lse * lse).sum()


# ---------------------------------------------------------------------------
# the optimizer: AdamW with global-norm clipping under a warmup-cosine
# schedule (Loshchilov & Hutter; the schedule's warmup is 1 % of the run)


@dataclass(frozen=True)
class AdamW:
    peak_lr: float = 3e-4
    total_steps: int = 100
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_frac: float = 0.01
    final_frac: float = 0.1

    def lr(self, step: int) -> float:
        """The rate of 1-based step ``step``."""
        warm = max(1, int(self.total_steps * self.warmup_frac))
        if step < warm:
            return self.peak_lr * step / warm
        prog = min(max((step - warm) / max(1, self.total_steps - warm), 0.0),
                   1.0)
        return (self.final_frac * self.peak_lr + (1 - self.final_frac)
                * self.peak_lr * 0.5 * (1 + math.cos(math.pi * prog)))


def adamw_step(opt: AdamW, step: int, params: List[torch.Tensor],
               grads: List[torch.Tensor], m: List[torch.Tensor],
               v: List[torch.Tensor]) -> List[torch.Tensor]:
    """One AdamW update of 1-based step ``step`` on f32 parameters, the
    gradients clipped to a global norm of ``clip_norm``; m and v updated in
    place. Returns the clipped gradients."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = torch.clamp(opt.clip_norm / norm.clamp(min=1e-9), max=1.0)
    lr = opt.lr(step)
    bc1, bc2 = 1 - opt.b1 ** step, 1 - opt.b2 ** step
    clipped = []
    with torch.no_grad():
        for p, g, mm, vv in zip(params, grads, m, v):
            g = g.float() * scale
            clipped.append(g)
            mm.mul_(opt.b1).add_((1 - opt.b1) * g)
            vv.mul_(opt.b2).add_((1 - opt.b2) * g * g)
            upd = (mm / bc1) / (torch.sqrt(vv / bc2) + opt.eps) \
                + opt.weight_decay * p
            p.sub_(lr * upd)
    return clipped


# ---------------------------------------------------------------------------
# parameter trees


def leaves(tree: Dict) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for v in tree.values():
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def leaf_names(tree: Dict, prefix: str = "") -> List[str]:
    out: List[str] = []
    for k, v in tree.items():
        out.extend(leaf_names(v, f"{prefix}{k}.") if isinstance(v, dict)
                   else [prefix + k])
    return out


def tree_map(fn: Callable, tree: Dict) -> Dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def layer(tree: Dict, i: int) -> Dict:
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@dataclass(frozen=True)
class Leaf:
    """One parameter or cache tensor as the benchmark makes it: shape,
    dtype, and its draw (``normal`` with standard deviation ``std``, or the
    constant ``value``)."""
    shape: tuple
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                  # normal | const
    std: float = 1.0
    value: float = 0.0


def normal(shape, fan_in: Optional[int] = None, scale: float = 1.0,
           dtype=torch.bfloat16) -> Leaf:
    fan = fan_in if fan_in is not None else shape[-2]
    return Leaf(tuple(shape), dtype, "normal", scale / math.sqrt(fan))


def const(shape, value: float, dtype=torch.bfloat16) -> Leaf:
    return Leaf(tuple(shape), dtype, "const", value=value)


def layout_numel(layout: Dict) -> int:
    """Elements of every tensor of a layout (a tree of ``Leaf``)."""
    return sum(layout_numel(v) if isinstance(v, dict) else math.prod(v.shape)
               for v in layout.values())


def layout_bytes(layout: Dict) -> int:
    """Bytes of every tensor of a layout."""
    return sum(layout_bytes(v) if isinstance(v, dict)
               else math.prod(v.shape) * v.dtype.itemsize
               for v in layout.values())
