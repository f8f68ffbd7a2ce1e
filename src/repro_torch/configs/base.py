"""Model / shape configuration dataclasses for the assigned architectures.

A framework-free copy of the JAX package's ``configs/base.py``: the port
imports nothing of that package, so it carries its own.

Every architecture in the public pool becomes a frozen ``ModelConfig``.  The
config captures *exactly* the numbers in the assignment table; anything the
table does not pin down (rope theta, norm eps, chunk sizes, ...) is an
explicit field here so experiments can vary it.

``ShapeSpec`` describes one of the four assigned input shapes.  A (config,
shape) pair is one dry-run "cell".
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

# whisper's stub encoder memory: a fixed 1500 frames (the reference's
# ``LM.frames_len``)
AUDIO_FRAMES = 1500

# ---------------------------------------------------------------------------
# helpers


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# model config


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # -- attention ----------------------------------------------------------
    head_dim: int = 0                # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    causal: bool = True

    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_layer_period: int = 1        # 1 = every layer is MoE (if num_experts>0)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- SSM / RWKV ---------------------------------------------------------
    ssm_state: int = 0               # mamba2 d_state
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    chunk_size: int = 32             # chunked linear-attention / SSD chunk

    # -- hybrid (zamba2) ----------------------------------------------------
    shared_attn_every: int = 0       # insert the shared attn block every N layers

    # -- VLM ----------------------------------------------------------------
    cross_attn_every: int = 0        # a cross-attn block after every N self layers
    num_image_tokens: int = 0        # stub frontend: precomputed patch embeddings

    # -- encoder/decoder (whisper) ------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    decoder_frac: int = 4            # decoder_len = seq_len // decoder_frac

    # -- numerics / training -------------------------------------------------
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    z_loss: float = 1e-4

    # -- sharding / performance knobs -----------------------------------------
    # The sharding knobs choose the rules ``launch.steps.rules_for`` resolves
    # on a DeviceMesh; the reference's ``attn_shard`` and ``scan_layers`` are
    # left out (nothing reads the first, and the port loops over layers).
    fsdp: bool = False               # shard params over the data axis too (ZeRO-3)
    remat: str = "full"              # "none" | "full" | "dots" — per-layer remat
    sharding_profile: str = "tp"     # "tp" (Megatron TP over model) | "dp"
                                     # (pure data parallel; model axis joins
                                     # batch) | "zero3cp"
    sequence_parallel: bool = False  # shard residual seq axis over "model"
    decode_cache_shard: str = "head_dim"   # "head_dim" | "seq"
    use_flash: bool = False          # the flash_decode / flash_attention kernels
    attn_impl: str = "auto"          # "auto" | "einsum" | "blockwise" | "flash"
    optimizer: str = "adamw"         # "adamw" | "adamw_wsd"
    grad_compress: bool = False      # int8 gradient compression (opt-in)

    # -------------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 256)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # -- parameter counting (used for MODEL_FLOPS = 6*N*D) -------------------

    def _attn_params(self, d: int, heads: int, kv: int, hd: int) -> int:
        q = d * heads * hd + (heads * hd if self.qkv_bias else 0)
        k = d * kv * hd + (kv * hd if self.qkv_bias else 0)
        v = d * kv * hd + (kv * hd if self.qkv_bias else 0)
        o = heads * hd * d
        return q + k + v + o

    def _mlp_params(self, d: int, ff: int, gated: bool = True) -> int:
        return d * ff * (3 if gated else 2)

    def _rwkv_layer_params(self) -> int:
        d = self.d_model
        # time-mix: r,k,v,g,o projections + decay/bonus + token-shift loras
        tm = 5 * d * d + 2 * d + 2 * (d * 64 + 64 * d)
        # channel-mix: k (d->ff), v (ff->d), r (d->d)
        cm = d * self.d_ff + self.d_ff * d + d * d
        return tm + cm

    def _mamba_layer_params(self) -> int:
        d, di, st = self.d_model, self.d_inner, self.ssm_state
        in_proj = d * (2 * di + 2 * st + self.ssm_heads)
        conv = (di + 2 * st) * self.ssm_conv_width
        out = di * d
        extra = 2 * self.ssm_heads + di  # A_log, D, norm
        return in_proj + conv + out + extra

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n = emb
        if self.family == "ssm":            # rwkv6
            n += self.num_layers * self._rwkv_layer_params()
        elif self.family == "hybrid":       # zamba2: mamba stack + one shared attn blk
            n += self.num_layers * self._mamba_layer_params()
            n += self._attn_params(d, self.num_heads, self.num_kv_heads, hd)
            n += self._mlp_params(d, self.d_ff)
        elif self.family == "audio":        # whisper enc-dec
            enc = self.encoder_layers * (
                self._attn_params(d, self.num_heads, self.num_kv_heads, hd)
                + self._mlp_params(d, self.d_ff, gated=False))
            dec = self.num_layers * (
                2 * self._attn_params(d, self.num_heads, self.num_kv_heads, hd)
                + self._mlp_params(d, self.d_ff, gated=False))
            n += enc + dec
        else:
            per_layer_attn = self._attn_params(d, self.num_heads, self.num_kv_heads, hd)
            n += self.num_layers * per_layer_attn
            if self.num_experts:
                moe_layers = self.num_layers // self.moe_layer_period
                dense_layers = self.num_layers - moe_layers
                n += dense_layers * self._mlp_params(d, self.d_ff)
                n += moe_layers * (self.num_experts * self._mlp_params(d, self.d_ff)
                                   + d * self.num_experts)
            else:
                n += self.num_layers * self._mlp_params(d, self.d_ff)
            if self.cross_attn_every:
                n_cross = self.num_layers // self.cross_attn_every
                n += n_cross * (self._attn_params(d, self.num_heads, self.num_kv_heads, hd)
                                + self._mlp_params(d, self.d_ff))
        # final norm + per-layer norms (negligible but counted)
        n += d
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        moe_layers = self.num_layers // self.moe_layer_period
        unused = (self.num_experts - self.experts_per_token)
        full -= moe_layers * unused * self._mlp_params(self.d_model, self.d_ff)
        return full

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # A tiny config of the same family, for CPU smoke tests.
    def smoke(self) -> "ModelConfig":
        kw: Dict[str, object] = dict(
            num_layers=max(2, self.moe_layer_period, self.shared_attn_every,
                           self.cross_attn_every) * 2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            chunk_size=8,
        )
        if self.num_experts:
            kw.update(num_experts=4,
                      experts_per_token=min(self.experts_per_token, 2))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16)
        if self.num_image_tokens:
            kw.update(num_image_tokens=16)
        if self.encoder_layers:
            kw.update(encoder_layers=2)
        if self.num_kv_heads == self.num_heads:   # MHA stays MHA
            kw["num_kv_heads"] = kw["num_heads"]
        return self.replace(name=self.name + "-smoke", **kw)


# ---------------------------------------------------------------------------
# shapes


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

SHAPES: Dict[str, ShapeSpec] = {s.name: s for s in
                                (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

#: families whose sequence mixer is sub-quadratic (long_500k is runnable)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def cell_is_runnable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not if it doesn't."""
    if shape.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("long_500k needs a sub-quadratic sequence mixer; "
                       f"{cfg.name} is full-attention ({cfg.family})")
    return True, ""


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for the cell."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens           # forward only
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch
