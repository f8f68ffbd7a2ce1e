"""Deterministic synthetic data: every batch is a pure function of
(seed, step).

The same numpy draws as the JAX package's ``SyntheticLMData`` (a
``SeedSequence([seed, step])`` generator, Zipf-like tokens by inverting a
power-law CDF, labels the next-token shift; then, for vlm and audio models
outside decode shapes, standard-normal ``image_embeds`` [B, num_image_tokens,
D] or ``frames`` [B, 1500, D] drawn from the same generator and rounded to
bf16), so for the same (seed, step) the port trains on exactly the
reference's arrays; a restarted run replays the stream it would have seen.
Batches come back on ``device``: tokens and labels as int64, the embeddings
as bf16.

``batch_specs`` gives every model input of a cell as a meta tensor (no
allocation) and ``batch_logical_axes`` its logical axes, the reference's
shapes and names, for the sharding trees of ``launch.steps``. Token leaves
are int64 there too, where the reference's are int32: they describe the
port's batches, and torch's embedding and gather take int64 indices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import AUDIO_FRAMES, ModelConfig, ShapeSpec
from repro_torch.device import resolve_device


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")
    if shape.kind == "decode":        # one new token against a seq_len cache
        return {"tokens": meta((b, 1), torch.int64)}
    out = {"tokens": meta((b, s), torch.int64)}
    if shape.kind == "train":
        out["labels"] = meta((b, s), torch.int64)
    if cfg.family == "vlm":
        out["image_embeds"] = meta((b, cfg.num_image_tokens, cfg.d_model),
                                   torch.bfloat16)
    if cfg.family == "audio":
        out["frames"] = meta((b, AUDIO_FRAMES, cfg.d_model), torch.bfloat16)
    return out


def batch_logical_axes(cfg: ModelConfig, shape: ShapeSpec
                       ) -> Dict[str, tuple]:
    axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
            "image_embeds": ("batch", None, "embed"),
            "frames": ("batch", None, "embed")}
    return {k: axes[k] for k in batch_specs(cfg, shape)}


@dataclasses.dataclass
class SyntheticLMData:
    cfg: ModelConfig
    shape: ShapeSpec
    seed: int = 0
    device: Optional[Union[str, torch.device]] = None   # None -> cuda

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The full global batch for ``step``."""
        rng = self._rng(step)
        b, s = self.shape.global_batch, self.shape.seq_len
        v = self.cfg.vocab_size
        # zipf-ish: invert a power-law CDF
        u = rng.random((b, s + 1))
        toks = np.minimum((v * u ** 3).astype(np.int64), v - 1)
        dev = resolve_device(self.device)
        toks = torch.from_numpy(toks).to(dev)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        stub = {"vlm": ("image_embeds", self.cfg.num_image_tokens),
                "audio": ("frames", AUDIO_FRAMES)}.get(self.cfg.family)
        if stub is not None and self.shape.kind != "decode":
            name, n = stub
            # numpy's f32 -> bf16 cast (ml_dtypes) and torch's both round to
            # nearest even: the reference's bytes
            emb = rng.standard_normal((b, n, self.cfg.d_model),
                                      dtype=np.float32)
            out[name] = torch.from_numpy(emb).to(dev).to(torch.bfloat16)
        if self.shape.kind == "decode":
            out = {"tokens": out["tokens"][:, :1]}
        return out

    def host_batch(self, step: int, host_index: int, num_hosts: int
                   ) -> Dict[str, torch.Tensor]:
        """This host's slice of the global batch (per-host data loading)."""
        full = self.batch(step)
        per = self.shape.global_batch // num_hosts
        lo = host_index * per
        return {k: x[lo:lo + per] for k, x in full.items()}
