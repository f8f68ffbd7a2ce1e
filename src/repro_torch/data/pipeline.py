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
as bf16. The reference's ``batch_specs`` / ``batch_logical_axes`` serve
its sharded dry run and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import AUDIO_FRAMES, ModelConfig, ShapeSpec
from repro_torch.device import resolve_device


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
