"""Deterministic synthetic data: every batch is a pure function of
(seed, step).

The same numpy draws as the JAX package's ``SyntheticLMData`` (a
``SeedSequence([seed, step])`` generator, Zipf-like tokens by inverting a
power-law CDF, labels the next-token shift), so for the same (seed, step)
the port trains on exactly the reference's token arrays; a restarted run
replays the stream it would have seen. Batches come back as int64 tensors on
``device``. The reference's ``batch_specs`` / ``batch_logical_axes`` serve
its sharded dry run and are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
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
        if self.cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"{self.cfg.family} inputs are not ported yet (ROADMAP: LM "
                "substrate queue)")
        rng = self._rng(step)
        b, s = self.shape.global_batch, self.shape.seq_len
        v = self.cfg.vocab_size
        # zipf-ish: invert a power-law CDF
        u = rng.random((b, s + 1))
        toks = np.minimum((v * u ** 3).astype(np.int64), v - 1)
        dev = resolve_device(self.device)
        toks = torch.from_numpy(toks).to(dev)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
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
