"""The one traffic generator: token ids from the seed.

Ids follow the Zipf-like draw of the program's ``SyntheticLMData`` (copied
here so that the yardstick does not move with the program): a uniform u
from numpy's generator on ``SeedSequence([seed, step])``, the id
min(floor(V u^3), V - 1), so small ids are frequent. A training batch of
step k is exactly that class's batch k (tokens, and labels shifted by one).
Serving draws use further streams of the same seed, so every piece of a
run (batches, first tokens, which sessions are checked) is a pure function
of ``--seed`` and of the mix.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# stream ids of the serving draws (training uses SyntheticLMData's [seed,
# step] directly)
FIRST_TOKENS, SAMPLE = 1_000_002, 1_000_003
WEIGHTS, CACHE = 1_000_004, 1_000_005


def seed64(seed: int) -> int:
    """Any whole number as a non-negative 63-bit seed."""
    return int(seed) % (1 << 63)


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [seed64(seed), *stream]))


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for a ``torch.Generator``, from the seed and a
    stream id."""
    s = np.random.SeedSequence([seed64(seed), stream]).generate_state(
        2, np.uint64)
    return int(s[0]) & ((1 << 63) - 1)


def zipf_ids(g: np.random.Generator, shape: Tuple[int, ...], vocab: int
             ) -> np.ndarray:
    u = g.random(shape)
    return np.minimum((vocab * u ** 3).astype(np.int64), vocab - 1)


def train_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                device) -> Dict[str, torch.Tensor]:
    toks = torch.from_numpy(zipf_ids(rng(seed, step), (batch, seq + 1),
                                     vocab)).to(device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def first_tokens(seed: int, batch: int, vocab: int, device) -> torch.Tensor:
    """Each decode session's first fed token: [batch, 1]."""
    return torch.from_numpy(zipf_ids(rng(seed, FIRST_TOKENS),
                                     (batch, 1), vocab)).to(device)


def sample(seed: int, population: int, k: int, tag: int = 0) -> list:
    """k distinct indices of range(population), drawn from the seed,
    sorted."""
    g = rng(seed, SAMPLE, tag)
    return sorted(g.choice(population, size=min(k, population),
                           replace=False).tolist())
