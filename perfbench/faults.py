"""Faults planted under a run's timed path, for the harness's own tests and
for calibration: each wraps the step or the feed that a driver's ``setup``
built, before warming takes the first step. A run with a fault planted has
to come out as not correct.

    execute(run, t0, plant=faults.plant("half_batch"))
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from harness import weights


def unchanged_state(run, st: Dict) -> None:
    """The step returns its state unchanged: training computes the loss and
    leaves parameters and optimizer as they were; serving puts the cache and
    state back as the step found them."""
    step = st["step"]
    if run.kind == "train":
        model = st["model"]

        def frozen(state, batch):
            with torch.no_grad():
                return state, model.loss(state["params"], batch)
    else:
        def frozen(params, batch, cache, *rest):
            keep = [t.clone() for _, t in weights.items(cache)]
            out = step(params, batch, cache, *rest)
            for (_, t), k in zip(weights.items(cache), keep):
                t.copy_(k)
            return out
    st["step"] = frozen


def half_batch(run, st: Dict) -> None:
    """Half of each training batch left out, the loss the mean over the
    rest."""
    feed = st["feed"]

    def half(k):
        return {n: t[:t.shape[0] // 2] for n, t in feed(k).items()}
    st["feed"] = half


def altered_token(run, st: Dict) -> None:
    """Each served token moved to the next id where the step produces it:
    the step's logits rolled by one along the vocabulary."""
    step = st["step"]

    def altered(*args):
        logits, rest = step(*args)
        return logits.roll(1, -1), rest
    st["step"] = altered


FAULTS: Dict[str, Callable] = {
    "unchanged_state": unchanged_state,
    "half_batch": half_batch,
    "altered_token": altered_token,
}

# the faults each kind of cell can have
BY_KIND = {"train": ("unchanged_state", "half_batch"),
           "decode": ("unchanged_state", "altered_token")}


def plant(*names: str) -> Callable:
    """``execute``'s ``plant``: the named faults, planted in turn."""
    def apply(run, st):
        for n in names:
            FAULTS[n](run, st)
    return apply
