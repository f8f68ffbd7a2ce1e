"""Spans and counters inside the port (the JAX package has none).

A span names a stretch of the program: a phase of the train step or a layer.
While a ``torch.profiler`` session records on the calling thread (autograd's
device threads included: they take the session from the thread that runs
backward), ``span(name)`` records a host event of that name in the session's
trace, on the profiler's clock beside the device's kernels, and a reader of
the trace attributes each kernel to the span that launched it
(``perfbench/harness/spans.py``). The event is a plain function-scope record
(``torch._C._profiler._RecordFunctionFast``), not a user annotation
(``record_function``): the profiler copies a user annotation onto the
device's timeline as an interval of its own, which a reader of device time
would count as a kernel. Outside a session a span is one shared no-op
context, and records nothing.

Counters count what the program does on the device without reading it back:
under ``counting()``, ``count(name, value)`` adds a device scalar (or a host
int) to a total kept where the value lives; ``counters()`` reads the totals,
with one synchronisation. A call site guards with ``if counting_on():``, so
that what it counts is not even computed outside ``counting()``.

The spans the port records (``SPANS``): the train step's phases
(``launch/steps.py``), and the layers of the train step's model
(``models/model.py`` ``forward`` and ``loss``, ``models/layers.py``
``attention`` and ``moe_ffn``, which decode and prefill run too, and
``kernels/flash_attention``'s backward). Under ``remat`` the backward re-runs
the forward's Python, and with it its spans, on the backward's thread inside
``step.backward``. The
counters, all in ``models/layers.py`` ``moe_ffn`` (counted again in a
recompute): ``moe.pairs``, the routed (token, choice) pairs, B * S * k;
``moe.pairs_dropped``, those past their expert's capacity;
``moe.slots``, the expert slots offered, B * E * capacity.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Union

import torch

SPANS = (
    "step.forward",        # the loss, from the embedding on
    "step.backward",       # the gradients
    "step.optimizer",      # AdamW
    "embed",               # the token table's lookup
    "attention",           # a whole attention layer: projections, rope,
                           # the kernel or the einsum, the output projection
    "attention.backward",  # flash_attention's backward, the plain version's
    "moe",                 # a MoE layer, in four parts:
    "moe.route",           # the router, top k, the balance loss
    "moe.dispatch",        # the sort by expert, the gather into slots
    "moe.experts",         # the experts' products
    "moe.combine",         # the gather back to tokens, the gates' sum
    "head",                # the final norm and the unembedding
    "loss",                # log-sum-exp, the true logit, z-loss, aux
)

_OFF = contextlib.nullcontext()
_totals: Optional[Dict[str, Union[int, torch.Tensor]]] = None


def span(name: str):
    """A context that records ``name`` in the trace of a running profiler
    session, and does nothing otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def counting_on() -> bool:
    return _totals is not None


@contextlib.contextmanager
def counting() -> Iterator[None]:
    """Counters accumulate inside, from zero. Not reentrant."""
    global _totals
    if _totals is not None:
        raise RuntimeError("counting() is already on")
    _totals = {}
    try:
        yield
    finally:
        _totals = None


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add ``value`` (an integer device scalar or a host int) to the total
    ``name``, with no synchronisation; only under ``counting()``."""
    if _totals is None:
        raise RuntimeError("count() outside counting()")
    _totals[name] = _totals.get(name, 0) + value


def counters() -> Dict[str, int]:
    """The totals so far inside ``counting()``, as host ints."""
    if _totals is None:
        raise RuntimeError("counters() outside counting()")
    names = sorted(_totals)
    held = [_totals[n] for n in names]
    on_device = [v for v in held if isinstance(v, torch.Tensor)]
    read = iter(torch.stack(on_device).tolist() if on_device else ())
    return {n: int(next(read) if isinstance(v, torch.Tensor) else v)
            for n, v in zip(names, held)}
