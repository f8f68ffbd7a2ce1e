"""What the per-layer metrics' readers compute, from a finished ``Run``.
Each returns None where the run has nothing to read (no trace, no call of
the kernel), and the harness then leaves the metric out of the line; no
share is ever reported as 0 for want of a reading."""

from __future__ import annotations

from typing import Optional, Sequence

from . import counts


def idle_share(run) -> Optional[float]:
    """Percent of the traced device span in which no operation ran."""
    t = run.trace
    if t is None or t.span_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)


def step_mfu(run) -> Optional[float]:
    """Percent of a window step's (or call's) time that the card needs at
    its peaks for the step's work (the larger of its operations and bytes
    bounds)."""
    if not run.units or not run.work:
        return None
    least = counts.least_seconds(run.work["flops"], run.work["bytes"])
    return 100.0 * least / (run.window_s / run.units)


def roofline(run, bound: str, patterns: Sequence[str],
             calls: Sequence[str]) -> Optional[float]:
    """Percent of the traced time of the kernels named by ``patterns`` that
    their bound is: ``run.bounds[bound]`` (a call's least seconds) times
    the traced calls, counted as the launches of the kernels named by
    ``calls`` (one a call)."""
    t = run.trace
    if t is None or bound not in run.bounds:
        return None
    seconds = sum(t.kernel_seconds(p) for p in patterns)
    n = sum(t.kernel_calls(p) for p in calls)
    if seconds <= 0 or n == 0:
        return None
    return 100.0 * run.bounds[bound] * n / seconds


def launches_per_unit(run) -> Optional[float]:
    """Kernel and graph launches of the CUDA runtime a traced step or
    call."""
    t = run.trace
    if t is None or not t.units or not t.launches:
        return None
    return t.launches / t.units
