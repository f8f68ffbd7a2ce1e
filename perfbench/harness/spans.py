"""The program's own spans and counters, read from a traced stretch.

The program (``repro_torch.trace``) records named spans at its layer
boundaries while a profiler session records, and counts what its MoE drops
under ``counting()``. ``harness.trace`` keeps of the run's traced stretch
names and times alone, so this module profiles the stretch once more,
after the run's check: the driver's own ``traced(run, state)`` on a state
built anew from the same seed, warmed by one unprofiled stretch, then
profiled with ``profile`` below in place of ``harness.trace.profile``, under
the program's ``counting()``. It keeps of each raw event what attribution
needs: thread, correlation ids, the autograd sequence number.

Each device operation (kernel, copy, fill) is attributed in three steps:

* its launching runtime call, by correlation id (else the host operation
  the profiler links it to);
* its phase: the program's ``step.*`` span whose interval holds the launch,
  on whatever thread (autograd runs backward on a thread of its own while
  the step's thread waits in ``step.backward``);
* its span: the innermost program span open on the launching thread. A
  launch under no span but a phase's (autograd's thread, between the
  recomputes) is followed from the autograd node that ran it, by sequence
  number and forward thread, to the forward operation that recorded the
  node, and takes that operation's span (``how`` "grad"; else "run").

What stays unattributed is ``(no span)``. The device's idle gaps are summed
by the innermost program span open at each gap's middle on any thread.
A trace without program spans (a program that records none) gives readers
nothing: each returns None.
"""

from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch

from . import trace as htrace
from .trace import LAUNCHES, Trace, _union

NO_SPAN = "(no span)"
PHASE = "step."
# the phases that name no layer: a launch under one alone is followed to
# the forward operation that recorded its autograd node
UNLAYERED = ("step.forward", "step.backward")
# the program spans that name a layer, over which ``coverage`` is taken
LAYERS = ("embed", "attention", "attention.backward", "moe", "head", "loss",
          "step.optimizer")
NODE = "autograd::engine::evaluate_function: "
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")      # CUDA runtime and driver calls

Label = Tuple[Optional[str], Optional[str], str]     # phase, span, how


def is_layer(span: Optional[str]) -> bool:
    return span is not None and (span in LAYERS or span.startswith("moe."))


@dataclass
class SpanTrace(Trace):
    labels: List[Label] = field(default_factory=list)   # a kernel's each
    gaps_by_span: Dict[Tuple[Optional[str], Optional[str]], float] = \
        field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    span_events: Dict[str, int] = field(default_factory=dict)  # by name

    @property
    def spans(self) -> int:
        """The program's span events in the trace."""
        return sum(self.span_events.values())

    def time_by_span(self) -> Dict[Label, float]:
        out: Dict[Label, float] = defaultdict(float)
        for (_, s, e), lab in zip(self.kernels, self.labels):
            out[lab] += (e - s) / 1e9
        return dict(out)

    def span_seconds(self, pick: Callable[[Optional[str]], bool]) -> float:
        """Device seconds of the kernels whose span ``pick`` takes."""
        return sum(e - s for (_, s, e), (_, span, _) in
                   zip(self.kernels, self.labels) if pick(span)) / 1e9

    def owners(self, top: int = 60) -> List[list]:
        """The largest (kernel, span, how) sums, in seconds."""
        by: Dict[Tuple[str, Optional[str], str], float] = defaultdict(float)
        for (n, s, e), (_, span, how) in zip(self.kernels, self.labels):
            by[(n, span, how)] += (e - s) / 1e9
        return [[n[:htrace.NAME_CHARS], span or NO_SPAN, how, sec]
                for (n, span, how), sec in
                sorted(by.items(), key=lambda x: -x[1])[:top]]


# ---------------------------------------------------------------------------
# the sweep


def innermost(spans: Dict[int, List[Tuple[int, int, object]]],
              queries: Sequence[Tuple[int, int]]) -> List[Optional[tuple]]:
    """For each query (thread, time), the innermost of ``spans[thread]``
    (start, end, payload), properly nested on a thread, whose interval holds
    the time, or None: one sweep a thread over every span, in time order."""
    out: List[Optional[tuple]] = [None] * len(queries)
    by_tid: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for i, (tid, t) in enumerate(queries):
        by_tid[tid].append((t, i))
    for tid, qs in by_tid.items():
        ss = sorted(spans.get(tid, ()), key=lambda s: (s[0], -s[1]))
        stack: List[tuple] = []
        j = 0
        for t, i in sorted(qs):
            while j < len(ss) and ss[j][0] <= t:
                stack.append(ss[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out[i] = stack[-1] if stack else None
    return out


def _phase_at(phases: List[Tuple[int, int, str]]
              ) -> Callable[[int], Optional[str]]:
    """The phase whose interval holds a time: phases do not overlap."""
    phases = sorted(phases)
    starts = [p[0] for p in phases]

    def at(t: int) -> Optional[str]:
        i = bisect.bisect_right(starts, t) - 1
        return phases[i][2] if i >= 0 and t <= phases[i][1] else None
    return at


# ---------------------------------------------------------------------------
# reading the raw events


def read_events(events: Iterable, window_s: float, units: int,
                span_names: Iterable[str],
                counters: Optional[Dict[str, int]] = None) -> SpanTrace:
    """A ``SpanTrace`` of the profiler's raw kineto events; ``span_names``
    are the program's spans."""
    from torch.autograd import DeviceType
    names = set(span_names)
    kernels, k_corr, k_link = [], [], []
    runtime: Dict[int, Tuple[int, int]] = {}     # CUPTI correlation id
    ops: Dict[int, Tuple[int, int]] = {}         # the profiler's op id
    spans: Dict[int, list] = defaultdict(list)
    nodes: Dict[int, list] = defaultdict(list)
    forward: Dict[Tuple[int, int], int] = {}     # (thread, seq) -> start
    phases: List[Tuple[int, int, str]] = []
    launches = 0
    span_events: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.is_hidden_event():
            continue
        dev = e.device_type()
        if dev == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append((e.name(), e.start_ns(), e.end_ns()))
                k_corr.append(e.correlation_id())
                k_link.append(e.linked_correlation_id())
            continue
        if dev != DeviceType.CPU:
            continue
        name, tid, s = e.name(), e.start_thread_id(), e.start_ns()
        if _RUNTIME.match(name):
            runtime[e.correlation_id()] = (tid, s)
            launches += name in LAUNCHES
            continue
        ops[e.correlation_id()] = (tid, s)
        if name in names:
            span_events[name] += 1
            spans[tid].append((s, e.end_ns(), name))
            if name.startswith(PHASE):
                phases.append((s, e.end_ns(), name))
        elif name.startswith(NODE):
            if e.sequence_nr() >= 0:
                nodes[tid].append((s, e.end_ns(),
                                   (e.fwd_thread_id(), e.sequence_nr())))
        elif e.sequence_nr() >= 0 and e.fwd_thread_id() == 0:
            forward.setdefault((tid, e.sequence_nr()), s)
    phase_at = _phase_at(phases)

    # 1. the launch: (thread, time)
    at = [runtime.get(c) or ops.get(l) for c, l in zip(k_corr, k_link)]
    # 2-3. the phase, and the span: the launching thread's innermost, else
    # the span of the forward operation behind the autograd node
    found = innermost(spans, [a or (-1, 0) for a in at])
    follow = [i for i, (a, f) in enumerate(zip(at, found))
              if a is not None and (f is None or f[2] in UNLAYERED)]
    fwd = {}
    for i, n in zip(follow, innermost(nodes, [at[i] for i in follow])):
        if n is not None and n[2] in forward:
            fwd[i] = (n[2][0], forward[n[2]])
    how = ["run"] * len(at)
    for i, f in zip(fwd, innermost(spans, list(fwd.values()))):
        if f is not None:
            found[i], how[i] = f, "grad"
    labels: List[Label] = [
        (phase_at(a[1]) if a else None, f[2] if f else None, h)
        for a, f, h in zip(at, found, how)]

    busy = _union([(s, e) for _, s, e in kernels])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    by_gap: Dict[Tuple[Optional[str], Optional[str]], float] = \
        defaultdict(float)
    mids = [(s + e) // 2 for s, e in gaps]
    best: List[Optional[tuple]] = [None] * len(gaps)
    for tid in spans:
        for i, f in enumerate(innermost(spans, [(tid, m) for m in mids])):
            if f is not None and (best[i] is None or f[0] > best[i][0]):
                best[i] = f
    for (s, e), m, f in zip(gaps, mids, best):
        by_gap[(phase_at(m), f[2] if f else None)] += (e - s) / 1e9
    return SpanTrace(
        window_s, units, kernels, launches,
        sum(e - s for s, e in busy) / 1e9,
        (busy[-1][1] - busy[0][0]) / 1e9 if busy else 0.0,
        labels=labels, gaps_by_span=dict(by_gap), counters=dict(counters or {}),
        span_events=dict(span_events))


# ---------------------------------------------------------------------------
# the stretch


def program_trace():
    """The program's ``repro_torch.trace``, or None where it has none."""
    if importlib.util.find_spec("repro_torch.trace") is None:
        return None
    return importlib.import_module("repro_torch.trace")


def profile(unit: Callable[[], None], units: int) -> SpanTrace:
    """Trace ``units`` calls of ``unit`` (already warm) with the program's
    spans, under its ``counting()``: ``harness.trace.profile``'s signature,
    so that a driver's ``traced`` can run it."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    prog = program_trace()
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with tprofile(activities=acts) as prof, prog.counting():
        t0 = time.perf_counter()
        for _ in range(units):
            unit()
        sync()
        window = time.perf_counter() - t0
        totals = prog.counters()
    return read_events(prof.profiler.kineto_results.events(), window, units,
                       prog.SPANS, totals)


def _unprofiled(unit: Callable[[], None], units: int) -> None:
    for _ in range(units):
        unit()


def _traced_again(run) -> Optional[SpanTrace]:
    from .run import ROOT, Run, free_device
    from .spec import driver
    if program_trace() is None:
        return None
    d = driver(run.kind, run.cell.root)
    again = Run(run.cell, run.seed, run.seconds, True, run.device)
    free_device()
    st = d.setup(again)
    kept = htrace.profile
    try:
        for stretch in (_unprofiled, profile):
            htrace.profile = stretch
            d.traced(again, st)
    finally:
        htrace.profile = kept
        st.clear()
        free_device()
    t = again.trace
    if not isinstance(t, SpanTrace):
        raise RuntimeError(f"the {run.kind} driver's traced() did not run "
                           f"harness.trace.profile")
    write_summary(t, ROOT / "build" / "perfbench" / "traces" /
                  f"{run.cell.name}.{run.seed}.spans.json", run)
    return t


def of(run) -> Optional[SpanTrace]:
    """The span trace of ``run``'s cell, profiled once a run (kept on the
    run); None without a traced run or where the program records no
    span."""
    if not run.traced:
        return None
    if "span_trace" not in vars(run):
        vars(run)["span_trace"] = _traced_again(run)
    t = vars(run)["span_trace"]
    return t if t is not None and t.spans else None


def write_summary(t: SpanTrace, path, run) -> None:
    """The stretch's device time by (phase, span, how), its idle gaps by
    (phase, span), the counters and the largest (kernel, span) sums."""
    path.parent.mkdir(parents=True, exist_ok=True)

    def rows(d):
        return [[*(k or NO_SPAN for k in key), sec] for key, sec in
                sorted(d.items(), key=lambda x: -x[1])]
    path.write_text(json.dumps({
        "workload": run.cell.name, "seed": run.seed, "units": t.units,
        "window_s": t.window_s, "busy_s": t.busy_s, "span_s": t.span_s,
        "launches": t.launches, "kernels": len(t.kernels),
        "coverage": coverage(t), "counters": t.counters,
        "span_events": t.span_events,
        "time_by_span": rows(t.time_by_span()),
        "idle_gaps_by_span": rows(t.gaps_by_span),
        "owners": t.owners()}, indent=1))


# ---------------------------------------------------------------------------
# what the readers compute


def coverage(t: SpanTrace) -> Optional[float]:
    """Percent of the device time that a layer's span owns."""
    total = sum(e - s for _, s, e in t.kernels) / 1e9
    if not t.spans or total <= 0:
        return None
    return 100.0 * t.span_seconds(is_layer) / total


def span_ms(run, pick: Callable[[Optional[str]], bool]) -> Optional[float]:
    """Device ms a traced step of the kernels whose span ``pick`` takes."""
    t = of(run)
    if t is None or not t.units or not t.kernels:
        return None
    return 1e3 * t.span_seconds(pick) / t.units


def span_coverage(run) -> Optional[float]:
    t = of(run)
    return None if t is None else coverage(t)


def counter_share(run, num: Sequence[Tuple[str, int]], den: str
                  ) -> Optional[float]:
    """Percent that the sum of ``num``'s (counter, sign) is of the counter
    ``den``, over the traced stretch."""
    t = of(run)
    if t is None or not t.counters.get(den):
        return None
    c = t.counters
    if any(n not in c for n, _ in num):
        return None
    return 100.0 * sum(sign * c[n] for n, sign in num) / c[den]
