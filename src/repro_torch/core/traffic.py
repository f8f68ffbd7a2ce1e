"""Trace-driven throughput evaluation of multi-app fabric packs.

Static metrics (:mod:`repro_torch.core.metrics`) end at freq/power/EDP of a
compiled design.  This layer answers the production question the ROADMAP's
online-scheduler item needs: *given this pack and this request arrival
trace, what latency and throughput does each resident actually deliver?*

The model is a queueing replay over each resident's round-2
:class:`~repro_torch.core.schedule.Schedule` (made affordable by the vectorized
simulator backends in :mod:`repro_torch.core.sim_vec`, which let the schedule's
cycle counts be cross-checked against real simulation instead of trusted):

* each resident region is a **sequential server** — one request (one full
  input frame / tensor) occupies the region for its service time;
* service time = pipeline fill latency + steady-state iteration cycles,
  straight from the schedule (``latency + (iterations - 1) * II_eff``);
* before the first request the region pays a **reconfiguration** charge
  (bitstream load, one cycle per tile: ``region.area()``), and between
  back-to-back requests a **flush downtime** charge — the paper
  Section VI hardened flush network is a broadcast tree of depth
  ``O(rows)``, so re-arming state between frames costs ``2 + rows``
  cycles (1 for the soft variant's single-net broadcast);
* cycles convert to wall-clock at the pack's shared fabric frequency
  (``pack.summary["freq_mhz"]`` — frequency is min over residents).

:func:`replay` returns a :class:`TrafficReport` with per-app fill
latency, steady-state and achieved throughput, downtime and busy
fractions, and a scalar :meth:`TrafficReport.objective` (higher is
better) for an admission/eviction scheduler to maximize.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .interconnect import Fabric, Region


@dataclass(frozen=True)
class TrafficTrace:
    """Request arrival times, in fabric cycles, per app.

    ``departures`` (optional) turns a replay trace into an *online* trace:
    each named app leaves the fabric at its departure cycle, freeing its
    region for later arrivals — the event stream the multi-tenant
    scheduler (:mod:`repro_torch.core.sched`) consumes via :meth:`events`.
    Apps without an entry never depart.
    """

    arrivals: Dict[str, List[int]]
    name: str = "trace"
    departures: Optional[Dict[str, int]] = None

    def total_requests(self) -> int:
        return sum(len(a) for a in self.arrivals.values())

    def horizon(self) -> int:
        h = max((a[-1] for a in self.arrivals.values() if a), default=0)
        if self.departures:
            h = max(h, max(self.departures.values()))
        return h

    def arrival_of(self, app: str) -> Optional[int]:
        """When ``app`` arrives on the fabric: its first request cycle."""
        times = self.arrivals.get(app)
        return times[0] if times else None

    def events(self) -> List[Tuple[int, str, str]]:
        """The scheduler's event stream: sorted ``(cycle, kind, app)``.

        One ``"arrive"`` event per app at its first request and one
        ``"depart"`` event per ``departures`` entry.  At equal cycles
        departures sort first — a leaving resident frees its region
        before the simultaneous arrival tries to claim one.
        """
        order = {"depart": 0, "arrive": 1}
        evs: List[Tuple[int, str, str]] = []
        for app in sorted(self.arrivals):
            t = self.arrival_of(app)
            if t is not None:
                evs.append((t, "arrive", app))
        for app, t in sorted((self.departures or {}).items()):
            if self.arrival_of(app) is not None:
                evs.append((int(t), "depart", app))
        evs.sort(key=lambda e: (e[0], order[e[1]], e[2]))
        return evs

    def restricted(self, apps: Sequence[str], t0: Optional[int] = None,
                   t1: Optional[int] = None) -> "TrafficTrace":
        """The sub-trace of ``apps``' arrivals within ``[t0, t1)``.

        What the scheduler replays per epoch: only the current residents,
        only the window between two consecutive events.  Departures are
        dropped (a windowed replay has no further use for them).
        """
        keep = set(apps)
        lo = -1 if t0 is None else t0
        hi = float("inf") if t1 is None else t1
        arrivals = {a: [t for t in ts if lo <= t < hi]
                    for a, ts in self.arrivals.items() if a in keep}
        return TrafficTrace({a: ts for a, ts in arrivals.items() if ts},
                            name=f"{self.name}[{t0}:{t1}]")


def periodic_trace(apps: Sequence[str], period: int, n_requests: int,
                   phase: int = 0) -> TrafficTrace:
    """One request per app every ``period`` cycles (apps offset by
    ``phase`` cycles each so arrivals interleave instead of colliding)."""
    if period <= 0 or n_requests <= 0:
        raise ValueError("period and n_requests must be positive")
    arrivals = {name: [phase * i + period * k for k in range(n_requests)]
                for i, name in enumerate(apps)}
    return TrafficTrace(arrivals, name=f"periodic_{period}")


def poisson_trace(apps: Sequence[str], mean_gap: float, n_requests: int,
                  seed: int = 0) -> TrafficTrace:
    """Poisson arrivals: exponential inter-arrival gaps with mean
    ``mean_gap`` cycles, one independent stream per app (deterministic
    per ``seed``)."""
    if mean_gap <= 0 or n_requests <= 0:
        raise ValueError("mean_gap and n_requests must be positive")
    rng = np.random.default_rng(seed)
    arrivals = {}
    for name in apps:
        gaps = rng.exponential(mean_gap, size=n_requests)
        arrivals[name] = np.maximum(1, np.rint(gaps)).cumsum().astype(
            np.int64).tolist()
    return TrafficTrace(arrivals, name=f"poisson_{mean_gap:g}")


def session_trace(sessions: Sequence[Tuple[str, int, Optional[int]]],
                  period: int, name: str = "sessions") -> TrafficTrace:
    """An online trace from explicit app sessions.

    Each session is ``(app, arrive_cycle, depart_cycle)`` (``None`` =
    stays forever): the app issues one request every ``period`` cycles
    from its arrival until (exclusive) its departure.  This is the
    generator the fragmentation-heavy scheduler benchmarks use — sessions
    that overlap and end at different times are exactly what carves holes
    into a static pack.
    """
    if period <= 0:
        raise ValueError("period must be positive")
    arrivals: Dict[str, List[int]] = {}
    departures: Dict[str, int] = {}
    for app, arrive, depart in sessions:
        if app in arrivals:
            raise ValueError(f"duplicate session for app {app!r}")
        if depart is not None and depart <= arrive:
            raise ValueError(
                f"session for {app!r} departs at {depart} but arrives "
                f"at {arrive}")
        end = depart if depart is not None else arrive + period
        arrivals[app] = list(range(int(arrive), int(end), int(period)))
        if depart is not None:
            departures[app] = int(depart)
    return TrafficTrace(arrivals, name=name,
                        departures=departures or None)


def flush_downtime_cycles(fabric: Fabric, hardened: bool = True) -> int:
    """Cycles a region is unavailable while its state flushes between
    requests: the hardened flush network is a pipelined broadcast tree of
    depth ~``rows`` (source -> column spine -> row taps), so assert +
    propagate costs ``2 + rows``; the soft variant broadcasts on one net
    in a single (slow) cycle."""
    return 2 + fabric.rows if hardened else 1


def reconfig_cycles(region: Region) -> int:
    """One-time configuration-load charge for admitting an app into a
    region: one cycle per tile of configuration stream."""
    return region.area()


@dataclass
class AppTrafficStats:
    """Replay outcome for one resident app."""

    app: str
    requests: int
    fill_latency_cycles: int       # pipeline fill (schedule round-2 latency)
    service_cycles: int            # full request occupancy, fill included
    reconfig_cycles: int           # one-time admission charge
    flush_cycles: int              # per-request flush downtime
    makespan_cycles: int           # last finish - first arrival
    busy_cycles: int               # cycles actually computing
    downtime_cycles: int           # reconfig + flush total
    mean_latency_cycles: float     # arrival -> finish, queueing included
    p95_latency_cycles: float
    steady_rps: float              # back-to-back ceiling at fabric clock
    achieved_rps: float            # requests / makespan wall-clock

    def row(self) -> dict:
        return {
            "app": self.app,
            "requests": self.requests,
            "fill_latency_cycles": self.fill_latency_cycles,
            "service_cycles": self.service_cycles,
            "mean_latency_cycles": round(self.mean_latency_cycles, 1),
            "p95_latency_cycles": round(self.p95_latency_cycles, 1),
            "steady_rps": round(self.steady_rps, 1),
            "achieved_rps": round(self.achieved_rps, 1),
            "downtime_frac": round(
                self.downtime_cycles / max(1, self.makespan_cycles), 4),
            "busy_frac": round(
                self.busy_cycles / max(1, self.makespan_cycles), 4),
        }


@dataclass
class TrafficReport:
    """Fabric-level view of one trace replay."""

    pack_name: str
    trace_name: str
    freq_mhz: float
    per_app: Dict[str, AppTrafficStats] = field(default_factory=dict)
    #: Default latency weight for :meth:`objective` — how many requests/s
    #: of throughput one millisecond of mean request latency is worth.
    #: Set per replay (``replay(..., latency_weight=)``); the historical
    #: default of 1.0 is pinned by a regression test, since the online
    #: scheduler consumes ``objective()`` as its admission score.
    latency_weight: float = 1.0

    def rows(self) -> List[dict]:
        return [s.row() for s in self.per_app.values()]

    def summary(self) -> dict:
        total_rps = sum(s.achieved_rps for s in self.per_app.values())
        lat = [s.mean_latency_cycles for s in self.per_app.values()]
        down = [s.downtime_cycles / max(1, s.makespan_cycles)
                for s in self.per_app.values()]
        return {
            "pack": self.pack_name,
            "trace": self.trace_name,
            "freq_mhz": round(self.freq_mhz, 1),
            "apps": len(self.per_app),
            "requests": sum(s.requests for s in self.per_app.values()),
            "achieved_rps": round(total_rps, 1),
            "mean_latency_cycles": round(float(np.mean(lat)), 1) if lat
            else 0.0,
            "mean_downtime_frac": round(float(np.mean(down)), 4) if down
            else 0.0,
            "objective": round(self.objective(), 3),
        }

    def objective(self, latency_weight: Optional[float] = None) -> float:
        """Scalar objective for the online scheduler, higher is better:
        total achieved throughput (requests/s) minus ``latency_weight``
        times the mean request latency in milliseconds.  Throughput pays
        for admission; queueing delay (and flush/reconfig downtime, which
        inflates it) argues for eviction or re-packing.

        ``latency_weight=None`` uses the report's own
        :attr:`latency_weight` (itself defaulting to 1.0, the historical
        hard-coded value).
        """
        if not self.per_app:
            return 0.0
        w = self.latency_weight if latency_weight is None else latency_weight
        thr = sum(s.achieved_rps for s in self.per_app.values())
        lat_ms = [s.mean_latency_cycles / (self.freq_mhz * 1e3)
                  for s in self.per_app.values()]
        return thr - w * float(np.mean(lat_ms))

    def app_objectives(self, latency_weight: Optional[float] = None
                       ) -> Dict[str, float]:
        """Per-app objective contributions (same weight semantics).

        Each app's achieved throughput minus the weighted share of mean
        latency it contributes; the contributions sum to
        :meth:`objective`.  The scheduler's eviction policy ranks
        residents by these.
        """
        if not self.per_app:
            return {}
        w = self.latency_weight if latency_weight is None else latency_weight
        n = len(self.per_app)
        return {name: s.achieved_rps
                - w * (s.mean_latency_cycles / (self.freq_mhz * 1e3)) / n
                for name, s in self.per_app.items()}


def _service_cycles(result, iterations: Optional[int]) -> int:
    """Request occupancy in cycles from a resident's schedule.

    The round-2 schedule folds the effective II into ``iterations``
    (``ii`` is renormalized to 1), so a per-request iteration override
    recovers the per-iteration cost from the recorded totals.
    """
    sched = result.schedule
    if iterations is None or iterations == sched.iterations:
        return sched.total_cycles
    if sched.iterations > 1:
        per_iter = ((sched.total_cycles - sched.latency_cycles)
                    / (sched.iterations - 1))
    else:
        per_iter = float(sched.ii)
    return sched.latency_cycles + int(round(max(0, iterations - 1)
                                            * per_iter))


def replay(pack, trace: TrafficTrace, iterations: Optional[int] = None,
           latency_weight: float = 1.0) -> TrafficReport:
    """Replay ``trace`` against a :func:`compile_multi` pack.

    ``pack`` is a :class:`~repro_torch.core.multi.MultiAppResult`; every app in
    the trace must be a resident.  ``iterations`` overrides the per-request
    problem size (None = each request runs the app's compiled iteration
    count); ``latency_weight`` becomes the report's default
    :meth:`TrafficReport.objective` weight (drivers may copy
    ``CASCADE_SCHED_LATENCY_WEIGHT`` here).  Pure queueing arithmetic —
    no simulation — so replaying millions of requests is instant; the
    underlying cycle counts are the schedule's, which the vectorized
    simulator backends validate.
    """
    freq = float(pack.summary.get("freq_mhz") or 0.0)
    if freq <= 0:
        raise ValueError(f"pack {pack.name!r} has no fabric frequency")
    hardened = bool(pack.flush.hardened) if hasattr(pack, "flush") else True
    flush_cy = flush_downtime_cycles(pack.fabric, hardened=hardened)
    report = TrafficReport(pack_name=pack.name, trace_name=trace.name,
                           freq_mhz=freq, latency_weight=latency_weight)
    residents = {r.app.name for r in pack.results}
    unknown = set(trace.arrivals) - residents
    if unknown:
        raise ValueError(
            f"trace names non-resident apps {sorted(unknown)}; pack "
            f"{pack.name!r} holds {sorted(residents)}")

    for app_name, arrivals in trace.arrivals.items():
        result = pack.result_for(app_name)
        region = pack.regions[app_name]
        service = _service_cycles(result, iterations)
        reconf = reconfig_cycles(region)
        latencies: List[float] = []
        busy = downtime = 0
        t_free = 0
        first_arrival = arrivals[0] if arrivals else 0
        for i, a in enumerate(sorted(arrivals)):
            start = max(int(a), t_free)
            pre = reconf if i == 0 else flush_cy
            finish = start + pre + service
            latencies.append(finish - int(a))
            busy += service
            downtime += pre
            t_free = finish
        makespan = max(1, t_free - first_arrival)
        steady_rps = freq * 1e6 / max(1, service + flush_cy)
        achieved = (len(arrivals) * freq * 1e6 / makespan) if arrivals \
            else 0.0
        report.per_app[app_name] = AppTrafficStats(
            app=app_name, requests=len(arrivals),
            fill_latency_cycles=result.schedule.latency_cycles,
            service_cycles=service, reconfig_cycles=reconf,
            flush_cycles=flush_cy, makespan_cycles=makespan,
            busy_cycles=busy, downtime_cycles=downtime,
            mean_latency_cycles=float(np.mean(latencies)) if latencies
            else 0.0,
            p95_latency_cycles=float(np.percentile(latencies, 95))
            if latencies else 0.0,
            steady_rps=steady_rps, achieved_rps=achieved)
    return report
