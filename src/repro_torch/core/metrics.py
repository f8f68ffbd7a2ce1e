"""The STA -> schedule -> power metric chain, computed in exactly one place.

Three consumers need the same projection of a routed design into
(frequency, runtime, power, EDP): the final report passes
(:mod:`repro_torch.core.passes`), the power-cap controller's per-round budget
check (:mod:`repro_torch.core.power_cap`), and the design-space-exploration
sweep (:mod:`repro_torch.core.explore`).  Before this module each re-plumbed
``analyze`` / ``schedule_round2`` / ``power_report`` by hand — three
copies of the same argument threading, three chances for the controller
to honour a cap the report would then contradict.

:func:`evaluate_design` is the single source of truth: every frequency,
power, or EDP number the toolkit emits flows through it, so a budget
enforced against its output is enforced against the reported tables by
construction (regression-tested byte-identically in
``tests/test_explore.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

from .netlist import RoutedDesign
from .power import EnergyParams, PowerReport, power_report
from .schedule import Schedule, schedule_round2
from .sta import STAReport, analyze
from .timing_model import TimingModel


@dataclass
class DesignMetrics:
    """One coherent (STA, schedule, power) evaluation of a design state.

    The three reports are computed from each other (the schedule feeds the
    power model at the STA's achievable frequency), so they are only
    meaningful as a unit — which is why the report passes publish all
    three from one :func:`evaluate_design` call instead of re-deriving
    them independently.
    """

    sta: STAReport
    schedule: Schedule
    power: PowerReport

    @property
    def critical_path_ns(self) -> float:
        return self.sta.critical_path_ns

    @property
    def freq_mhz(self) -> float:
        return self.sta.max_freq_mhz

    @property
    def power_mw(self) -> float:
        return self.power.power_mw

    @property
    def edp_js(self) -> float:
        return self.power.edp_js


def evaluate_design(design: RoutedDesign, tm: TimingModel,
                    energy: EnergyParams, iterations: int,
                    stall_factor: float = 0.0,
                    rep: Optional[STAReport] = None,
                    sta_backend: str = "scalar",
                    device=None) -> DesignMetrics:
    """Project the design's *current* state into a :class:`DesignMetrics`.

    Runs application STA (or reuses ``rep`` if the caller already analyzed
    this exact state), recomputes the round-2 schedule with the concrete
    post-pipelining latencies, and evaluates ``P = P_static + f * E_cycle``
    at the achievable frequency.  Deterministic: two calls on equal design
    states return bit-equal numbers, which is what lets the power-cap
    controller and the frontier sweep promise byte-identity with the
    report passes.  ``sta_backend`` selects the timing engine
    (``scalar`` / ``numpy`` / ``torch`` — bit-identical, see
    :mod:`repro_torch.core.sta_vec`); ``device`` is read by ``torch`` only.
    """
    rep = rep if rep is not None else analyze(design, tm,
                                              backend=sta_backend,
                                              device=device)
    sched = schedule_round2(design, iterations, stall_factor=stall_factor)
    pr = power_report(design, rep.max_freq_mhz, sched, energy)
    return DesignMetrics(sta=rep, schedule=sched, power=pr)


def combine_metrics(per_app: Mapping[str, DesignMetrics],
                    flush_critical_ns: Optional[float] = None,
                    designs: Optional[Mapping[str, RoutedDesign]] = None,
                    energy: Optional[EnergyParams] = None
                    ) -> Dict[str, object]:
    """Fabric-level rollup of co-resident apps (multi-app fabric sharing).

    One shared fabric runs one clock: the achievable frequency is the
    *minimum* over residents (further capped by a soft shared flush's
    unbreakable path when ``flush_critical_ns`` is given), while power,
    energy, and EDP — extensive quantities — sum across residents.

    The per-app reports were each computed at their *own* maximum
    frequency; summing those directly would charge a fast resident for
    dynamic power it cannot dissipate on the slower shared clock.  With
    ``designs`` + ``energy`` given, every resident's power report is
    therefore re-evaluated at the combined clock before summing, so the
    rollup is physically consistent with the one-clock premise.  Per-app
    native frequencies stay visible so the degradation each resident pays
    for co-residency is attributable.
    """
    if not per_app:
        raise ValueError("combine_metrics needs at least one resident")
    freqs = {name: m.freq_mhz for name, m in per_app.items()}
    slowest = min(freqs, key=freqs.get)
    freq = freqs[slowest]
    flush_freq = (1e3 / flush_critical_ns
                  if flush_critical_ns else None)
    if flush_freq is not None and flush_freq < freq:
        freq, slowest = flush_freq, "__flush__"
    if designs is not None and energy is not None:
        at_clock = {name: power_report(designs[name], freq,
                                       per_app[name].schedule, energy)
                    for name in per_app}
    else:
        at_clock = {name: m.power for name, m in per_app.items()}
    return {
        "residents": len(per_app),
        "freq_mhz": freq,
        "freq_limited_by": slowest,
        "per_app_freq_mhz": freqs,
        "power_mw": sum(p.power_mw for p in at_clock.values()),
        "energy_j": sum(p.energy_j for p in at_clock.values()),
        "edp_js": sum(p.edp_js for p in at_clock.values()),
        "runtime_s": max(p.runtime_s for p in at_clock.values()),
    }
