"""Power-capped post-PnR pipelining (beyond the paper; Capstone,
arXiv:2603.00909).

Cascade's post-PnR pass (Section V-D, :mod:`repro_torch.core.post_pnr`)
spends
switch-box pipelining registers until the critical path stops improving
— it is blind to the power side of the EDP product the toolkit reports.
Capstone's observation is that a compiler can instead pipeline *up to a
power budget*: every inserted register raises both the achievable clock
frequency and the per-cycle switching energy, so projected power
``P = P_static + f * E_cycle`` climbs monotonically round over round, and
the pipelining loop can simply stop (rolling back the last round) once it
would cross a cap.

This module is the outer budget controller around the unmodified inner
loop:

* :class:`~repro_torch.core.post_pnr.DesignCheckpoint` (re-exported
  here) — snapshot/restore of the mutable pipelining state of a
  :class:`~repro_torch.core.netlist.RoutedDesign`; the rollback mechanism,
  shared with the inner loop's own revert and deliberately generic so
  future schedule-space-exploration passes can reuse it.
* :func:`evaluate_point` — one (frequency, power, EDP, registers) Pareto
  point for the design's *current* state, using exactly the same STA /
  schedule / power models as the final report passes, so a cap honoured
  here is honoured in the reported numbers.
* :func:`power_capped_pipeline` — runs
  :func:`~repro_torch.core.post_pnr.post_pnr_pipeline` with a per-round hook
  that re-evaluates the power model at the new achievable frequency and
  stops (restoring the last under-cap checkpoint) once projected power
  exceeds ``cap_mw``.  With no cap the hook only records the trajectory,
  so the result is byte-identical to the unconstrained pass.

The registered pass wrapper (``"power_capped_pipeline"`` in the
``"power_capped"`` named schedule) lives in :mod:`repro_torch.core.passes`.
``device`` is where the ``"torch"`` STA backend runs (the compiler's);
every backend's report is bit-identical, so a capped result does not
depend on it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from .metrics import evaluate_design
from .netlist import RoutedDesign
from .post_pnr import (DesignCheckpoint, PostPnRParams, PostPnRResult,
                       post_pnr_pipeline)
from .power import EnergyParams
from .sta import STAReport
from .timing_model import TimingModel


@dataclass
class ParetoPoint:
    """One point on the registers-vs-power trade-off curve."""

    round: int                   # 0 = before any capped round
    critical_path_ns: float
    freq_mhz: float
    power_mw: float
    edp_js: float
    registers_added: int         # netlist registers added since extraction

    def scaled(self) -> dict:
        return {"round": self.round,
                "critical_path_ns": round(self.critical_path_ns, 3),
                "freq_mhz": round(self.freq_mhz, 1),
                "power_mw": round(self.power_mw, 2),
                "edp_ujs": self.edp_js * 1e6,
                "registers_added": self.registers_added}


@dataclass
class PowerCapResult:
    """Outcome of one power-capped pipelining run.

    ``trajectory`` holds every accepted Pareto point (round 0 is the
    pre-loop state); ``final`` equals ``trajectory[-1]`` when the run was
    feasible.  ``rounds_rolled_back`` is 1 when the loop had to rewind the
    round that crossed the cap, else 0.  ``feasible`` is False when even
    the un-pipelined input design exceeded the cap (nothing to roll back:
    register removal below the matched baseline is not in the pass's
    repertoire) — the reported point is then the initial state.
    """

    cap_mw: Optional[float]
    feasible: bool
    initial: ParetoPoint
    final: ParetoPoint
    trajectory: List[ParetoPoint] = field(default_factory=list)
    rounds_rolled_back: int = 0
    post_pnr: Optional[PostPnRResult] = None
    stop_reason: str = ""

    def summary(self) -> dict:
        return {"cap_mw": self.cap_mw, "feasible": self.feasible,
                "stop": self.stop_reason,
                "rolled_back": self.rounds_rolled_back,
                **{f"final_{k}": v for k, v in self.final.scaled().items()
                   if k != "round"}}


def evaluate_point(design: RoutedDesign, tm: TimingModel,
                   energy: EnergyParams, iterations: int,
                   stall_factor: float = 0.0,
                   rep: Optional[STAReport] = None,
                   round_index: int = 0,
                   sta_backend: str = "scalar",
                   device=None) -> ParetoPoint:
    """Project (freq, power, EDP, registers) for the design's current state.

    A thin wrapper over :func:`repro_torch.core.metrics.evaluate_design` — the
    single source of truth shared with the final report passes — so the
    projection the cap controller sees is byte-identical to the number the
    compile result will report.  Pass ``rep`` to reuse an STA report
    already computed for this state.
    """
    m = evaluate_design(design, tm, energy, iterations,
                        stall_factor=stall_factor, rep=rep,
                        sta_backend=sta_backend, device=device)
    return ParetoPoint(round=round_index,
                       critical_path_ns=m.critical_path_ns,
                       freq_mhz=m.freq_mhz,
                       power_mw=m.power_mw,
                       edp_js=m.edp_js,
                       registers_added=design.netlist.added_registers())


def power_capped_pipeline(design: RoutedDesign, tm: TimingModel,
                          energy: EnergyParams, iterations: int,
                          cap_mw: Optional[float] = None,
                          params: Optional[PostPnRParams] = None,
                          stall_factor: float = 0.0,
                          sta_backend: str = "scalar",
                          lowering=None, device=None) -> PowerCapResult:
    """Post-PnR pipelining under a power budget.

    Runs the Section V-D register-insertion loop, but after every
    insertion/branch-matching round re-evaluates the power model at the
    new achievable frequency; the round that pushes projected power above
    ``cap_mw`` is rolled back (via a :class:`DesignCheckpoint` of the last
    under-cap state) and the loop stops.  ``cap_mw=None`` (or ``inf``)
    disables the budget entirely: the inner loop runs exactly as the
    plain ``post_pnr`` pass would, and only the trajectory is recorded —
    results are byte-identical to the unconstrained flow.

    ``sta_backend`` / ``lowering`` flow to the inner loop and the
    per-round projections (see :mod:`repro_torch.core.sta_vec`): the loop
    keeps an incremental engine alive across rounds, on ``device`` for
    ``"torch"``; every report stays bit-identical to the scalar oracle.
    """
    cap = None if (cap_mw is None or not math.isfinite(cap_mw)) else cap_mw
    initial = evaluate_point(design, tm, energy, iterations,
                             stall_factor=stall_factor, round_index=0,
                             sta_backend=sta_backend, device=device)

    if cap is not None and initial.power_mw > cap:
        # Even the matched, un-pipelined input exceeds the cap: the pass
        # only ever *adds* registers (and therefore power), so report the
        # initial state untouched and flag the cap as infeasible.
        ppr = PostPnRResult(
            initial_ns=initial.critical_path_ns,
            final_ns=initial.critical_path_ns, iterations=0,
            registers_added=design.netlist.added_registers(),
            history=[initial.critical_path_ns],
            stop_reason="power_cap_infeasible")
        return PowerCapResult(cap_mw=cap_mw, feasible=False,
                              initial=initial, final=initial,
                              trajectory=[initial], post_pnr=ppr,
                              stop_reason="cap_infeasible")

    trajectory = [initial]
    rolled_back = 0
    ckpt = DesignCheckpoint.capture(design) if cap is not None else None

    def hook(d: RoutedDesign, rep: STAReport) -> bool:
        nonlocal ckpt, rolled_back
        pt = evaluate_point(d, tm, energy, iterations,
                            stall_factor=stall_factor, rep=rep,
                            round_index=len(trajectory))
        if cap is not None and pt.power_mw > cap:
            ckpt.restore(d)              # rewind the round that crossed
            rolled_back += 1
            return False
        trajectory.append(pt)
        if cap is not None:
            ckpt = DesignCheckpoint.capture(d)
        return True

    ppr = post_pnr_pipeline(design, tm, params, round_hook=hook,
                            sta_backend=sta_backend, lowering=lowering,
                            device=device)
    # Every stop path leaves the design in its last hook-accepted state
    # (reverted rounds never reach the hook), so the last trajectory point
    # is always the final state — no re-evaluation needed.
    final = trajectory[-1]
    reason = "power_cap" if ppr.stop_reason == "round_hook" else ppr.stop_reason
    return PowerCapResult(cap_mw=cap_mw, feasible=True, initial=initial,
                          final=final, trajectory=trajectory,
                          rounds_rolled_back=rolled_back, post_pnr=ppr,
                          stop_reason=reason)
