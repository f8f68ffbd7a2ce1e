"""In-compile design-space exploration (Pareto-frontier sweeps).

Cascade's whole pitch is the frequency/energy/resource trade-off of
pipelining (paper Section V-D, Table I), and the power-capped schedule
(Capstone, arXiv:2603.00909) showed a single budget is just one point on
that curve.  Getting the *curve* used to take N full compiles, each
repeating identical mapping / placement / routing work.  This module
sweeps the post-PnR knobs *inside one compile* instead:

* :class:`ExploreSpec` — the sweep grid (register budgets x power caps),
  the dominance objectives, and the selection policy for the point the
  compile result materializes.  An ordinary ``PassConfig`` field, so
  compile-cache entries key on every sub-field.
* :func:`evaluate_candidate` — one sweep point: fork the routed design
  (deep copy; the shared baseline is never mutated), run the Section V-D
  register-insertion loop under that point's budget/cap via
  :func:`~repro_torch.core.power_cap.power_capped_pipeline`, and evaluate
  the final state with the same :mod:`repro_torch.core.metrics` chain as
  the report
  passes — which is what makes every frontier point byte-identical to an
  independent full compile with that budget/cap.
* :func:`explore_frontier` — maps :func:`evaluate_candidate` over the
  grid (serially, or through a caller-supplied ``point_map`` — the batch
  API fans points out to thread/process pools), prunes dominated points,
  and restores the selected point's :class:`DesignCheckpoint` onto the
  design so the downstream report passes describe a real frontier point.

The registered pass wrapper (``"pareto_frontier"`` in the ``"explore"``
named schedule) lives in :mod:`repro_torch.core.passes`; the stage-artifact
cache (:mod:`repro_torch.core.cache`) makes the shared prefix — everything
through routing — a cache hit across sweeps.  ``device`` (the compiler's,
where the ``"torch"`` STA backend runs) travels in the keyword arguments of
:func:`evaluate_candidate`, so it reaches the worker processes a sweep
fans out to.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .netlist import RoutedDesign
from .post_pnr import DesignCheckpoint, PostPnRParams
from .power import EnergyParams
from .power_cap import ParetoPoint, PowerCapResult, evaluate_point, \
    power_capped_pipeline
from .timing_model import TimingModel

#: Objective direction table: a point dominates another when it is no
#: worse on every objective and strictly better on at least one.
OBJECTIVE_DIRECTIONS: Dict[str, str] = {
    "freq_mhz": "max",
    "power_mw": "min",
    "edp_js": "min",
    "critical_path_ns": "min",
    "registers_added": "min",
}

#: Selection policies for the point the compile result materializes.
SELECT_POLICIES: Dict[str, Tuple[str, str]] = {
    "min_edp": ("edp_js", "min"),
    "max_freq": ("freq_mhz", "max"),
    "min_power": ("power_mw", "min"),
}


@dataclass(frozen=True)
class ExploreSpec:
    """Declarative sweep grid for the ``pareto_frontier`` pass.

    ``register_budgets`` / ``power_caps_mw`` entries of ``None`` mean the
    config default (fabric-derived budget / unconstrained cap), so the
    default spec — one ``(None, None)`` point — degenerates to the plain
    post-PnR flow.  Frozen and tuple-valued so the spec hashes stably
    into the compile-cache key (every sub-field is audited in the cache
    tests).
    """

    register_budgets: Tuple[Optional[int], ...] = (None,)
    power_caps_mw: Tuple[Optional[float], ...] = (None,)
    #: Dominance objectives (see :data:`OBJECTIVE_DIRECTIONS`).
    objectives: Tuple[str, ...] = ("freq_mhz", "power_mw")
    #: Which non-dominated point the compile result materializes.
    select: str = "min_edp"

    def points(self) -> List[Tuple[Optional[int], Optional[float]]]:
        """The sweep grid: budgets x caps, in declaration order."""
        return [(b, c) for b in self.register_budgets
                for c in self.power_caps_mw]

    def validate(self) -> "ExploreSpec":
        if not self.register_budgets or not self.power_caps_mw:
            raise ValueError("ExploreSpec needs at least one budget and "
                             "one cap (use None for the defaults)")
        for obj in self.objectives:
            if obj not in OBJECTIVE_DIRECTIONS:
                raise ValueError(f"unknown objective {obj!r}; known: "
                                 f"{sorted(OBJECTIVE_DIRECTIONS)}")
        if len(self.objectives) < 2:
            raise ValueError("need >= 2 objectives for a frontier")
        if self.select not in SELECT_POLICIES:
            raise ValueError(f"unknown select policy {self.select!r}; "
                             f"known: {sorted(SELECT_POLICIES)}")
        return self


@dataclass
class FrontierPoint:
    """One evaluated sweep point: the knobs, the metrics, and a
    checkpoint of the pipelined state so the point can be materialized
    onto the routed design without re-running the insertion loop."""

    register_budget: Optional[int]
    power_cap_mw: Optional[float]
    critical_path_ns: float
    freq_mhz: float
    power_mw: float
    edp_js: float
    registers_added: int
    feasible: bool
    stop_reason: str
    checkpoint: DesignCheckpoint
    result: PowerCapResult
    dominated: bool = False

    def metric(self, name: str) -> float:
        if name not in OBJECTIVE_DIRECTIONS:
            raise KeyError(f"unknown objective {name!r}")
        return getattr(self, name)

    def scaled(self) -> dict:
        return {"register_budget": self.register_budget,
                "power_cap_mw": self.power_cap_mw,
                "critical_path_ns": round(self.critical_path_ns, 3),
                "freq_mhz": round(self.freq_mhz, 1),
                "power_mw": round(self.power_mw, 2),
                "edp_ujs": self.edp_js * 1e6,
                "registers_added": self.registers_added,
                "feasible": self.feasible,
                "stop": self.stop_reason,
                "dominated": self.dominated}


@dataclass
class ParetoFrontier:
    """Outcome of one in-compile sweep.

    ``points`` holds the non-dominated set (sorted by ascending
    frequency); ``dominated`` the pruned points, kept for ablation
    tables.  ``selected`` (a member of ``points``) is the point whose
    checkpoint was restored onto the design — the compile's reported
    STA/schedule/power describe exactly that point.  ``baseline`` is the
    routed, pre-pipelining state every point forked from.
    """

    spec: ExploreSpec
    points: List[FrontierPoint]
    dominated: List[FrontierPoint] = field(default_factory=list)
    selected: Optional[FrontierPoint] = None
    baseline: Optional[ParetoPoint] = None

    def all_points(self) -> List[FrontierPoint]:
        return list(self.points) + list(self.dominated)

    def point_for(self, register_budget: Optional[int],
                  power_cap_mw: Optional[float]) -> FrontierPoint:
        for p in self.all_points():
            if (p.register_budget == register_budget
                    and p.power_cap_mw == power_cap_mw):
                return p
        raise KeyError((register_budget, power_cap_mw))

    def rows(self) -> List[dict]:
        return [p.scaled() for p in self.all_points()]

    def summary(self) -> dict:
        return {"points": len(self.points) + len(self.dominated),
                "non_dominated": len(self.points),
                "objectives": list(self.spec.objectives),
                "select": self.spec.select,
                "selected": ({k: v for k, v in self.selected.scaled().items()
                              if k != "dominated"}
                             if self.selected is not None else None)}


def dominates(p: FrontierPoint, q: FrontierPoint,
              objectives: Sequence[str]) -> bool:
    """True when ``p`` is no worse than ``q`` on every objective and
    strictly better on at least one."""
    strictly = False
    for obj in objectives:
        pv, qv = p.metric(obj), q.metric(obj)
        if OBJECTIVE_DIRECTIONS[obj] == "max":
            pv, qv = -pv, -qv
        if pv > qv:
            return False
        if pv < qv:
            strictly = True
    return strictly


def pareto_prune(points: Sequence[FrontierPoint],
                 objectives: Sequence[str]
                 ) -> Tuple[List[FrontierPoint], List[FrontierPoint]]:
    """Split ``points`` into (non-dominated, dominated), marking each."""
    front: List[FrontierPoint] = []
    dom: List[FrontierPoint] = []
    for p in points:
        p.dominated = any(dominates(q, p, objectives)
                          for q in points if q is not p)
        (dom if p.dominated else front).append(p)
    front.sort(key=lambda p: (p.freq_mhz, -p.power_mw))
    return front, dom


def evaluate_candidate(design: RoutedDesign, tm: TimingModel,
                       energy: EnergyParams, iterations: int,
                       register_budget: Optional[int],
                       power_cap_mw: Optional[float], *,
                       stall_factor: float = 0.0,
                       max_iters: int = 400,
                       default_budget: Optional[int] = None,
                       copy_design: bool = True,
                       sta_backend: str = "scalar",
                       lowering=None, device=None) -> FrontierPoint:
    """Evaluate one (budget, cap) sweep point on a fork of ``design``.

    With ``copy_design`` (default) the input design is never mutated —
    the point runs on a private deep copy, so candidates can evaluate
    concurrently against one shared routed baseline.  A worker that
    already owns a private copy (the process backend unpickles one per
    task) passes ``copy_design=False`` to skip the redundant copy.

    The final metrics are re-evaluated on the finished state through
    :func:`~repro_torch.core.power_cap.evaluate_point` — the same
    single-source-of-truth chain the report passes use — so the returned
    numbers are byte-identical to an independent full compile with
    ``post_pnr_budget=register_budget`` / ``power_cap_mw=power_cap_mw``.

    ``lowering`` is the shared :class:`~repro_torch.core.sta_vec.LoweredSTA`
    of the routed baseline: it depends only on route structure, which
    every fork shares, so the frontier sweep lowers the design once and
    every point re-times through the same arrays (bit-identical to the
    scalar oracle either way).
    """
    d = copy.deepcopy(design) if copy_design else design
    budget = register_budget if register_budget is not None else default_budget
    params = PostPnRParams(max_iters=max_iters, register_budget=budget)
    res = power_capped_pipeline(d, tm, energy, iterations,
                                cap_mw=power_cap_mw, params=params,
                                stall_factor=stall_factor,
                                sta_backend=sta_backend, lowering=lowering,
                                device=device)
    final = evaluate_point(d, tm, energy, iterations,
                           stall_factor=stall_factor,
                           round_index=len(res.trajectory) - 1,
                           sta_backend=sta_backend, device=device)
    return FrontierPoint(
        register_budget=register_budget, power_cap_mw=power_cap_mw,
        critical_path_ns=final.critical_path_ns, freq_mhz=final.freq_mhz,
        power_mw=final.power_mw, edp_js=final.edp_js,
        registers_added=final.registers_added, feasible=res.feasible,
        stop_reason=res.stop_reason,
        checkpoint=DesignCheckpoint.capture(d), result=res)


#: ``point_map(design, tm, energy, iterations, points, kwargs)`` maps
#: :func:`evaluate_candidate` over the grid and returns the
#: :class:`FrontierPoint` list in grid order.  ``compile_batch`` supplies
#: pool-backed implementations; the default is serial.
PointMap = Callable[[RoutedDesign, TimingModel, EnergyParams, int,
                     List[Tuple[Optional[int], Optional[float]]], dict],
                    List[FrontierPoint]]


def map_points_serial(design: RoutedDesign, tm: TimingModel,
                      energy: EnergyParams, iterations: int,
                      points: List[Tuple[Optional[int], Optional[float]]],
                      kwargs: dict) -> List[FrontierPoint]:
    """The default (in-process, sequential) :data:`PointMap`."""
    return [evaluate_candidate(design, tm, energy, iterations, b, c, **kwargs)
            for b, c in points]


def select_point(front: Sequence[FrontierPoint],
                 policy: str) -> FrontierPoint:
    """Pick the materialized point from the non-dominated set.

    Infeasible points (caps below even the un-pipelined power) are only
    eligible when nothing feasible survived pruning."""
    metric, direction = SELECT_POLICIES[policy]
    pool = [p for p in front if p.feasible] or list(front)
    best = min if direction == "min" else max
    return best(pool, key=lambda p: p.metric(metric))


def explore_frontier(design: RoutedDesign, tm: TimingModel,
                     energy: EnergyParams, iterations: int,
                     spec: Optional[ExploreSpec] = None, *,
                     stall_factor: float = 0.0,
                     max_iters: int = 400,
                     default_budget: Optional[int] = None,
                     point_map: Optional[PointMap] = None,
                     sta_backend: str = "scalar",
                     device=None) -> ParetoFrontier:
    """Sweep the post-PnR design space and materialize the selected point.

    Evaluates every ``(register_budget, power_cap_mw)`` grid point on a
    fork of the routed ``design`` (one insertion loop per point; the
    expensive mapping/placement/routing prefix is shared by construction),
    prunes dominated points under ``spec.objectives``, and restores the
    ``spec.select`` winner's checkpoint onto ``design`` — the caller's
    design leaves this function *as* that frontier point.
    """
    spec = (spec or ExploreSpec()).validate()
    points = spec.points()
    baseline = evaluate_point(design, tm, energy, iterations,
                              stall_factor=stall_factor, round_index=0,
                              sta_backend=sta_backend, device=device)
    lowering = None
    if sta_backend != "scalar":
        from .sta_vec import lower_design
        lowering = lower_design(design, tm)   # one lowering, all points
    kwargs = {"stall_factor": stall_factor, "max_iters": max_iters,
              "default_budget": default_budget,
              "sta_backend": sta_backend, "lowering": lowering,
              "device": device}
    mapper = point_map or map_points_serial
    results = mapper(design, tm, energy, iterations, points, kwargs)
    if len(results) != len(points):
        raise RuntimeError(f"point map returned {len(results)} results "
                           f"for {len(points)} sweep points")
    front, dom = pareto_prune(results, spec.objectives)
    selected = select_point(front, spec.select)
    selected.checkpoint.restore(design)
    return ParetoFrontier(spec=spec, points=front, dominated=dom,
                          selected=selected, baseline=baseline)
