"""Staged pass pipeline — the Cascade compile flow as composable passes.

The paper's flow (Fig. 2) is a sequence of independently toggleable
techniques.  Every stage of ``CascadeCompiler.compile`` is a registered
:class:`Pass` over a shared :class:`CompileContext` artifact (DFG -> netlist
-> placement -> routed design -> reports), and :class:`PassPipeline`
sequences them from a declarative schedule, capturing per-pass wall time
and stats.

Adding a new technique is: write a function, decorate it with
``@register_pass``, and name it in a schedule (``PassConfig.schedule`` or
``PassPipeline(...)``) — no edits to the driver.

This package carries the default schedule only; the reference's
power-capped, exploration and multi-app passes and its stage-artifact model
are later slices of the port (``ROADMAP.md``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .apps import AppSpec
from .branch_delay import check_matched_netlist, check_predicated_regions
from .broadcast import broadcast_pipelining
from .dfg import CONTROL_PORT, DFG, PRED_PORT
from .flush import add_soft_flush
from .interconnect import Fabric
from .metrics import DesignMetrics, evaluate_design
from .netlist import Netlist, RoutedDesign, extract_netlist
from .pipelining import compute_pipelining
from .place import PlaceParams, place
from .post_pnr import PostPnRParams, PostPnRResult, post_pnr_pipeline
from .power import EnergyParams, PowerReport
from .route import RouteParams, route
from .schedule import Schedule
from .sim import equivalent
from .sta import STAReport
from .timing_model import TimingModel, generate_timing_model
from .unroll import max_copies, subfabric_for


# ---------------------------------------------------------------------------
# the artifact every pass reads/writes
# ---------------------------------------------------------------------------


@dataclass
class CompileContext:
    """Mutable state threaded through the pipeline.

    Inputs (set by the driver) come first; artifacts are filled in by the
    passes in schedule order.  A pass that needs an artifact its
    predecessors produce simply reads the field — ``require`` raises if a
    schedule runs a pass before its inputs exist.
    """

    app: AppSpec
    config: "PassConfig"                     # forward ref: compiler.PassConfig
    fabric: Fabric
    timing: TimingModel
    energy: EnergyParams
    unroll: Optional[int] = None
    verify: bool = False
    device: object = None                    # of the "torch" backends

    # artifacts ------------------------------------------------------------
    graph: Optional[DFG] = None              # after "build"
    source_dfg: Optional[DFG] = None         # snapshot before extraction
    copies: int = 1
    netlist: Optional[Netlist] = None
    place_fabric: Optional[Fabric] = None    # effective (possibly sub-) fabric
    place_timing: Optional[TimingModel] = None
    placement: Optional[dict] = None
    design: Optional[RoutedDesign] = None
    post_pnr: Optional[PostPnRResult] = None
    metrics: Optional[DesignMetrics] = None
    sta: Optional[STAReport] = None
    schedule: Optional[Schedule] = None
    power: Optional[PowerReport] = None

    # bookkeeping ----------------------------------------------------------
    pass_stats: Dict[str, object] = field(default_factory=dict)
    pass_times: Dict[str, float] = field(default_factory=dict)
    executed: List[str] = field(default_factory=list)

    def require(self, **fields) -> None:
        missing = [k for k, v in fields.items() if v is None]
        if missing:
            raise RuntimeError(
                f"pass ordering error: missing artifact(s) {missing} — "
                f"executed so far: {self.executed}")


# ---------------------------------------------------------------------------
# Pass protocol + registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Pass:
    """One named stage: ``run(ctx)`` mutates the context and may return a
    stats object, recorded under ``stats_key`` in ``ctx.pass_stats``."""

    name: str
    run: Callable[[CompileContext], object]
    gate: Optional[Callable[[CompileContext], bool]] = None
    stats_key: Optional[str] = None

    def enabled(self, ctx: CompileContext) -> bool:
        return True if self.gate is None else bool(self.gate(ctx))


PASS_REGISTRY: Dict[str, Pass] = {}


def register_pass(name: str, gate: Optional[Callable[[CompileContext], bool]] = None,
                  stats_key: Optional[str] = None):
    """Decorator registering a function as a named pass."""
    def deco(fn: Callable[[CompileContext], object]) -> Pass:
        if name in PASS_REGISTRY:
            raise ValueError(f"pass {name!r} already registered")
        p = Pass(name=name, run=fn, gate=gate, stats_key=stats_key)
        PASS_REGISTRY[name] = p
        return p
    return deco


# ---------------------------------------------------------------------------
# the pipeline driver
# ---------------------------------------------------------------------------

#: The paper's flow, in order.  ``PassConfig`` gates decide which of these
#: actually run for a given compile.
DEFAULT_SCHEDULE = (
    "build",
    "compute_pipelining",
    "broadcast_pipelining",
    "soft_flush",
    "place",
    "route",
    "post_pnr",
    "match_check",
    "sta",
    "schedule_round2",
    "power",
    "verify",
)

#: Declarative schedules by name — ``PassConfig.schedule`` may be one of
#: these strings instead of an explicit pass-name tuple.
NAMED_SCHEDULES: Dict[str, Sequence[str]] = {
    "default": DEFAULT_SCHEDULE,
}


def resolve_schedule(schedule) -> Sequence[str]:
    """Resolve a ``PassConfig.schedule`` value to a pass-name sequence.

    ``None`` means the default flow; a string names an entry of
    :data:`NAMED_SCHEDULES`; anything else is taken as an explicit
    sequence of pass names.
    """
    if schedule is None:
        return DEFAULT_SCHEDULE
    if isinstance(schedule, str):
        if schedule not in NAMED_SCHEDULES:
            raise KeyError(f"unknown named schedule {schedule!r}; "
                           f"known: {sorted(NAMED_SCHEDULES)}")
        return NAMED_SCHEDULES[schedule]
    return schedule


class PassPipeline:
    """An ordered sequence of passes with per-pass wall-time capture."""

    def __init__(self, passes: Sequence[Union[str, Pass]] = DEFAULT_SCHEDULE):
        self.passes: List[Pass] = []
        for p in passes:
            if isinstance(p, str):
                if p not in PASS_REGISTRY:
                    raise KeyError(
                        f"unknown pass {p!r}; registered: "
                        f"{sorted(PASS_REGISTRY)}")
                p = PASS_REGISTRY[p]
            self.passes.append(p)

    @classmethod
    def from_config(cls, config) -> "PassPipeline":
        """Build the schedule a ``PassConfig`` declares (or the default)."""
        return cls(resolve_schedule(config.schedule))

    @property
    def names(self) -> List[str]:
        return [p.name for p in self.passes]

    def run(self, ctx: CompileContext) -> CompileContext:
        """Run every enabled pass in order, then stamp the summary
        ``pass_stats`` keys (the executed pass names and their times)."""
        for p in self.passes:
            if p.enabled(ctx):
                t0 = time.perf_counter()
                stats = p.run(ctx)
                ctx.pass_times[p.name] = time.perf_counter() - t0
                ctx.executed.append(p.name)
                if stats is not None and p.stats_key is not None:
                    ctx.pass_stats[p.stats_key] = stats
        ctx.pass_stats["pipeline"] = list(ctx.executed)
        ctx.pass_stats["pass_times"] = dict(ctx.pass_times)
        return ctx


# ---------------------------------------------------------------------------
# the Cascade passes (paper Fig. 2, one registered pass per stage)
# ---------------------------------------------------------------------------


@register_pass("build")
def _build(ctx: CompileContext):
    """Graph construction with low-unrolling duplication (Section V-E)."""
    app, cfg = ctx.app, ctx.config
    if ctx.unroll is None:
        ctx.unroll = (app.unroll if (cfg.compute_pipelining or cfg.post_pnr)
                      else (app.unroll_baseline or app.unroll))
    if cfg.low_unroll_dup and not app.sparse:
        ctx.graph = app.build(1)
        ctx.copies = ctx.unroll
    else:
        ctx.graph = app.build(ctx.unroll)
        ctx.copies = 1


@register_pass("compute_pipelining", stats_key="compute",
               gate=lambda ctx: ctx.config.compute_pipelining or ctx.app.sparse)
def _compute(ctx: CompileContext):
    """PE input registers + branch matching + RF collapse (Section V-A).

    Sparse apps carry input FIFOs by construction: compute pipelining is
    always on for them (Section VIII-D)."""
    ctx.require(graph=ctx.graph)
    if ctx.app.sparse:
        return {"sparse_default_fifos": True}
    return compute_pipelining(ctx.graph, ctx.config.rf_threshold)


@register_pass("broadcast_pipelining", stats_key="broadcast",
               gate=lambda ctx: (ctx.config.broadcast_pipelining
                                 and not ctx.app.sparse))
def _broadcast(ctx: CompileContext):
    """High-fanout net tree pipelining (Section V-B)."""
    ctx.require(graph=ctx.graph)
    return broadcast_pipelining(ctx.graph, ctx.config.broadcast_fanout,
                                ctx.config.broadcast_arity)


@register_pass("soft_flush", stats_key="flush_fanout",
               gate=lambda ctx: (not ctx.config.harden_flush
                                 and not ctx.app.sparse))
def _soft_flush(ctx: CompileContext):
    """Software-routed flush broadcast baseline (Section VI)."""
    ctx.require(graph=ctx.graph)
    return add_soft_flush(ctx.graph)


def _run_place(ctx: CompileContext):
    """Netlist extraction + criticality-driven placement (Eq. 1).

    Low-unrolling duplication places one copy on the smallest sub-fabric
    that holds it and stamps the rest across the fabric."""
    ctx.require(graph=ctx.graph)
    app, cfg = ctx.app, ctx.config
    ctx.source_dfg = ctx.graph.copy()
    nl = extract_netlist(ctx.graph)
    if cfg.low_unroll_dup and not app.sparse:
        fabric = subfabric_for(nl, ctx.fabric)
        ctx.copies = min(ctx.copies, max_copies(nl, ctx.fabric, fabric))
    else:
        fabric = ctx.fabric
    tm = (ctx.timing if fabric is ctx.fabric
          else generate_timing_model(fabric))
    pp = PlaceParams(alpha=cfg.placement_alpha, gamma=cfg.placement_gamma,
                     seed=cfg.seed, moves_per_node=cfg.place_moves,
                     backend=cfg.pnr_backend,
                     replicas=cfg.pnr_replicas or None)
    place_stats: dict = {}
    placement = place(nl, fabric, pp, stats=place_stats, device=ctx.device)
    ctx.netlist, ctx.place_fabric, ctx.place_timing = nl, fabric, tm
    ctx.placement = placement
    return {"fabric": fabric.name, "copies": ctx.copies,
            "nodes": len(nl.nodes), "branches": len(nl.branches),
            "place": place_stats}


def _run_route(ctx: CompileContext):
    """Tree routing with PathFinder-style overuse negotiation."""
    ctx.require(netlist=ctx.netlist, placement=ctx.placement,
                place_fabric=ctx.place_fabric)
    design = route(ctx.netlist, ctx.placement, ctx.place_fabric,
                   RouteParams(backend=ctx.config.pnr_backend),
                   device=ctx.device)
    design.unroll_copies = ctx.copies
    design.source_dfg = ctx.source_dfg
    ctx.design = design
    return {"wirelength": design.total_wirelength(),
            "routes": len(design.routes)}


#: ``place`` keeps the historical ``"pnr"`` stats bucket (its dict carries
#: the placement stats consumers read as ``pass_stats["pnr"]["place"]``).
register_pass("place", stats_key="pnr")(_run_place)
register_pass("route", stats_key="route")(_run_route)


@register_pass("pnr", stats_key="pnr")
def _pnr(ctx: CompileContext):
    """Composite place+route — kept so explicit custom schedules written
    against the pre-split flow keep working; the default schedule uses the
    separate ``place`` / ``route`` passes."""
    stats = _run_place(ctx)
    stats["route"] = _run_route(ctx)
    return stats


def _post_pnr_params(ctx: CompileContext) -> PostPnRParams:
    """The inner-loop parameters; the fabric-derived default register
    budget is half the area of the placement fabric."""
    cfg = ctx.config
    budget = cfg.post_pnr_budget
    if budget is None:
        budget = ctx.place_fabric.rows * ctx.place_fabric.cols // 2
    return PostPnRParams(max_iters=cfg.post_pnr_iters, register_budget=budget)


def _iterations_and_stall(ctx: CompileContext):
    """Steady-state iteration count + sparse stall factor — the workload
    model of ``schedule_round2``."""
    iters = ctx.app.iterations_for(
        ctx.copies if ctx.copies > 1 else ctx.unroll)
    stall = 0.12 if ctx.app.sparse else 0.0
    return iters, stall


@register_pass("post_pnr", stats_key="post_pnr",
               gate=lambda ctx: ctx.config.post_pnr)
def _post_pnr(ctx: CompileContext):
    """Post-PnR register insertion on the routed design (Section V-D)."""
    ctx.require(design=ctx.design, place_timing=ctx.place_timing)
    ppr = post_pnr_pipeline(ctx.design, ctx.place_timing,
                            _post_pnr_params(ctx),
                            sta_backend=ctx.config.sta_backend,
                            device=ctx.device)
    ctx.post_pnr = ppr
    return {"initial_ns": ppr.initial_ns, "final_ns": ppr.final_ns,
            "registers_added": ppr.registers_added, "stop": ppr.stop_reason}


@register_pass("match_check", gate=lambda ctx: not ctx.app.sparse)
def _match_check(ctx: CompileContext):
    """Invariant: branch delays must stay matched through the whole flow.
    For predicated graphs, additionally pins the per-merge-point view:
    both arms and the predicate of every predicated region must arrive on
    the same cycle (a targeted diagnostic for the PRED_PORT band)."""
    ctx.require(netlist=ctx.netlist)
    if not check_matched_netlist(ctx.netlist):
        raise AssertionError(
            f"{ctx.app.name}: branch delays unmatched after flow")
    if any(PRED_PORT <= b.port < CONTROL_PORT for b in ctx.netlist.branches):
        problems = check_predicated_regions(ctx.netlist.to_dfg())
        if problems:
            raise AssertionError(
                f"{ctx.app.name}: predicated regions unbalanced after "
                f"flow: " + "; ".join(problems))


def _metrics_of(ctx: CompileContext) -> DesignMetrics:
    """The design's report metrics, computed (once) through the single
    source of truth :func:`repro_torch.core.metrics.evaluate_design`."""
    if ctx.metrics is None:
        ctx.require(design=ctx.design, place_timing=ctx.place_timing)
        iters, stall = _iterations_and_stall(ctx)
        ctx.metrics = evaluate_design(ctx.design, ctx.place_timing,
                                      ctx.energy, iters, stall_factor=stall,
                                      sta_backend=ctx.config.sta_backend,
                                      device=ctx.device)
    return ctx.metrics


@register_pass("sta")
def _sta(ctx: CompileContext):
    """Application-level static timing analysis (Section IV)."""
    ctx.sta = _metrics_of(ctx).sta


@register_pass("schedule_round2")
def _schedule(ctx: CompileContext):
    """Second scheduling round over the pipelined design (Section VII)."""
    ctx.schedule = _metrics_of(ctx).schedule


@register_pass("power")
def _power(ctx: CompileContext):
    """Power / energy / EDP report (Section VIII)."""
    ctx.power = _metrics_of(ctx).power


@register_pass("verify", stats_key="verified",
               gate=lambda ctx: ctx.verify and not ctx.app.sparse)
def _verify(ctx: CompileContext):
    """Cycle-exact equivalence of the routed design vs the source app."""
    ctx.require(design=ctx.design)
    app, cfg = ctx.app, ctx.config
    ref = app.build(1 if (cfg.low_unroll_dup and not app.sparse)
                    else ctx.unroll)
    rng = np.random.default_rng(0)
    ins = {n: rng.integers(0, 255, size=48).tolist()
           for n, nd in ref.nodes.items() if nd.kind == "input"}
    final = ctx.design.netlist.to_dfg()
    if not equivalent(ref, final, ins, n=32):
        raise AssertionError(f"{app.name}: pipelined design is not "
                             f"functionally equivalent to the source app")
    return True
