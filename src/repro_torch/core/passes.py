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

On top of the pass sequence sits an explicit **stage model**
(:data:`STAGE_ORDER`): every registered pass belongs to one of
``front_end -> mapped -> placed -> routed -> pipelined -> report``, and a
:class:`StageArtifact` snapshots the full artifact state of a
:class:`CompileContext` at any stage boundary.  Artifacts can be forked
(independent deep copies) and restored into fresh contexts, which is what
makes compiles *resumable*: the driver caches stage artifacts under prefix
content hashes (:func:`repro_torch.core.cache.stage_key`), so a compile
whose config differs only in post-PnR knobs resumes from the cached routed
design instead of repeating mapping/placement/routing — the mechanism
behind the in-compile design-space exploration of
:mod:`repro_torch.core.explore`.  The named schedules are ``"default"``,
``"power_capped"``, ``"explore"`` and the multi-app ``"multi"`` and
``"multi_power_capped"`` (a resident pinned to its region, with the
region fence).
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .apps import AppSpec
from .branch_delay import check_matched_netlist, check_predicated_regions
from .broadcast import broadcast_pipelining
from .dfg import CONTROL_PORT, DFG, PRED_PORT
from .explore import ExploreSpec, ParetoFrontier, PointMap, explore_frontier
from .flush import add_soft_flush
from .interconnect import Fabric, Region, SubFabric
from .metrics import DesignMetrics, evaluate_design
from .netlist import Netlist, RoutedDesign, extract_netlist
from .pipelining import compute_pipelining
from .place import PlaceParams, place
from .post_pnr import PostPnRParams, PostPnRResult, post_pnr_pipeline
from .power import EnergyParams, PowerReport
from .power_cap import PowerCapResult, power_capped_pipeline
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

    #: Optional pool-backed mapper for the ``pareto_frontier`` pass —
    #: supplied by ``compile_batch`` so frontier points fan out as
    #: sub-jobs; ``None`` means evaluate points serially in-process.
    point_map: Optional[PointMap] = None

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
    power_cap: Optional[PowerCapResult] = None
    frontier: Optional[ParetoFrontier] = None
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

#: The Capstone-style flow: identical to the default except the post-PnR
#: register insertion runs under a power budget (``PassConfig.power_cap_mw``;
#: no cap -> byte-identical results to the default schedule).
POWER_CAPPED_SCHEDULE = tuple(
    "power_capped_pipeline" if name == "post_pnr" else name
    for name in DEFAULT_SCHEDULE)

#: The design-space-exploration flow: the post-PnR pass is replaced by a
#: Pareto-frontier sweep over ``PassConfig.explore`` (budgets x caps); the
#: report passes then describe the sweep's selected point.
EXPLORE_SCHEDULE = tuple(
    "pareto_frontier" if name == "post_pnr" else name
    for name in DEFAULT_SCHEDULE)

#: The multi-app fabric-sharing flow (:mod:`repro_torch.core.multi`): the
#: default schedule plus a report-stage fence check asserting no placed node
#: or routed hop left the app's region.  The physical prefix (through the
#: ``routed`` boundary) is pass-for-pass identical to the default schedule,
#: so a region'd compile resumes from the *same* ``mapped`` stage artifacts
#: an app's ordinary compiles already cached (``PassConfig.region`` is a
#: ``placed``-stage field, so it keys the placed/routed artifacts but not
#: the mapped ones).  The per-app soft-flush pass never runs for a pack
#: resident — ``compile_multi`` hardens every resident config and
#: provides the one shared flush source instead.
_AFTER_MATCH = DEFAULT_SCHEDULE.index("match_check") + 1
MULTI_SCHEDULE = (DEFAULT_SCHEDULE[:_AFTER_MATCH] + ("region_fence_check",)
                  + DEFAULT_SCHEDULE[_AFTER_MATCH:])

#: A pack resident under a power budget: the ``"multi"`` flow with the
#: post-PnR register insertion replaced by ``power_capped_pipeline``.  The
#: online scheduler (:mod:`repro_torch.core.sched`) re-runs residents
#: through this when the *pack-level* cap is exceeded, handing each
#: resident its share of the budget — the physical prefix through the
#: ``routed`` boundary is pass-for-pass identical to ``"multi"``, so a
#: re-capped resident resumes from the routed stage artifact its uncapped
#: compile already cached and only repeats the budgeted pipelining.
MULTI_POWER_CAPPED_SCHEDULE = tuple(
    "power_capped_pipeline" if name == "post_pnr" else name
    for name in MULTI_SCHEDULE)

#: Declarative schedules by name — ``PassConfig.schedule`` may be one of
#: these strings instead of an explicit pass-name tuple.
NAMED_SCHEDULES: Dict[str, Sequence[str]] = {
    "default": DEFAULT_SCHEDULE,
    "power_capped": POWER_CAPPED_SCHEDULE,
    "explore": EXPLORE_SCHEDULE,
    "multi": MULTI_SCHEDULE,
    "multi_power_capped": MULTI_POWER_CAPPED_SCHEDULE,
}


# ---------------------------------------------------------------------------
# the stage model: boundaries, config-field provenance, snapshot artifacts
# ---------------------------------------------------------------------------

#: Compile stages, in flow order.  Every registered pass belongs to one;
#: a stage *boundary* is the point in a schedule after its last pass.
STAGE_ORDER = ("front_end", "mapped", "placed", "routed", "pipelined",
               "report")

#: Which stage each built-in pass belongs to.  Custom registered passes
#: are absent, which simply disables stage caching for schedules that
#: name them (an unknown pass could mutate anything).
STAGE_OF_PASS: Dict[str, str] = {
    "build": "front_end",
    "compute_pipelining": "mapped",
    "broadcast_pipelining": "mapped",
    "soft_flush": "mapped",
    "place": "placed",
    "route": "routed",
    "pnr": "routed",                 # composite place+route (compat)
    "post_pnr": "pipelined",
    "power_capped_pipeline": "pipelined",
    "pareto_frontier": "pipelined",
    "match_check": "report",
    "region_fence_check": "report",
    "sta": "report",
    "schedule_round2": "report",
    "power": "report",
    "verify": "report",
}

#: The *earliest* stage each ``PassConfig`` field influences.  A stage
#: artifact's cache key (:func:`repro_torch.core.cache.stage_key`) hashes
#: every field whose stage is at or before the boundary — so two configs
#: that differ only in later-stage knobs (post-PnR budgets, power caps,
#: explore grids) share the routed artifact, while a field that feeds an
#: earlier pass can never alias.  ``stage_key`` refuses configs with
#: unmapped fields, and a field-audit test holds the mapping to the
#: dataclass exactly.  (``schedule`` is keyed through the resolved
#: pass-name prefix instead of its raw value; ``post_pnr`` and
#: ``compute_pipelining`` are front-end because the ``build`` pass picks
#: the unroll factor from them.)  The device of the torch placer is not a
#: field: ``stage_key`` adds it from the ``placed`` stage on.
CONFIG_FIELD_STAGE: Dict[str, str] = {
    "compute_pipelining": "front_end",
    "post_pnr": "front_end",
    "low_unroll_dup": "front_end",
    "schedule": "front_end",         # keyed via the resolved prefix
    "rf_threshold": "mapped",
    "broadcast_pipelining": "mapped",
    "broadcast_fanout": "mapped",
    "broadcast_arity": "mapped",
    "harden_flush": "mapped",
    "placement_alpha": "placed",
    "placement_gamma": "placed",
    "seed": "placed",
    "place_moves": "placed",
    "region": "placed",              # first constrains placement sites
    "pnr_backend": "placed",         # kernels differ from placement on
    "pnr_replicas": "placed",
    "post_pnr_budget": "pipelined",
    "post_pnr_iters": "pipelined",
    "power_cap_mw": "pipelined",
    "explore": "pipelined",
    "sta_backend": "pipelined",      # bit-identical engines; routed shared
}


def stage_plan(schedule_names: Sequence[str]
               ) -> Optional[List[Tuple[str, int]]]:
    """Map a schedule to its stage boundaries: ``[(stage, end_index)]``.

    ``end_index`` is the schedule position just past the stage's last
    pass, i.e. ``schedule_names[:end_index]`` is the prefix a
    :class:`StageArtifact` for that stage embodies.  Returns ``None`` —
    stage caching disabled — when the schedule names a pass with no stage
    assignment, or runs stages out of flow order (a snapshot of such a
    schedule would not mean what the stage name promises).
    """
    stages: List[str] = []
    for name in schedule_names:
        s = STAGE_OF_PASS.get(name)
        if s is None:
            return None
        stages.append(s)
    idxs = [STAGE_ORDER.index(s) for s in stages]
    if idxs != sorted(idxs):
        return None
    plan: List[Tuple[str, int]] = []
    for i, s in enumerate(stages):
        if plan and plan[-1][0] == s:
            plan[-1] = (s, i + 1)
        else:
            plan.append((s, i + 1))
    return plan


#: The :class:`CompileContext` fields a :class:`StageArtifact` snapshots —
#: everything the passes produce (inputs like app/config/fabric/device stay
#: with the context the artifact is restored into).
ARTIFACT_FIELDS = (
    "unroll", "graph", "source_dfg", "copies", "netlist", "place_fabric",
    "place_timing", "placement", "design", "post_pnr", "power_cap",
    "frontier", "metrics", "sta", "schedule", "power",
    "pass_stats", "pass_times", "executed",
)


@dataclass
class StageArtifact:
    """A snapshot of a compile at a stage boundary, fit for fork/resume.

    ``state`` is one deep copy of every artifact field taken *jointly*,
    so intra-artifact aliasing survives (``design.netlist`` is the same
    object as the ``netlist`` field, exactly as in a live context — the
    post-PnR loop depends on that).  ``restore_into`` hands the receiving
    context another joint deep copy, so one artifact can seed any number
    of independent compiles; ``fork`` produces a sibling artifact that
    shares nothing.  This generalizes
    :class:`~repro_torch.core.post_pnr.DesignCheckpoint` — which rewinds
    only the register state the pipelining loop mutates — into the fork
    point for *any* post-boundary exploration.
    """

    stage: str
    prefix: Tuple[str, ...]          # the executed pass names snapshotted
    state: Dict[str, object] = field(default_factory=dict)

    @classmethod
    def capture(cls, ctx: "CompileContext", stage: str) -> "StageArtifact":
        state = copy.deepcopy({f: getattr(ctx, f) for f in ARTIFACT_FIELDS})
        return cls(stage=stage, prefix=tuple(ctx.executed), state=state)

    def fork(self) -> "StageArtifact":
        return StageArtifact(stage=self.stage, prefix=self.prefix,
                             state=copy.deepcopy(self.state))

    def restore_into(self, ctx: "CompileContext") -> None:
        for f, v in copy.deepcopy(self.state).items():
            setattr(ctx, f, v)


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

    def run(self, ctx: CompileContext, start: int = 0,
            until: Optional[int] = None,
            on_boundary: Optional[Callable[[str, CompileContext], None]]
            = None) -> CompileContext:
        """Run passes ``[start:until)`` (the whole schedule by default).

        ``start``/``until`` are schedule positions — stage boundary
        indices from :func:`stage_plan` — so the driver can resume a
        context restored from a :class:`StageArtifact` (``start`` = the
        artifact's boundary) or stop at one (``until``).  ``on_boundary``
        is invoked as ``(stage, ctx)`` after the last pass of each stage,
        which is where the driver captures artifacts.  The summary
        ``pass_stats`` keys are stamped only on runs that reach the end
        of the schedule.
        """
        boundaries: Dict[int, str] = {}
        if on_boundary is not None:
            boundaries = {end: stage
                          for stage, end in (stage_plan(self.names) or [])}
        stop = len(self.passes) if until is None else until
        for idx in range(start, stop):
            p = self.passes[idx]
            if p.enabled(ctx):
                t0 = time.perf_counter()
                stats = p.run(ctx)
                ctx.pass_times[p.name] = time.perf_counter() - t0
                ctx.executed.append(p.name)
                if stats is not None and p.stats_key is not None:
                    ctx.pass_stats[p.stats_key] = stats
            if idx + 1 in boundaries:
                on_boundary(boundaries[idx + 1], ctx)
        if until is None:
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
    """Software-routed flush broadcast baseline (Section VI).

    The gate deliberately never consults ``config.region``: region is a
    ``placed``-stage field, so a mapped-stage pass keying on it would
    alias mapped stage artifacts between region'd and region-less
    compiles.  ``compile_multi`` instead sets ``harden_flush=True`` on
    every resident config — a co-resident app does not own a flush
    source; the pack provides one *shared* broadcast spanning all
    residents (:func:`repro_torch.core.flush.shared_flush`)."""
    ctx.require(graph=ctx.graph)
    return add_soft_flush(ctx.graph)


def _stamp_window(nl, fabric: Fabric, region: Region) -> Region:
    """The low-unrolling stamp window anchored at a region's origin.

    Sizes the window against a fabric of the *region's* dimensions (same
    column pattern — the packer stride-aligns ``col0``, so global MEM
    columns land where the sizing assumes), then anchors it at the
    region's north-west corner so the placement stays in global
    coordinates inside the window the app owns.
    """
    probe = Fabric(rows=region.rows, cols=region.cols,
                   mem_col_stride=fabric.mem_col_stride,
                   tracks16=fabric.tracks16, tracks1=fabric.tracks1,
                   name=fabric.name)
    win = subfabric_for(nl, probe)
    return Region(region.row0, region.col0, win.rows, win.cols)


def _run_place(ctx: CompileContext):
    """Netlist extraction + criticality-driven placement (Eq. 1).

    With ``config.region`` set (multi-app fabric sharing) every site the
    annealer may propose lies inside the app's region; low-unrolling
    duplication stamps within the region instead of across the fabric.
    """
    ctx.require(graph=ctx.graph)
    app, cfg = ctx.app, ctx.config
    region = cfg.region
    ctx.source_dfg = ctx.graph.copy()
    nl = extract_netlist(ctx.graph)
    if cfg.low_unroll_dup and not app.sparse and region is None:
        fabric = subfabric_for(nl, ctx.fabric)
        ctx.copies = min(ctx.copies, max_copies(nl, ctx.fabric, fabric))
    elif (cfg.low_unroll_dup and not app.sparse
          and region.col0 % ctx.fabric.mem_col_stride == 0):
        win = _stamp_window(nl, ctx.fabric, region)
        fabric = ctx.fabric.subregion(win)
        ctx.copies = min(ctx.copies, max(1, (region.rows // win.rows)
                                         * (region.cols // win.cols)))
    else:
        fabric = (ctx.fabric if region is None
                  else ctx.fabric.subregion(region))
        if region is not None:
            # no stamp grid inside a stride-misaligned region: account for
            # exactly the one placed copy rather than claiming phantom ones
            ctx.copies = 1
    # a SubFabric is a masked *view* of ctx.fabric (same global geometry),
    # so its timing model is a value-identical subset of ctx.timing —
    # regenerating one per resident would be pure waste; only the
    # re-origined low-unroll window needs its own
    tm = (ctx.timing if (fabric is ctx.fabric
                         or isinstance(fabric, SubFabric))
          else generate_timing_model(fabric))
    pp = PlaceParams(alpha=cfg.placement_alpha, gamma=cfg.placement_gamma,
                     seed=cfg.seed, moves_per_node=cfg.place_moves,
                     backend=cfg.pnr_backend,
                     replicas=cfg.pnr_replicas or None)
    place_stats: dict = {}
    placement = place(nl, fabric, pp, stats=place_stats, region=region,
                      device=ctx.device)
    ctx.netlist, ctx.place_fabric, ctx.place_timing = nl, fabric, tm
    ctx.placement = placement
    return {"fabric": fabric.name, "copies": ctx.copies,
            "nodes": len(nl.nodes), "branches": len(nl.branches),
            "place": place_stats}


def _run_route(ctx: CompileContext):
    """Tree routing with PathFinder-style overuse negotiation.

    With ``config.region`` set, edges crossing the region boundary cost
    ``inf`` — a resident's nets can never borrow a neighbour's tracks."""
    ctx.require(netlist=ctx.netlist, placement=ctx.placement,
                place_fabric=ctx.place_fabric)
    design = route(ctx.netlist, ctx.placement, ctx.place_fabric,
                   RouteParams(backend=ctx.config.pnr_backend),
                   region=ctx.config.region, device=ctx.device)
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
    against the pre-split flow keep working; the named schedules use the
    separate ``place`` / ``route`` passes (distinct stage boundaries)."""
    stats = _run_place(ctx)
    stats["route"] = _run_route(ctx)
    return stats


def _post_pnr_params(ctx: CompileContext) -> PostPnRParams:
    """The inner-loop parameters; the fabric-derived default register
    budget scales with the area the app actually owns: the placed
    window's region when one is set (multi-app sharing), the whole
    placement fabric otherwise."""
    cfg = ctx.config
    budget = cfg.post_pnr_budget
    if budget is None:
        pf = ctx.place_fabric
        pf_region = getattr(pf, "region", None)
        area = (pf_region.area() if pf_region is not None
                else pf.rows * pf.cols)
        budget = area // 2
    return PostPnRParams(max_iters=cfg.post_pnr_iters, register_budget=budget)


def _iterations_and_stall(ctx: CompileContext):
    """Steady-state iteration count + sparse stall factor — the workload
    model shared by ``schedule_round2`` and the power-cap controller."""
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


@register_pass("power_capped_pipeline", stats_key="power_cap",
               gate=lambda ctx: ctx.config.post_pnr)
def _power_capped(ctx: CompileContext):
    """Post-PnR register insertion under a power budget (beyond the paper;
    Capstone, arXiv:2603.00909).  Drop-in replacement for ``post_pnr`` in
    the ``"power_capped"`` named schedule: with ``power_cap_mw`` unset the
    results are byte-identical to the unconstrained pass."""
    ctx.require(design=ctx.design, place_timing=ctx.place_timing)
    iters, stall = _iterations_and_stall(ctx)
    res = power_capped_pipeline(
        ctx.design, ctx.place_timing, ctx.energy, iters,
        cap_mw=ctx.config.power_cap_mw, params=_post_pnr_params(ctx),
        stall_factor=stall, sta_backend=ctx.config.sta_backend,
        device=ctx.device)
    ctx.post_pnr = res.post_pnr
    ctx.power_cap = res
    return res.summary()


@register_pass("pareto_frontier", stats_key="frontier",
               gate=lambda ctx: ctx.config.post_pnr)
def _pareto_frontier(ctx: CompileContext):
    """In-compile design-space exploration (beyond the paper).

    Sweeps post-PnR pipelining across ``PassConfig.explore``'s grid of
    (register budget, power cap) points — each forked from the routed
    design this pass receives, so the mapping/placement/routing prefix is
    computed once for the whole sweep — prunes dominated points, and
    materializes the selected point into the design the report passes
    will describe.  Point evaluation goes through ``ctx.point_map`` when
    the batch API supplies one (thread/process fan-out), else serial."""
    ctx.require(design=ctx.design, place_timing=ctx.place_timing)
    spec = ctx.config.explore
    if spec is None:
        # no grid declared: degenerate single-point sweep honouring the
        # config's cap, so schedule="explore" never silently ignores it
        spec = ExploreSpec(power_caps_mw=(ctx.config.power_cap_mw,))
    elif ctx.config.power_cap_mw is not None:
        raise ValueError(
            "PassConfig.power_cap_mw and PassConfig.explore are mutually "
            "exclusive under the 'explore' schedule — put the cap(s) in "
            "ExploreSpec.power_caps_mw instead")
    iters, stall = _iterations_and_stall(ctx)
    base = _post_pnr_params(ctx)
    fr = explore_frontier(ctx.design, ctx.place_timing, ctx.energy, iters,
                          spec, stall_factor=stall,
                          max_iters=base.max_iters,
                          default_budget=base.register_budget,
                          point_map=ctx.point_map,
                          sta_backend=ctx.config.sta_backend,
                          device=ctx.device)
    ctx.frontier = fr
    ctx.post_pnr = fr.selected.result.post_pnr
    ctx.power_cap = fr.selected.result
    return fr.summary()


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


@register_pass("region_fence_check", stats_key="region_fence",
               gate=lambda ctx: ctx.config.region is not None)
def _region_fence_check(ctx: CompileContext):
    """Invariant (multi-app fabric sharing): a co-resident app's design
    must stay strictly inside the region it owns — no placed node and no
    routed hop may touch a foreign sub-fabric's tiles."""
    ctx.require(design=ctx.design)
    region = ctx.config.region
    design = ctx.design
    stray_nodes = sorted(n for n, t in design.placement.items()
                         if not region.contains(t))
    stray_hops = sorted(
        str(rb.branch.key) for rb in design.routes.values()
        if any(not (region.contains(h.src) and region.contains(h.dst))
               for h in rb.hops))
    if stray_nodes or stray_hops:
        raise AssertionError(
            f"{ctx.app.name}: design escaped region {region}: "
            f"nodes {stray_nodes[:5]}, routes {stray_hops[:5]}")
    return {"nodes": len(design.placement), "routes": len(design.routes),
            "region": (region.row0, region.col0, region.rows, region.cols)}


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
