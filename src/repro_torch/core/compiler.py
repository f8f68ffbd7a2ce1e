"""CascadeCompiler — the end-to-end application compiler of paper Fig. 2.

    app spec -> DFG -> [compute pipelining] -> [broadcast pipelining]
             -> netlist -> place (Eq. 1, alpha) -> route -> [post-PnR
             pipelining] -> schedule round 2 -> bitstream/report

Every Cascade technique is individually toggleable (``PassConfig``) so the
paper's incremental figures can be reproduced, and the flush broadcast can
be routed in software (baseline) or hardened (Section VI).

The flow itself lives in :mod:`repro_torch.core.passes` as a staged pass
pipeline; ``compile()`` is a thin driver that builds a
:class:`CompileContext`, runs the schedule declared by the config, and
memoizes results in a content-hash
:class:`~repro_torch.core.cache.CompileCache` (and stage artifacts in a
second one, so a compile differing only in later knobs resumes from the
deepest shared stage).  ``compile_batch()`` compiles many (app, config)
pairs concurrently — across *processes* by default when more than one job
misses the cache, since the SA place/route inner loop is pure Python and
GIL-bound — deduplicating identical jobs through the cache.
``compile_multi()`` packs several apps into disjoint regions of one shared
fabric and compiles the residents through ``compile_batch``.
"""

from __future__ import annotations

import copy
import multiprocessing
import pickle
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass, field, replace as dc_replace
from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch

from ..device import resolve_device
from .apps import AppSpec
from .cache import (DEFAULT_CACHE, DEFAULT_STAGE_CACHE, CompileCache,
                    app_fingerprint, compile_key, stage_key)
from .config import worker_count
from .explore import (ExploreSpec, ParetoFrontier, evaluate_candidate,
                      map_points_serial)
from .interconnect import Fabric, Region
from .multi import (MultiAppResult, assemble_pack, pack_regions,
                    validate_regions)
from .netlist import Netlist, RoutedDesign, extract_netlist
from .passes import (STAGE_ORDER, CompileContext, PassPipeline, StageArtifact,
                     resolve_schedule, stage_plan)
from .post_pnr import PostPnRResult
from .power import EnergyParams, PowerReport
from .power_cap import PowerCapResult
from .schedule import Schedule
from .sta import STAReport
from .timing_model import TimingModel, generate_timing_model


@dataclass
class PassConfig:
    """Declarative compile configuration — every Cascade technique toggle,
    with the reference's defaults.

    All fields participate in the compile-cache content hash
    (:func:`repro_torch.core.cache.compile_key` hashes ``asdict(config)``),
    and each has a stage in ``passes.CONFIG_FIELD_STAGE``; the cache tests
    hold both to the dataclass.
    """

    compute_pipelining: bool = True
    rf_threshold: int = 4
    broadcast_pipelining: bool = True
    broadcast_fanout: int = 4
    broadcast_arity: int = 4
    placement_alpha: float = 1.6      # Cascade criticality exponent
    placement_gamma: float = 0.3
    post_pnr: bool = True
    post_pnr_budget: Optional[int] = None   # None -> fabric-derived default
    post_pnr_iters: int = 400
    low_unroll_dup: bool = True
    harden_flush: bool = True
    seed: int = 0
    place_moves: int = 400            # per node
    #: Place-and-route kernel backend (``repro_torch.core.config.
    #: PNR_BACKENDS``: ``"scalar"`` / ``"numpy"`` / ``"torch"``, the last on
    #: the compiler's device).  Drivers copy ``CASCADE_PNR_BACKEND`` here —
    #: the compiler never reads the env var itself.
    pnr_backend: str = "numpy"
    #: Parallel-tempering replica count for the torch placer (0 = the
    #: size-adaptive default); ignored by the scalar/numpy backends.
    pnr_replicas: int = 0
    #: Timing-engine backend (``repro_torch.core.config.STA_BACKENDS``:
    #: ``"scalar"`` / ``"numpy"`` / ``"torch"``, the last on the
    #: compiler's device).  All backends are bit-identical (see
    #: :mod:`repro_torch.core.sta_vec`).  Drivers copy
    #: ``CASCADE_STA_BACKEND`` here.
    sta_backend: str = "scalar"
    #: Power budget (mW) for the ``power_capped_pipeline`` pass; ``None``
    #: means unconstrained (byte-identical to the plain post-PnR pass).
    power_cap_mw: Optional[float] = None
    #: Sweep grid for the ``pareto_frontier`` pass (``"explore"``
    #: schedule); ``None`` falls back to the single-point default spec.
    explore: Optional[ExploreSpec] = None
    #: Pass schedule: ``None`` -> default flow; a named schedule string
    #: (``"default"`` / ``"power_capped"`` / ``"explore"`` / ``"multi"``,
    #: see ``repro_torch.core.passes.NAMED_SCHEDULES``); or an explicit
    #: tuple of registered pass names.
    schedule: Union[str, Tuple[str, ...], None] = None
    #: Rectangular sub-fabric this app owns on a shared, multi-app fabric
    #: (``None`` = the whole fabric).  Set by ``compile_multi``; placement
    #: site pools and routing edge costs never leave it, and it keys the
    #: placed/routed stage artifacts (but not the shared ``mapped`` ones).
    region: Optional[Region] = None

    @classmethod
    def unpipelined(cls, **kw) -> "PassConfig":
        """The baseline compiler: no pipelining techniques at all."""
        return cls(compute_pipelining=False, broadcast_pipelining=False,
                   placement_alpha=1.0, post_pnr=False, low_unroll_dup=False,
                   harden_flush=False, **kw)

    @classmethod
    def full(cls, **kw) -> "PassConfig":
        return cls(**kw)

    @classmethod
    def power_capped(cls, cap_mw: Optional[float], **kw) -> "PassConfig":
        """The full flow with post-PnR pipelining bounded by ``cap_mw``."""
        return cls(power_cap_mw=cap_mw, schedule="power_capped", **kw)

    @classmethod
    def frontier(cls, spec: Optional[ExploreSpec] = None,
                 **kw) -> "PassConfig":
        """The full flow with in-compile design-space exploration: sweep
        ``spec``'s (register budget, power cap) grid from one routed
        design and report the Pareto frontier."""
        return cls(explore=spec or ExploreSpec(), schedule="explore", **kw)


@dataclass
class CompileResult:
    app: AppSpec
    config: PassConfig
    design: RoutedDesign
    sta: STAReport
    schedule: Schedule
    power: PowerReport
    pass_stats: Dict[str, object] = field(default_factory=dict)
    post_pnr: Optional[PostPnRResult] = None
    power_cap: Optional[PowerCapResult] = None
    frontier: Optional[ParetoFrontier] = None
    compile_seconds: float = 0.0
    cache_hit: bool = False

    def summary(self) -> dict:
        return {
            "app": self.app.name,
            "critical_path_ns": round(self.sta.critical_path_ns, 3),
            **self.power.scaled(),
            "registers": self.design.physical_register_count(),
            "unroll_copies": self.design.unroll_copies,
        }


#: One batch job: ``(app, config)`` — optionally ``(app, config, unroll)``.
CompileJob = Union[Tuple[AppSpec, Optional[PassConfig]],
                   Tuple[AppSpec, Optional[PassConfig], Optional[int]]]


@dataclass
class MultiAppSpec:
    """N co-resident applications to pack onto one shared fabric.

    ``jobs`` are ordinary ``(app, config)`` pairs (``None`` config means
    the default full flow); ``regions`` optionally pins each app to an
    explicit :class:`~repro_torch.core.interconnect.Region` (parallel to
    ``jobs``) instead of letting :func:`repro_torch.core.multi.pack_regions`
    size and pack the strips automatically.
    """

    jobs: Tuple[Tuple[AppSpec, Optional[PassConfig]], ...]
    regions: Optional[Tuple[Region, ...]] = None
    name: str = "multi"

    @classmethod
    def of(cls, *apps: AppSpec, config: Optional[PassConfig] = None,
           **kw) -> "MultiAppSpec":
        """Spec from bare apps sharing one config (or the default)."""
        return cls(jobs=tuple((a, config) for a in apps), **kw)

    def normalized(self) -> List[Tuple[AppSpec, PassConfig]]:
        for job in self.jobs:
            # accept compile_batch-style (app, config, None) 3-tuples, but
            # reject an actual unroll override the pack would ignore
            if len(job) > 2 and job[2] is not None:
                raise ValueError(
                    f"MultiAppSpec jobs are (app, config) pairs; per-job "
                    f"unroll overrides are not supported (got "
                    f"unroll={job[2]!r} for {job[0].name!r}) — set "
                    f"AppSpec.unroll instead")
        out = [(job[0], (job[1] if len(job) > 1 and job[1] is not None
                         else PassConfig()))
               for job in self.jobs]
        names = [app.name for app, _ in out]
        if len(set(names)) != len(names):
            raise ValueError(f"resident app names must be unique: {names}")
        if self.regions is not None and len(self.regions) != len(out):
            raise ValueError(
                f"{len(self.regions)} explicit regions for {len(out)} apps")
        for app, cfg in out:
            if cfg.region is not None:
                raise ValueError(
                    f"{app.name}: PassConfig.region is assigned by "
                    f"compile_multi — use MultiAppSpec.regions to pin one")
            if cfg.schedule not in (None, "default", "multi"):
                raise ValueError(
                    f"{app.name}: compile_multi runs the 'multi' schedule "
                    f"per resident; schedule={cfg.schedule!r} would be "
                    f"silently discarded — leave it unset")
        return out

def resident_config(cfg: "PassConfig", region: Region,
                    power_cap_mw: Optional[float] = None) -> "PassConfig":
    """The config a pack resident actually compiles with.

    Residents always harden their own flush (the pack provides the one
    shared source; a mapped-stage soft flush keyed on region would alias
    mapped artifacts) and run the ``"multi"`` schedule pinned to their
    :class:`~repro_torch.core.interconnect.Region`.  With ``power_cap_mw`` the
    resident runs ``"multi_power_capped"`` instead — same physical prefix
    through the ``routed`` boundary, so re-capping an already-compiled
    resident resumes from its routed stage artifact and only re-runs the
    budgeted post-PnR pipelining.  Shared by ``compile_multi`` and the
    online scheduler (:mod:`repro_torch.core.sched`).
    """
    if power_cap_mw is not None:
        return dc_replace(cfg, region=region, schedule="multi_power_capped",
                          harden_flush=True, power_cap_mw=power_cap_mw)
    return dc_replace(cfg, region=region, schedule="multi",
                      harden_flush=True)


#: ``compile_batch`` backends.  "auto" picks "process" when more than one
#: job misses every cache tier (the only case where multi-core pays for the
#: fork/pickle overhead), else "thread".
BATCH_BACKENDS = ("auto", "thread", "process")


def _runs_torch(cfg: "PassConfig") -> bool:
    """Whether a compile under ``cfg`` runs torch ops (a torch engine)."""
    return "torch" in (cfg.pnr_backend, cfg.sta_backend)


def _process_context(runs_torch: bool = False):
    """Start method for the process backend.

    ``fork`` is cheap, but a forked child cannot use CUDA once the parent
    has initialised it, and forking a process with live threads risks
    deadlocking the child on a lock held at fork time: a child that runs
    torch ops hangs in torch's OpenMP pool once the parent has used it.
    So ``fork`` is used only on Linux (macOS frameworks start threads at
    import), only while the parent has not initialised CUDA, only while no
    multithreaded runtime (jax; tested by name, never imported here) is
    loaded, and only for work that runs no torch op (``runs_torch``: the
    host backends); otherwise ``spawn`` (a fresh interpreter, slower to
    start, that may use the card).
    """
    if (sys.platform == "linux" and not runs_torch
            and not torch.cuda.is_initialized()
            and "jax" not in sys.modules):
        return multiprocessing.get_context("fork")
    return multiprocessing.get_context("spawn")


class BatchCompileError(RuntimeError):
    """A ``compile_batch`` job (or frontier sweep point) failed.

    Wraps the worker's exception with the job index, app name, and — for
    frontier fan-out — the sweep point, so a failing point in a
    thousand-job sweep reports *which* job died instead of a bare pickled
    traceback.  The original exception is chained as ``__cause__``.
    """

    def __init__(self, message: str, job_index: Optional[int] = None,
                 app_name: Optional[str] = None):
        super().__init__(message)
        self.job_index = job_index
        self.app_name = app_name


def _wrap_job_error(exc: Exception, job_index: int, app: AppSpec,
                    where: str) -> BatchCompileError:
    err = BatchCompileError(
        f"batch job {job_index} (app {app.name!r}) failed {where}: "
        f"{type(exc).__name__}: {exc}", job_index=job_index,
        app_name=app.name)
    err.__cause__ = exc
    return err


def _compile_job_in_worker(job_index: int, app: AppSpec, cfg: "PassConfig",
                           unroll: Optional[int], verify: bool,
                           fabric: Fabric, timing: TimingModel,
                           energy: EnergyParams, device=None) -> bytes:
    """One compile inside a worker process; returns the pickled result.

    The worker never touches a cache (the parent established the miss and
    merges the returned result into its own tiers), so per-worker state
    reduces to the deterministic compile itself — which is what makes the
    process backend byte-identical to serial compiles.  ``device`` is the
    parent compiler's, so the torch engines run where a serial compile
    would run them.  Returning the
    pickle (rather than the object) lets the parent materialize the cache
    entry and the caller's result as two independent objects for the cost
    of two cheap loads instead of an expensive deep copy.  Failures cross
    back as :class:`BatchCompileError` carrying the job index, app name,
    and the worker-side traceback in the message.
    """
    compiler = CascadeCompiler(fabric=fabric, timing=timing, energy=energy,
                               cache=CompileCache(maxsize=1),
                               stage_cache=CompileCache(maxsize=1),
                               device=device)
    try:
        result = compiler.compile(app, cfg, unroll=unroll, verify=verify,
                                  use_cache=False)
    except Exception as e:
        import traceback
        raise BatchCompileError(
            f"batch job {job_index} (app {app.name!r}) failed in process "
            f"worker: {type(e).__name__}: {e}\n{traceback.format_exc()}",
            job_index=job_index, app_name=app.name) from None
    return pickle.dumps(result)


def _frontier_fanout(cfg: "PassConfig") -> int:
    """How many sweep points the ``pareto_frontier`` pass would evaluate
    for this config — 0 when its schedule doesn't run the pass (unknown
    schedule names report 0 here and fail loudly at compile time)."""
    try:
        sched = resolve_schedule(cfg.schedule)
    except KeyError:
        return 0
    if "pareto_frontier" not in sched or not cfg.post_pnr:
        return 0
    return len((cfg.explore or ExploreSpec()).points())


def _frontier_point_in_worker(blob: bytes, budget, cap, kwargs: dict,
                              job_index: int, app_name: str) -> bytes:
    """Evaluate one frontier sweep point in a worker process.

    ``blob`` is one pickle of the shared (routed design, timing, energy,
    iterations) baseline — unpickling already yields a private copy, so
    the candidate runs with ``copy_design=False``.  ``kwargs`` carries the
    compiler's ``device`` for the torch STA.
    """
    design, tm, energy, iterations = pickle.loads(blob)
    try:
        pt = evaluate_candidate(design, tm, energy, iterations, budget, cap,
                                copy_design=False, **kwargs)
    except Exception as e:
        import traceback
        raise BatchCompileError(
            f"batch job {job_index} (app {app_name!r}) frontier point "
            f"(budget={budget}, cap={cap}) failed in process worker: "
            f"{type(e).__name__}: {e}\n{traceback.format_exc()}",
            job_index=job_index, app_name=app_name) from None
    return pickle.dumps(pt)


#: Stage boundaries the driver snapshots and probes, deepest first at
#: resume time.  ``front_end`` is cheap to recompute and ``pipelined`` is
#: subsumed by the final-result cache, so neither is persisted.
CACHED_STAGES = ("mapped", "placed", "routed")


class CascadeCompiler:
    """``device`` is where the ``"torch"`` place, route and STA backends
    run: ``None`` is the card (without CUDA they raise), ``"cpu"`` the CPU.
    The host backends ignore it.  Its type keys cached results of the torch
    placer (``repro_torch.core.cache``), and batch workers carry it."""

    def __init__(self, fabric: Optional[Fabric] = None,
                 timing: Optional[TimingModel] = None,
                 energy: Optional[EnergyParams] = None,
                 cache: Optional[CompileCache] = None,
                 stage_cache: Optional[CompileCache] = None,
                 batch_backend: str = "auto",
                 batch_workers: Optional[int] = None,
                 device=None):
        if batch_backend not in BATCH_BACKENDS:
            raise ValueError(f"batch_backend must be one of {BATCH_BACKENDS},"
                             f" got {batch_backend!r}")
        self.fabric = fabric or Fabric()
        self.timing = timing or generate_timing_model(self.fabric)
        self.energy = energy or EnergyParams()
        self.device = device
        self.cache = DEFAULT_CACHE if cache is None else cache
        #: Stage-artifact tier: snapshots at the :data:`CACHED_STAGES`
        #: boundaries, keyed by :func:`repro_torch.core.cache.stage_key` prefix
        #: hashes, so a compile differing only in later-stage knobs
        #: resumes from the deepest shared artifact.
        self.stage_cache = (DEFAULT_STAGE_CACHE if stage_cache is None
                            else stage_cache)
        #: Defaults for ``compile_batch`` (drivers set these once instead of
        #: threading backend/worker args through every table function).
        self.batch_backend = batch_backend
        self.batch_workers = batch_workers
        #: Stats of the most recent ``compile_batch`` call (backend, worker
        #: count, hit/compile split) — benchmark drivers report these.
        self.last_batch: Dict[str, object] = {}

    # -- single compile ----------------------------------------------------
    def compile(self, app: AppSpec, config: Optional[PassConfig] = None,
                unroll: Optional[int] = None, verify: bool = False,
                use_cache: bool = True,
                pipeline: Optional[PassPipeline] = None,
                _key: Optional[str] = None,
                _skip_lookup: bool = False,
                _point_map=None) -> CompileResult:
        """Run the pass pipeline for one (app, config) pair.

        With ``use_cache`` (default), deterministic repeats return the
        memoized result (``result.cache_hit`` is set on the returned copy)
        and misses resume from the deepest cached :class:`StageArtifact`
        whose prefix key matches (``pass_stats["stage_resume"]`` records
        the boundary when that happens); pass ``pipeline`` to override the
        schedule declared by the config (which also disables both cache
        layers).  The cache stores and serves deep copies, so callers may
        freely mutate what they get back.  ``_key`` lets ``compile_batch``
        reuse a content hash it already computed; ``_skip_lookup`` skips
        the cache probe (the batch driver already probed) while still
        storing the result; ``_point_map`` fans the ``pareto_frontier``
        pass's sweep points out to a worker pool.
        """
        cfg = config or PassConfig()
        t0 = time.time()
        key = None
        app_fp = None
        caching = use_cache and self.cache is not None and pipeline is None
        if caching:
            app_fp = app_fingerprint(app)
            key = _key or compile_key(app, cfg, self.fabric, self.timing,
                                      self.energy, unroll=unroll,
                                      verify=verify, app_fp=app_fp,
                                      device=self.device)
            if not _skip_lookup:
                hit = self.cache.get(key)
                if hit is not None:
                    return dc_replace(copy.deepcopy(hit), cache_hit=True,
                                      compile_seconds=time.time() - t0)
        ctx = CompileContext(app=app, config=cfg, fabric=self.fabric,
                             timing=self.timing, energy=self.energy,
                             unroll=unroll, verify=verify,
                             device=self.device, point_map=_point_map)
        pipe = pipeline or PassPipeline.from_config(cfg)
        self._run_staged(ctx, pipe, stage_caching=caching, app_fp=app_fp,
                         unroll=unroll)
        result = CompileResult(
            app=app, config=cfg, design=ctx.design, sta=ctx.sta,
            schedule=ctx.schedule, power=ctx.power,
            pass_stats=ctx.pass_stats, post_pnr=ctx.post_pnr,
            power_cap=ctx.power_cap, frontier=ctx.frontier,
            compile_seconds=time.time() - t0)
        if key is not None:
            # store a private deep copy: the caller's mutations (and later
            # hitters') must never reach back into the cache entry
            self.cache.put(key, copy.deepcopy(result))
        return result

    # -- staged execution --------------------------------------------------
    def _stage_key(self, ctx: CompileContext, stage: str, prefix,
                   unroll: Optional[int], app_fp: Optional[str]) -> str:
        return stage_key(ctx.app, ctx.config, self.fabric, self.timing,
                         self.energy, stage=stage, prefix=prefix,
                         unroll=unroll, app_fp=app_fp, device=self.device)

    def _run_staged(self, ctx: CompileContext, pipe: PassPipeline,
                    stage_caching: bool, app_fp: Optional[str] = None,
                    unroll: Optional[int] = None,
                    until_stage: Optional[str] = None) -> Optional[str]:
        """Drive ``pipe`` over ``ctx`` with stage-artifact resume/capture.

        Probes the stage cache deepest-boundary-first and resumes from the
        first hit; every :data:`CACHED_STAGES` boundary crossed afterwards
        is snapshotted back into the cache.  ``until_stage`` stops at that
        stage's boundary instead of finishing the schedule (the
        ``compile_to_stage`` entry point).  Returns the resumed stage name
        (``None`` for a cold run).
        """
        plan = stage_plan(pipe.names)
        if plan is None and until_stage is not None:
            raise ValueError(
                f"schedule {pipe.names} has no stage structure "
                f"(unregistered pass or out-of-order stages)")
        boundary_of = dict(plan or [])
        if until_stage is not None and until_stage not in boundary_of:
            raise ValueError(f"stage {until_stage!r} not in schedule "
                             f"{pipe.names} (stages: {sorted(boundary_of)})")
        use_stages = (stage_caching and self.stage_cache is not None
                      and plan is not None)
        start, resumed = 0, None
        skeys: Dict[str, str] = {}
        if use_stages:
            if app_fp is None:
                app_fp = app_fingerprint(ctx.app)
            probe = [(s, e) for s, e in plan if s in CACHED_STAGES]
            if until_stage is not None:
                limit = STAGE_ORDER.index(until_stage)
                probe = [(s, e) for s, e in probe
                         if STAGE_ORDER.index(s) <= limit]
            for s, e in reversed(probe):
                skeys[s] = self._stage_key(ctx, s, pipe.names[:e], unroll,
                                           app_fp)
                art = self.stage_cache.get(skeys[s])
                if art is not None:
                    art.restore_into(ctx)
                    start, resumed = e, s
                    ctx.pass_stats["stage_resume"] = s
                    break

        def on_boundary(stage: str, c: CompileContext) -> None:
            if stage not in CACHED_STAGES:
                return
            if stage not in skeys:
                skeys[stage] = self._stage_key(c, stage,
                                               pipe.names[:boundary_of[stage]],
                                               unroll, app_fp)
            self.stage_cache.put(skeys[stage],
                                 StageArtifact.capture(c, stage))

        pipe.run(ctx, start=start,
                 until=boundary_of[until_stage] if until_stage else None,
                 on_boundary=on_boundary if use_stages else None)
        return resumed

    def compile_to_stage(self, app: AppSpec,
                         config: Optional[PassConfig] = None,
                         stage: str = "routed",
                         unroll: Optional[int] = None,
                         use_cache: bool = True) -> StageArtifact:
        """Run (or resume) the flow up to ``stage`` and return its artifact.

        The returned :class:`StageArtifact` is private to the caller (fork
        it further at will); with ``use_cache`` the run both resumes from
        and warms the stage tier, so warming the routed prefix for a sweep
        is one call — and a repeat call is a single cache probe + fork,
        with no pipeline run at all.
        """
        cfg = config or PassConfig()
        pipe = PassPipeline.from_config(cfg)
        if use_cache and self.stage_cache is not None \
                and stage in CACHED_STAGES:
            plan = stage_plan(pipe.names)
            end = dict(plan or []).get(stage)
            if end is not None:
                skey = stage_key(app, cfg, self.fabric, self.timing,
                                 self.energy, stage=stage,
                                 prefix=pipe.names[:end], unroll=unroll,
                                 device=self.device)
                hit = self.stage_cache.get(skey)
                if hit is not None:
                    return hit.fork()    # private copy; cache entry untouched
        ctx = CompileContext(app=app, config=cfg, fabric=self.fabric,
                             timing=self.timing, energy=self.energy,
                             unroll=unroll, device=self.device)
        self._run_staged(ctx, pipe, stage_caching=use_cache, unroll=unroll,
                         until_stage=stage)
        return StageArtifact.capture(ctx, stage)

    def stage_key_for(self, app: AppSpec,
                      config: Optional[PassConfig] = None,
                      stage: str = "mapped",
                      unroll: Optional[int] = None) -> Optional[str]:
        """The stage-cache content hash for ``(app, config, stage)``.

        ``None`` when the config's schedule has no stage structure (custom
        passes / out-of-order stages disable stage caching).  A service
        that keys a warm artifact pool (:class:`~repro_torch.core.cache.
        StagePool`) on this can never drift from the stage cache.
        """
        cfg = config or PassConfig()
        pipe = PassPipeline.from_config(cfg)
        plan = stage_plan(pipe.names)
        end = dict(plan or []).get(stage)
        if end is None:
            return None
        return stage_key(app, cfg, self.fabric, self.timing, self.energy,
                         stage=stage, prefix=pipe.names[:end], unroll=unroll,
                         device=self.device)

    def mapped_netlist(self, app: AppSpec,
                       config: Optional[PassConfig] = None,
                       unroll: Optional[int] = None,
                       use_cache: bool = True) -> Netlist:
        """The app's mapped-stage netlist (hardened config), for sizing a
        region: one front-end + mapping run (stage-cache resumed when warm),
        no place/route.
        """
        cfg = dc_replace(config or PassConfig(), harden_flush=True)
        art = self.compile_to_stage(app, cfg, stage="mapped", unroll=unroll,
                                    use_cache=use_cache)
        return extract_netlist(art.state["graph"])

    # -- batch compile -----------------------------------------------------
    def check_device(self, config: Optional[PassConfig]) -> None:
        """Raise now if ``config`` runs a torch engine on a device that is
        not there (the card without CUDA): the multi-app, service and
        scheduler paths call it before any work, so a missing card is an
        error up front, never a quiet fallback or a rejected admission."""
        if config is not None and _runs_torch(config):
            resolve_device(self.device)

    # -- multi-app fabric sharing ------------------------------------------
    def compile_multi(self, spec: Union[MultiAppSpec, Iterable[CompileJob]],
                      verify: bool = False, use_cache: bool = True,
                      backend: Optional[str] = None,
                      max_workers: Optional[int] = None) -> MultiAppResult:
        """Compile N apps into disjoint sub-fabrics of one shared fabric.

        Each resident compiles through the ``"multi"`` named schedule with
        its :class:`~repro_torch.core.interconnect.Region` in the config,
        so its placement sites and routing edges never leave the window it
        owns.
        Resident configs are always hardened per-app (a co-resident does
        not own a flush source; the pack provides the shared one), which
        keeps ``region`` a pure placed-stage input — so a resident shares
        ``mapped`` stage artifacts with the app's ordinary hardened
        compiles (thread backend or warm in-memory/disk tiers; process
        workers compile cold by design).  The residents then share exactly
        one flush broadcast (:func:`repro_torch.core.flush.shared_flush`),
        hardened when every resident's *requested* config hardens (paper
        Section VI), and the fabric-level summary reports freq = min over
        residents with power/EDP summed at that shared clock
        (:func:`repro_torch.core.multi.fabric_report`).

        A single app in a full-fabric region degenerates to an ordinary
        ``compile()`` — same cache key, same metrics, byte-identical
        result — so the multi driver is a strict superset of the
        single-app flow.  (Its flush report is descriptive only: a soft
        standalone compile already routes and times its own flush, so no
        second model cap is applied.)  Per-app compiles go through
        ``compile_batch`` (``backend``/``max_workers`` as there), so a
        pack place-and-routes its residents on multiple cores.
        """
        if not isinstance(spec, MultiAppSpec):
            # normalized() validates shape (incl. rejecting per-job unroll
            # overrides) for both entry points
            spec = MultiAppSpec(jobs=tuple(tuple(job) for job in spec))
        jobs = spec.normalized()
        for _, cfg in jobs:
            self.check_device(cfg)
        names = [app.name for app, _ in jobs]
        passthrough = (len(jobs) == 1 and
                       (spec.regions is None
                        or spec.regions[0].covers(self.fabric)))
        if passthrough:
            app, cfg = jobs[0]
            results = [self.compile(app, cfg, verify=verify,
                                    use_cache=use_cache)]
            regions = [Region.full(self.fabric)]
        else:
            if spec.regions is not None:
                regions = list(spec.regions)
            else:
                # size against the graph the resident will actually place
                # (hardened: no per-app __flush__ node) — this also warms
                # exactly the mapped artifact the resident compile
                # resumes from
                requests = [(app.name,
                             self.mapped_netlist(app, cfg,
                                                 use_cache=use_cache))
                            for app, cfg in jobs]
                regions = pack_regions(self.fabric, requests)
            validate_regions(self.fabric, regions, names)
            rjobs = [(app, resident_config(cfg, r))
                     for (app, cfg), r in zip(jobs, regions)]
            results = self.compile_batch(rjobs, verify=verify,
                                         use_cache=use_cache,
                                         backend=backend,
                                         max_workers=max_workers)
        harden = all(cfg.harden_flush for _, cfg in jobs)
        # a passthrough soft compile already routed + timed its own flush:
        # tm=None keeps the model cap from double-charging it
        return assemble_pack(spec.name, self.fabric, results,
                             dict(zip(names, regions)),
                             timing=None if passthrough else self.timing,
                             energy=self.energy, harden=harden)

    # -- batch compile -----------------------------------------------------
    def compile_batch(self, jobs: Iterable[CompileJob],
                      max_workers: Optional[int] = None,
                      verify: bool = False,
                      use_cache: bool = True,
                      backend: Optional[str] = None) -> List[CompileResult]:
        """Compile many (app, config[, unroll]) jobs through a worker pool.

        Results come back in job order and are byte-identical to serial
        ``compile()`` calls (the flow is seeded and deterministic); every
        returned result is a private object — mutating one can never
        corrupt another, even for deduplicated duplicate jobs.

        Backends:

        * ``"thread"`` — in-process pool.  The SA place/route inner loop is
          pure Python and holds the GIL, so threads only overlap cache
          lookups and numpy sections.
        * ``"process"`` — ``ProcessPoolExecutor``: each cache miss compiles
          in a worker process (true multi-core PnR) and the parent merges
          the result back into its cache tiers.  Workers fork for host
          backends while the parent has not initialised CUDA (and has no
          jax loaded), else spawn; each runs the torch engines on the
          compiler's ``device``.
          Jobs whose specs don't pickle fall back to the thread path
          transparently.
        * ``"auto"`` (default) — ``"process"`` when more than one job
          misses every cache tier, else ``"thread"``.

        Jobs whose config schedules the ``pareto_frontier`` pass with more
        than one sweep point are *fanned out*: the shared prefix compiles
        (or stage-cache-resumes) once in the parent, and the individual
        (budget, cap) points become sub-jobs on the chosen backend, merged
        parent-side into the job's ``ParetoFrontier`` — same results as a
        serial compile, sweep-point parallelism instead of job
        parallelism.  A failing job or sweep point raises
        :class:`BatchCompileError` naming the job index and app.

        Duplicate jobs (identical content hashes) compile once; repeat
        invocations are served from the cache (memory, then disk tier when
        attached).  ``backend``/``max_workers`` default to the compiler's
        ``batch_backend``/``batch_workers``; ``self.last_batch`` records
        backend, worker count, the hit/compile split, and the fan-out
        shape for benchmark reporting.
        """
        backend = backend or self.batch_backend
        if backend not in BATCH_BACKENDS:
            raise ValueError(f"backend must be one of {BATCH_BACKENDS}, "
                             f"got {backend!r}")
        norm: List[Tuple[AppSpec, PassConfig, Optional[int]]] = []
        for job in jobs:
            app, cfg = job[0], job[1] or PassConfig()
            unroll = job[2] if len(job) > 2 else None
            norm.append((app, cfg, unroll))
        if not norm:
            self.last_batch = {"jobs": 0, "backend": backend}
            return []
        t0 = time.time()

        caching = use_cache and self.cache is not None
        keys: List[Optional[str]] = [
            compile_key(app, cfg, self.fabric, self.timing, self.energy,
                        unroll=unroll, verify=verify, device=self.device)
            if caching else None
            for app, cfg, unroll in norm]

        # dedup identical jobs: one owner index per distinct content hash
        owner_of: List[int] = []
        first_for_key: Dict[str, int] = {}
        for i, k in enumerate(keys):
            if k is not None and k in first_for_key:
                owner_of.append(first_for_key[k])
            else:
                if k is not None:
                    first_for_key[k] = i
                owner_of.append(i)
        owners = [i for i in range(len(norm)) if owner_of[i] == i]

        # probe the cache tiers up front so the backend decision (and the
        # worker pool size) reflect only true misses
        results: Dict[int, CompileResult] = {}
        for i in owners:
            if keys[i] is None:
                continue
            hit = self.cache.get(keys[i])
            if hit is not None:
                results[i] = dc_replace(copy.deepcopy(hit), cache_hit=True,
                                        compile_seconds=0.0)
        cache_hits = len(results)
        misses = [i for i in owners if i not in results]

        # frontier fan-out jobs: the sweep points (not the jobs) are the
        # parallelism, so they leave the normal worker paths
        fan_points = {i: n for i in misses
                      if (n := _frontier_fanout(norm[i][1])) > 1}
        plain = [i for i in misses if i not in fan_points]

        workers = max_workers or self.batch_workers or worker_count(
            max(len(norm), sum(fan_points.values())))
        chosen = backend
        if chosen == "auto":
            effective = len(plain) + sum(fan_points.values())
            chosen = "process" if effective > 1 else "thread"

        proc: List[int] = []
        threaded: List[int] = list(plain)
        inline_fallback = 0
        start_method = None
        if chosen == "process" and plain:
            try:
                pickle.dumps((self.fabric, self.timing, self.energy))
                env_picklable = True
            except Exception:
                env_picklable = False     # whole worker payload must cross
            proc, threaded = [], []
            for i in plain:
                try:
                    if not env_picklable:
                        raise TypeError("compiler env not picklable")
                    pickle.dumps(norm[i])
                    proc.append(i)
                except Exception:
                    threaded.append(i)    # unpicklable spec: thread path
            inline_fallback = len(threaded)
        # launch the thread-path jobs first so inline fallbacks overlap the
        # process workers instead of waiting for them to drain
        tex = (ThreadPoolExecutor(max_workers=min(workers, len(threaded)))
               if threaded else None)
        tfuts = {i: tex.submit(self.compile, norm[i][0], norm[i][1],
                               unroll=norm[i][2], verify=verify,
                               use_cache=use_cache, _key=keys[i],
                               _skip_lookup=True)
                 for i in threaded}
        try:
            if proc:
                mp_ctx = _process_context(
                    any(_runs_torch(norm[i][1]) for i in proc))
                start_method = mp_ctx.get_start_method()
                with ProcessPoolExecutor(
                        max_workers=min(workers, len(proc)),
                        mp_context=mp_ctx) as ex:
                    futs = {i: ex.submit(_compile_job_in_worker, i,
                                         norm[i][0], norm[i][1], norm[i][2],
                                         verify, self.fabric, self.timing,
                                         self.energy, self.device)
                            for i in proc}
                    for i, fut in futs.items():
                        try:
                            blob = fut.result()
                        except BatchCompileError:
                            raise
                        except Exception as e:
                            raise _wrap_job_error(e, i, norm[i][0],
                                                  "in process worker")
                        if keys[i] is not None:
                            # merge the worker's result into the parent's
                            # cache tiers (the worker itself is cache-less)
                            self.cache.put(keys[i], pickle.loads(blob))
                        results[i] = pickle.loads(blob)
            # frontier jobs compile their prefix in the parent (stage tier
            # warm across jobs) and fan the sweep points onto the backend
            for i in fan_points:
                try:
                    results[i] = self.compile(
                        norm[i][0], norm[i][1], unroll=norm[i][2],
                        verify=verify, use_cache=use_cache, _key=keys[i],
                        _skip_lookup=True,
                        _point_map=self._pool_point_map(chosen, workers, i,
                                                        norm[i][0].name))
                except BatchCompileError:
                    raise
                except Exception as e:
                    raise _wrap_job_error(e, i, norm[i][0],
                                          "during frontier fan-out")
            for i, fut in tfuts.items():
                try:
                    results[i] = fut.result()
                except BatchCompileError:
                    raise
                except Exception as e:
                    raise _wrap_job_error(e, i, norm[i][0], "in thread pool")
        finally:
            if tex is not None:
                tex.shutdown(wait=True)

        out: List[CompileResult] = []
        for i in range(len(norm)):
            owner = owner_of[i]
            r = results[owner]
            if owner != i:               # duplicate job: private copy
                r = dc_replace(copy.deepcopy(r), cache_hit=True)
            out.append(r)
        self.last_batch = {
            "jobs": len(norm), "unique": len(owners),
            "backend": chosen, "workers": workers,
            "cache_hits": cache_hits,
            "compiled": len(owners) - cache_hits,
            "inline_fallback": inline_fallback,
            "start_method": start_method,
            "explore_jobs": len(fan_points),
            "explore_points": sum(fan_points.values()),
            "wall_seconds": round(time.time() - t0, 3),
        }
        return out

    def _pool_point_map(self, backend: str, workers: int, job_index: int,
                        app_name: str):
        """A :data:`~repro_torch.core.explore.PointMap` that fans sweep
        points onto this batch's backend.

        The process variant ships one pickle of the shared routed baseline
        per point (workers run ``copy_design=False`` on their private
        unpickled copy); anything unpicklable degrades to the serial map.
        The thread variant deep-copies per point in-process.  Failures are
        wrapped as :class:`BatchCompileError` naming the job and point.
        """
        def mapper(design, tm, energy, iterations, points, kwargs):
            if backend == "process":
                try:
                    blob = pickle.dumps((design, tm, energy, iterations))
                    pickle.dumps(kwargs)
                except Exception:
                    return map_points_serial(design, tm, energy, iterations,
                                             points, kwargs)
                with ProcessPoolExecutor(
                        max_workers=min(workers, len(points)),
                        mp_context=_process_context(
                            kwargs.get("sta_backend") == "torch")) as ex:
                    futs = [(p, ex.submit(_frontier_point_in_worker, blob,
                                          p[0], p[1], kwargs, job_index,
                                          app_name))
                            for p in points]
                    return [pickle.loads(self._point_result(f, p, job_index,
                                                            app_name))
                            for p, f in futs]
            with ThreadPoolExecutor(
                    max_workers=min(workers, len(points))) as ex:
                futs = [(p, ex.submit(evaluate_candidate, design, tm, energy,
                                      iterations, p[0], p[1],
                                      copy_design=True, **kwargs))
                        for p in points]
                return [self._point_result(f, p, job_index, app_name)
                        for p, f in futs]
        return mapper

    @staticmethod
    def _point_result(fut, point, job_index: int, app_name: str):
        try:
            return fut.result()
        except BatchCompileError:
            raise
        except Exception as e:
            err = BatchCompileError(
                f"batch job {job_index} (app {app_name!r}) frontier point "
                f"(budget={point[0]}, cap={point[1]}) failed: "
                f"{type(e).__name__}: {e}", job_index=job_index,
                app_name=app_name)
            err.__cause__ = e
            raise err


def compile_batch(jobs: Iterable[CompileJob],
                  compiler: Optional[CascadeCompiler] = None,
                  **kw) -> List[CompileResult]:
    """Module-level convenience: batch-compile with a (fresh) compiler."""
    return (compiler or CascadeCompiler()).compile_batch(jobs, **kw)


def compile_multi(spec: Union[MultiAppSpec, Iterable[CompileJob]],
                  compiler: Optional[CascadeCompiler] = None,
                  device=None, **kw) -> MultiAppResult:
    """Module-level convenience: fabric-sharing compile with a (fresh)
    compiler on ``device`` — see :meth:`CascadeCompiler.compile_multi`."""
    return (compiler or CascadeCompiler(device=device)).compile_multi(
        spec, **kw)
