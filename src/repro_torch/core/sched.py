"""Online multi-tenant fabric scheduler.

``compile_multi`` shares the fabric *statically*: every resident
is known up front, the pack is cut once into full-height column strips,
and nobody ever leaves.  Real multi-tenant traffic
(:class:`~repro_torch.core.traffic.TrafficTrace` with ``departures``) is
online: apps arrive, run for a while, and depart — and every departure
carves a hole a strip packer cannot refill.  :class:`FabricScheduler`
replays that event stream against a live fabric:

* **Admission** — size the newcomer from its warm mapped netlist
  (:meth:`~repro_torch.core.service.CompileService.mapped_netlist` →
  :func:`~repro_torch.core.multi.region_request`) and claim a free rectangle
  with :func:`~repro_torch.core.multi.find_slot` (true 2D regions: minimal
  height, stride-aligned columns, north-anchored when the app has IO) —
  not a full-height strip.
* **Re-pack on fragmentation** — when no slot exists but
  :func:`~repro_torch.core.multi.fragmentation` says the free area is merely
  shredded, compact every resident with
  :func:`~repro_torch.core.multi.repack_rects` and re-place them; region is a
  placed-stage config field, so the re-compiles resume from each
  resident's ``mapped`` stage artifact (byte-identical state, no
  front-end re-run).
* **Eviction** — when space genuinely runs out, residents whose
  last-epoch :meth:`~repro_torch.core.traffic.TrafficReport.app_objectives`
  contribution is weakest (and whose remaining offered load is below the
  newcomer's) are evicted to a waitlist; they re-enter when space frees,
  and their re-admission compile is byte-identical to a fresh one (same
  content hash, stage-cache resume).
* **Power cap** — after any membership change, if the pack-level power
  exceeds ``power_cap_mw``, every resident is re-compiled through
  ``resident_config(..., power_cap_mw=share)`` (the
  ``multi_power_capped`` schedule: identical physical prefix, so the
  re-cap resumes from the ``routed`` artifact and only re-runs budgeted
  pipelining).
* **Accounting** — between consecutive events the current pack is
  frozen and the trace window replayed
  (:meth:`~repro_torch.core.traffic.TrafficTrace.restricted` →
  :func:`~repro_torch.core.traffic.replay`); epoch objectives sum into the
  run's total, which is the number the online-vs-static benchmark
  compares.

:func:`evaluate_static` runs the *same* loop with ``policy="static"`` —
full-height strips, no re-pack, no eviction — so the two outcomes differ
only by scheduling policy, never by accounting.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .apps import AppSpec
from .compiler import CompileResult, PassConfig, resident_config
from .interconnect import Fabric, Region
from .multi import (MultiAppResult, RectRequest, assemble_pack, find_slot,
                    fragmentation, region_request, repack_rects,
                    validate_regions)
from .service import CompileService, ServiceTimeout
from .traffic import TrafficTrace, replay

POLICIES = ("online", "static")

#: Re-pack is only attempted when fragmentation is at least this —
#: below it the free space is one near-rectangular block and a failed
#: admission means the newcomer genuinely does not fit.
REPACK_FRAGMENTATION_MIN = 0.05


@dataclass
class Resident:
    """One app currently holding a region on the fabric."""

    app: AppSpec
    config: PassConfig                  # base (region-free, cap-free) config
    region: Region
    result: CompileResult
    rows: int                           # minimal window (region_request)
    cols: int
    admitted_at: int
    score: Optional[float] = None       # last-epoch objective contribution
    cap_mw: Optional[float] = None      # active per-resident power cap


@dataclass
class ScheduleOutcome:
    """Everything one scheduler run produced."""

    trace_name: str
    policy: str
    latency_weight: float
    objective: float = 0.0              # summed epoch objectives
    epochs: List[dict] = field(default_factory=list)
    events: List[dict] = field(default_factory=list)
    admitted: int = 0
    readmitted: int = 0
    rejected: int = 0
    evicted: int = 0
    departed: int = 0
    repacks: int = 0
    recaps: int = 0
    final_pack: Optional[MultiAppResult] = None

    def summary(self) -> dict:
        return {
            "trace": self.trace_name,
            "policy": self.policy,
            "latency_weight": self.latency_weight,
            "objective": round(self.objective, 3),
            "epochs": len(self.epochs),
            "admitted": self.admitted,
            "readmitted": self.readmitted,
            "rejected": self.rejected,
            "evicted": self.evicted,
            "departed": self.departed,
            "repacks": self.repacks,
            "recaps": self.recaps,
            "final_residents": sorted(self.final_pack.regions)
            if self.final_pack is not None else [],
        }


class FabricScheduler:
    """Replay an online trace, admitting/evicting/re-packing residents.

    Compiles go through a :class:`~repro_torch.core.service.CompileService`
    (one is created if not given), so every admission benefits from the
    service's shared cache tiers and warm mapped-artifact pool, and every
    admission's region reservation rides the ticket's ``on_release``
    hook — a compile that fails, times out, or is cancelled can never
    leak a held region.  ``device`` is that created service's (the torch
    engines' device: ``None`` is the card, ``"cpu"`` the CPU); a given
    service keeps its own.
    """

    def __init__(self, service: Optional[CompileService] = None,
                 fabric: Optional[Fabric] = None,
                 policy: str = "online",
                 latency_weight: float = 1.0,
                 power_cap_mw: Optional[float] = None,
                 allow_repack: bool = True,
                 allow_evict: bool = True,
                 compile_timeout_s: Optional[float] = None,
                 device=None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.service = service or CompileService(fabric=fabric,
                                                 device=device).start()
        self.fabric = self.service.compiler.fabric
        self.policy = policy
        self.latency_weight = latency_weight
        self.power_cap_mw = power_cap_mw
        self.allow_repack = allow_repack and policy == "online"
        self.allow_evict = allow_evict and policy == "online"
        self.compile_timeout_s = compile_timeout_s
        self._residents: Dict[str, Resident] = {}
        self._holds: Dict[str, Region] = {}     # in-flight reservations
        self._waitlist: Dict[str, int] = {}     # rejected/evicted, by cycle
        self._pack: Optional[MultiAppResult] = None   # cached assembly

    # -- public entry ------------------------------------------------------
    def run(self, trace: TrafficTrace, apps: Dict[str, AppSpec],
            configs: Optional[Dict[str, PassConfig]] = None,
            iterations: Optional[int] = None) -> ScheduleOutcome:
        """Drive the full event stream of ``trace`` and account it.

        ``apps`` maps every trace app name to its spec; ``configs``
        optionally overrides the per-app base :class:`PassConfig`.
        """
        missing = set(trace.arrivals) - set(apps)
        if missing:
            raise ValueError(f"trace {trace.name!r} names apps with no "
                             f"spec: {sorted(missing)}")
        cfgs = {name: (configs or {}).get(name, PassConfig())
                for name in trace.arrivals}
        for cfg in cfgs.values():
            self.service.compiler.check_device(cfg)
        out = ScheduleOutcome(trace_name=trace.name, policy=self.policy,
                              latency_weight=self.latency_weight)
        self._residents.clear()
        self._holds.clear()
        self._waitlist.clear()
        self._pack = None
        t_prev: Optional[int] = None
        for cycle, kind, name in trace.events():
            self._account_epoch(trace, out, t_prev, cycle, iterations)
            t_prev = cycle
            if kind == "depart":
                self._depart(name, cycle, out)
                self._drain_waitlist(trace, apps, cfgs, cycle, out)
            else:
                ok = self._try_admit(trace, apps[name], cfgs[name], cycle,
                                     out, readmit=False)
                if not ok and self._remaining(trace, name, cycle) > 0:
                    self._waitlist[name] = cycle
        self._account_epoch(trace, out, t_prev, None, iterations)
        out.final_pack = self._assemble()
        return out

    # -- residency book-keeping -------------------------------------------
    def regions(self) -> Dict[str, Region]:
        held = {f"hold:{n}": r for n, r in self._holds.items()}
        return {**{n: r.region for n, r in self._residents.items()}, **held}

    def _occupied(self) -> List[Region]:
        return ([r.region for r in self._residents.values()]
                + list(self._holds.values()))

    def _check(self) -> None:
        regions = [r.region for r in self._residents.values()]
        names = list(self._residents)
        if regions:
            validate_regions(self.fabric, regions, names,
                             needs_io=[True] * len(names))

    @staticmethod
    def _remaining(trace: TrafficTrace, name: str, cycle: int) -> int:
        return sum(1 for t in trace.arrivals.get(name, ()) if t >= cycle)

    def _log(self, out: ScheduleOutcome, cycle: int, kind: str, app: str,
             **detail) -> None:
        out.events.append({"cycle": cycle, "event": kind, "app": app,
                           **detail})

    # -- epoch accounting --------------------------------------------------
    def _assemble(self) -> Optional[MultiAppResult]:
        if not self._residents:
            self._pack = None
        elif self._pack is None:
            self._check()
            self._pack = assemble_pack(
                "sched", self.fabric,
                [r.result for r in self._residents.values()],
                {n: r.region for n, r in self._residents.items()},
                timing=self.service.compiler.timing,
                energy=self.service.compiler.energy, harden=True)
        return self._pack

    def _account_epoch(self, trace: TrafficTrace, out: ScheduleOutcome,
                       t0: Optional[int], t1: Optional[int],
                       iterations: Optional[int]) -> None:
        if t0 is None or not self._residents or (t1 is not None
                                                and t1 <= t0):
            return
        sub = trace.restricted(list(self._residents), t0, t1)
        if not sub.arrivals:
            return
        pack = self._assemble()
        rep = replay(pack, sub, iterations=iterations,
                     latency_weight=self.latency_weight)
        obj = rep.objective()
        out.objective += obj
        for name, contrib in rep.app_objectives().items():
            self._residents[name].score = contrib
        out.epochs.append({"t0": t0, "t1": t1,
                           "residents": sorted(self._residents),
                           "requests": sub.total_requests(),
                           "objective": round(obj, 3)})

    # -- events ------------------------------------------------------------
    def _depart(self, name: str, cycle: int, out: ScheduleOutcome) -> None:
        if name in self._residents:
            del self._residents[name]
            self._pack = None
            out.departed += 1
            self._log(out, cycle, "depart", name)
            self._enforce_cap(cycle, out)

    def _drain_waitlist(self, trace: TrafficTrace, apps: Dict[str, AppSpec],
                        cfgs: Dict[str, PassConfig], cycle: int,
                        out: ScheduleOutcome) -> None:
        # deterministic retry order: most offered load first, then name
        order = sorted(self._waitlist,
                       key=lambda n: (-self._remaining(trace, n, cycle), n))
        for name in order:
            if name not in self._waitlist:      # re-evicted mid-drain
                continue
            if self._remaining(trace, name, cycle) == 0:
                del self._waitlist[name]
                continue
            if self._try_admit(trace, apps[name], cfgs[name], cycle, out,
                               readmit=True):
                del self._waitlist[name]

    def _try_admit(self, trace: TrafficTrace, app: AppSpec, cfg: PassConfig,
                   cycle: int, out: ScheduleOutcome,
                   readmit: bool) -> bool:
        nl = self.service.mapped_netlist(app, cfg)
        rows, cols = region_request(nl, self.fabric)
        if self.policy == "static":
            rows = self.fabric.rows              # full-height strip
        slot = find_slot(self.fabric, self._occupied(), rows, cols)
        if slot is None and self.allow_repack:
            slot = self._repack_for(app.name, rows, cols, cycle, out)
        evicted: List[str] = []
        if slot is None and self.allow_evict:
            slot = self._evict_for(trace, app.name, rows, cols, cycle, out,
                                   evicted)
        if slot is None:
            if not readmit:
                out.rejected += 1
                self._log(out, cycle, "reject", app.name, rows=rows,
                          cols=cols,
                          fragmentation=round(fragmentation(
                              self.fabric, self._occupied()), 3))
            return False
        if not self._compile_into(app, cfg, slot, rows, cols, cycle, out):
            if not readmit:
                out.rejected += 1
            return False
        if readmit:
            out.readmitted += 1
        else:
            out.admitted += 1
        self._log(out, cycle, "readmit" if readmit else "admit", app.name,
                  region=f"{slot.rows}x{slot.cols}@r{slot.row0}c{slot.col0}",
                  evicted=evicted)
        self._enforce_cap(cycle, out)
        return True

    def _compile_into(self, app: AppSpec, cfg: PassConfig, slot: Region,
                      rows: int, cols: int, cycle: int,
                      out: ScheduleOutcome) -> bool:
        """Reserve ``slot``, compile the resident, seat it.  The region
        hold is released by the service ticket's ``on_release`` hook
        whenever the compile ends without a result."""
        self._holds[app.name] = slot
        released = self._holds.pop      # bound method; hook below
        ticket = self.service.submit(
            app, resident_config(cfg, slot),
            on_release=lambda: released(app.name, None))
        try:
            result = ticket.result(timeout=self.compile_timeout_s)
        except ServiceTimeout:
            self._log(out, cycle, "compile_timeout", app.name)
            return False                # hook already dropped the hold
        except Exception as e:
            self._log(out, cycle, "compile_error", app.name,
                      error=f"{type(e).__name__}: {e}")
            return False
        self._holds.pop(app.name, None)
        self._residents[app.name] = Resident(
            app=app, config=cfg, region=slot, result=result, rows=rows,
            cols=cols, admitted_at=cycle)
        self._pack = None
        return True

    def _repack_for(self, newcomer: str, rows: int, cols: int, cycle: int,
                    out: ScheduleOutcome) -> Optional[Region]:
        """Compact all residents + the newcomer; commit only on success."""
        if not self._residents or self._holds:
            return None
        frag = fragmentation(self.fabric, self._occupied())
        if frag < REPACK_FRAGMENTATION_MIN:
            return None
        reqs = [RectRequest(n, r.rows, r.cols)
                for n, r in sorted(self._residents.items())]
        reqs.append(RectRequest(newcomer, rows, cols))
        try:
            regions = repack_rects(self.fabric, reqs)
        except Exception:
            return None
        moved = [n for n, r in self._residents.items()
                 if regions[n] != r.region]
        for name in moved:
            res = self._residents[name]
            new_cfg = resident_config(res.config, regions[name],
                                      power_cap_mw=res.cap_mw)
            # region is a placed-stage field: resumes from the resident's
            # mapped artifact, re-running only place/route/pipeline
            res.result = self.service.compile(res.app, new_cfg,
                                              timeout=self.compile_timeout_s)
            res.region = regions[name]
        if moved:
            self._pack = None
        out.repacks += 1
        self._log(out, cycle, "repack", newcomer, moved=sorted(moved),
                  fragmentation_before=round(frag, 3))
        return regions[newcomer]

    def _evict_for(self, trace: TrafficTrace, newcomer: str, rows: int,
                   cols: int, cycle: int, out: ScheduleOutcome,
                   evicted: List[str]) -> Optional[Region]:
        """Evict weakest residents (never stronger offered load than the
        newcomer) until the newcomer fits or nobody else may go."""
        need = self._remaining(trace, newcomer, cycle)
        while True:
            victims = [
                (r.score if r.score is not None else 0.0,
                 self._remaining(trace, n, cycle), n)
                for n, r in self._residents.items()
                if self._remaining(trace, n, cycle) < need]
            if not victims:
                return None
            victims.sort()
            _, remaining, victim = victims[0]
            del self._residents[victim]
            self._pack = None
            evicted.append(victim)
            out.evicted += 1
            if remaining > 0:                   # may re-enter when space frees
                self._waitlist[victim] = cycle
            self._log(out, cycle, "evict", victim, for_app=newcomer)
            slot = find_slot(self.fabric, self._occupied(), rows, cols)
            if slot is None and self.allow_repack:
                slot = self._repack_for(newcomer, rows, cols, cycle, out)
            if slot is not None:
                return slot

    # -- pack-level power cap ---------------------------------------------
    def _enforce_cap(self, cycle: int, out: ScheduleOutcome) -> None:
        if self.power_cap_mw is None or not self._residents:
            return
        pack = self._assemble()
        total = float(pack.summary.get("power_mw", 0.0))
        if total <= self.power_cap_mw:
            return
        # proportional shares of the pack cap, by each resident's
        # uncapped draw; power_capped_pipeline resumes from each
        # resident's routed artifact (identical physical prefix)
        draws = {n: max(1e-9, r.result.power.power_mw)
                 for n, r in self._residents.items()}
        scale = self.power_cap_mw / sum(draws.values())
        for name, res in sorted(self._residents.items()):
            cap_i = draws[name] * scale
            res.cap_mw = cap_i
            res.result = self.service.compile(
                res.app, resident_config(res.config, res.region,
                                         power_cap_mw=cap_i),
                timeout=self.compile_timeout_s)
        self._pack = None
        capped = float(self._assemble().summary.get("power_mw", 0.0))
        out.recaps += 1
        self._log(out, cycle, "recap", "*", power_before_mw=round(total, 1),
                  power_after_mw=round(capped, 1),
                  cap_mw=self.power_cap_mw)


def evaluate_static(trace: TrafficTrace, apps: Dict[str, AppSpec],
                    service: Optional[CompileService] = None,
                    fabric: Optional[Fabric] = None,
                    configs: Optional[Dict[str, PassConfig]] = None,
                    latency_weight: float = 1.0,
                    iterations: Optional[int] = None,
                    device=None) -> ScheduleOutcome:
    """The static baseline: ``compile_multi``-style full-height strips,
    first-fit in arrival order, no re-pack, no eviction.  Same event loop
    and epoch accounting as the online policy, so its
    :class:`ScheduleOutcome` is directly comparable."""
    sched = FabricScheduler(service=service, fabric=fabric, policy="static",
                            latency_weight=latency_weight, device=device)
    return sched.run(trace, apps, configs=configs, iterations=iterations)


def compare_policies(trace: TrafficTrace, apps: Dict[str, AppSpec],
                     service: Optional[CompileService] = None,
                     fabric: Optional[Fabric] = None,
                     configs: Optional[Dict[str, PassConfig]] = None,
                     latency_weight: float = 1.0,
                     iterations: Optional[int] = None,
                     device=None
                     ) -> Tuple[ScheduleOutcome, ScheduleOutcome]:
    """Run online and static policies over the same trace with one shared
    service (shared cache tiers make the comparison cheap) and return
    ``(online, static)`` outcomes — the benchmark's core loop."""
    svc = service or CompileService(fabric=fabric, device=device).start()
    online = FabricScheduler(service=svc, policy="online",
                             latency_weight=latency_weight
                             ).run(trace, apps, configs=configs,
                                   iterations=iterations)
    static = evaluate_static(trace, apps, service=svc,
                             configs=configs,
                             latency_weight=latency_weight,
                             iterations=iterations)
    return online, static
