"""CascadeCompiler — the end-to-end application compiler of paper Fig. 2.

    app spec -> DFG -> [compute pipelining] -> [broadcast pipelining]
             -> netlist -> place (Eq. 1, alpha) -> route -> [post-PnR
             pipelining] -> schedule round 2 -> bitstream/report

Every Cascade technique is individually toggleable (``PassConfig``) so the
paper's incremental figures can be reproduced, and the flush broadcast can
be routed in software (baseline) or hardened (Section VI).

The flow itself lives in :mod:`repro_torch.core.passes` as a pass pipeline;
``compile()`` is a thin driver that builds a :class:`CompileContext` and runs
the schedule declared by the config.  The reference's compile caches, batch
and multi-app drivers are later slices of the port (``ROADMAP.md``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

from .apps import AppSpec
from .interconnect import Fabric
from .netlist import RoutedDesign
from .passes import CompileContext, PassPipeline
from .post_pnr import PostPnRResult
from .power import EnergyParams, PowerReport
from .schedule import Schedule
from .sta import STAReport
from .timing_model import TimingModel, generate_timing_model


@dataclass
class PassConfig:
    """Declarative compile configuration — every Cascade technique toggle
    the default schedule reads, with the reference's defaults."""

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
    #: Pass schedule: ``None`` -> default flow; ``"default"``; or an
    #: explicit tuple of registered pass names.
    schedule: Union[str, Tuple[str, ...], None] = None

    @classmethod
    def unpipelined(cls, **kw) -> "PassConfig":
        """The baseline compiler: no pipelining techniques at all."""
        return cls(compute_pipelining=False, broadcast_pipelining=False,
                   placement_alpha=1.0, post_pnr=False, low_unroll_dup=False,
                   harden_flush=False, **kw)

    @classmethod
    def full(cls, **kw) -> "PassConfig":
        return cls(**kw)


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
    compile_seconds: float = 0.0

    def summary(self) -> dict:
        return {
            "app": self.app.name,
            "critical_path_ns": round(self.sta.critical_path_ns, 3),
            **self.power.scaled(),
            "registers": self.design.physical_register_count(),
            "unroll_copies": self.design.unroll_copies,
        }


class CascadeCompiler:
    """``device`` is where the ``"torch"`` place, route and STA backends
    run: ``None`` is the card (without CUDA they raise), ``"cpu"`` the CPU.
    The host backends ignore it."""

    def __init__(self, fabric: Optional[Fabric] = None,
                 timing: Optional[TimingModel] = None,
                 energy: Optional[EnergyParams] = None,
                 device=None):
        self.fabric = fabric or Fabric()
        self.timing = timing or generate_timing_model(self.fabric)
        self.energy = energy or EnergyParams()
        self.device = device

    def compile(self, app: AppSpec, config: Optional[PassConfig] = None,
                unroll: Optional[int] = None,
                verify: bool = False) -> CompileResult:
        """Run the pass pipeline for one (app, config) pair.

        ``verify`` adds the cycle-exact equivalence check of the routed
        design against the source app (dense and control apps)."""
        cfg = config or PassConfig()
        t0 = time.time()
        ctx = CompileContext(app=app, config=cfg, fabric=self.fabric,
                             timing=self.timing, energy=self.energy,
                             unroll=unroll, verify=verify,
                             device=self.device)
        PassPipeline.from_config(cfg).run(ctx)
        return CompileResult(
            app=app, config=cfg, design=ctx.design, sta=ctx.sta,
            schedule=ctx.schedule, power=ctx.power,
            pass_stats=ctx.pass_stats, post_pnr=ctx.post_pnr,
            compile_seconds=time.time() - t0)
