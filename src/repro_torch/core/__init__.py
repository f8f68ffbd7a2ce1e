"""Cascade core — the default compile flow of the paper's CGRA compiler.

The host modules of ``repro.core`` carried over as this package's own
copies: the fabric and timing model, the app DFGs, the pipelining passes,
numpy simulated-annealing placement, A* routing, scalar STA, the post-PnR
register-insertion loop, the schedule/power reports, the interpreter
simulator and ``CascadeCompiler`` over ``DEFAULT_SCHEDULE``.  The
reference's jitted device engines are torch programs here: the lowered
STA (``sta_vec``, ``sta_backend="numpy"``/``"torch"``), the
parallel-tempering placer (``place_torch``) and the batched wavefront
router (``route_torch``), both ``pnr_backend="torch"``; and the
vectorized simulator (``sim_vec``, sim backends ``"numpy"`` and
``"torch"``, the latter through the ``sim_dense`` and ``sim_sparse``
kernels on the card).
``sta.timing_matrix`` feeds ``repro_torch.kernels.maxplus.longest_path``.

Public API:
    Fabric, TimingModel, generate_timing_model
    DFG and the pipelining passes (compute/broadcast/post-PnR, matching)
    CascadeCompiler / PassConfig / CompileResult
    DENSE_APPS / SPARSE_APPS / CONTROL_APPS benchmark suites
"""

from .apps import (ALL_APPS, CONTROL_APPS, DENSE_APPS, SPARSE_APPS,
                   AppSpec)
from .branch_delay import (MatchPlan, arrival_cycles_dfg, check_matched_dfg,
                           check_matched_netlist, match_dfg, match_netlist)
from .broadcast import broadcast_pipelining
from .compiler import CascadeCompiler, CompileResult, PassConfig
from .config import (PNR_BACKENDS, SIM_BACKENDS, STA_BACKENDS, env_flag,
                     place_debug, pnr_backend, sim_backend, sta_backend)
from .dfg import DFG
from .flush import add_soft_flush, remove_flush
from .interconnect import Fabric, Hop, Region, SubFabric, Tile
from .metrics import DesignMetrics, evaluate_design
from .netlist import Netlist, RoutedDesign, extract_netlist
from .passes import (DEFAULT_SCHEDULE, NAMED_SCHEDULES, PASS_REGISTRY,
                     CompileContext, Pass, PassPipeline, register_pass,
                     resolve_schedule)
from .pipelining import collapse_reg_chains, compute_pipelining, find_reg_chains
from .place import PlaceParams, place, placement_stats
from .post_pnr import PostPnRParams, post_pnr_pipeline
from .power import EnergyParams, PowerReport, power_report
from .route import RouteParams, route
from .schedule import Schedule, schedule_round2
from .sim import (clear_ref_memo, dfg_fingerprint, equivalent,
                  output_latency, simulate, simulate_sparse,
                  sparse_equivalent)
from .sim_vec import (DenseProgram, SimLoweringError, SparseProgram,
                      lower_dense, lower_sparse, simulate_dense_vec,
                      simulate_sparse_vec)
from .sta import (STAReport, analyze, longest_path_maxplus,
                  sdf_simulate_fmax, timing_matrix)
from .sta_vec import IncrementalSTA, LoweredSTA, analyze_vec, lower_design
from .timing_model import TECH_NS, TimingModel, generate_timing_model
from .unroll import max_copies, subfabric_for

__all__ = [
    "ALL_APPS", "CONTROL_APPS", "DENSE_APPS", "SPARSE_APPS", "AppSpec",
    "CascadeCompiler", "CompileResult", "PassConfig",
    "env_flag", "place_debug",
    "PNR_BACKENDS", "pnr_backend", "SIM_BACKENDS", "sim_backend",
    "STA_BACKENDS", "sta_backend",
    "CompileContext", "Pass", "PassPipeline", "PASS_REGISTRY",
    "DEFAULT_SCHEDULE", "NAMED_SCHEDULES", "resolve_schedule",
    "register_pass", "find_reg_chains",
    "DesignMetrics", "evaluate_design",
    "DFG", "Fabric", "Hop", "Region", "SubFabric", "Tile", "Netlist",
    "RoutedDesign", "TimingModel", "TECH_NS", "generate_timing_model",
    "analyze", "sdf_simulate_fmax", "STAReport", "timing_matrix",
    "longest_path_maxplus",
    "LoweredSTA", "IncrementalSTA", "lower_design", "analyze_vec",
    "match_dfg", "match_netlist", "MatchPlan",
    "check_matched_dfg", "check_matched_netlist",
    "arrival_cycles_dfg", "compute_pipelining", "collapse_reg_chains",
    "broadcast_pipelining", "post_pnr_pipeline", "PostPnRParams",
    "place", "PlaceParams", "placement_stats", "route", "RouteParams",
    "extract_netlist", "Schedule", "schedule_round2",
    "EnergyParams", "PowerReport", "power_report",
    "add_soft_flush", "remove_flush",
    "simulate", "simulate_sparse", "equivalent", "sparse_equivalent",
    "output_latency", "clear_ref_memo", "dfg_fingerprint",
    "SimLoweringError", "DenseProgram", "SparseProgram", "lower_dense",
    "lower_sparse", "simulate_dense_vec", "simulate_sparse_vec",
    "max_copies", "subfabric_for",
]
