"""Cascade core — the default compile flow of the paper's CGRA compiler.

The host modules of ``repro.core`` carried over as this package's own
copies: the fabric and timing model, the app DFGs, the pipelining passes,
numpy simulated-annealing placement, A* routing, scalar STA, the post-PnR
register-insertion loop, the schedule/power reports, the interpreter
simulator and ``CascadeCompiler`` with its compile and stage-artifact
caches (``cache``), staged resume, ``compile_batch`` and the
``"power_capped"`` (``power_cap``) and ``"explore"`` (``explore``)
schedules; multi-app fabric sharing (``multi``, ``compile_multi`` and the
``"multi"`` schedules), traffic replay (``traffic``), the online compile
service (``service``) and fabric scheduler (``sched``), and the LM-block
lowering (``lmmap``).  The
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
    CascadeCompiler / PassConfig / CompileResult / compile_batch
    MultiAppSpec / compile_multi / CompileService / FabricScheduler
    TrafficTrace / replay
    CompileCache / DiskCache / compile_key / stage_key / StageArtifact
    power_capped_pipeline / ExploreSpec / ParetoFrontier
    DENSE_APPS / SPARSE_APPS / CONTROL_APPS benchmark suites
"""

from .apps import (ALL_APPS, CONTROL_APPS, DENSE_APPS, SPARSE_APPS,
                   AppSpec)
from .branch_delay import (MatchPlan, arrival_cycles_dfg, check_matched_dfg,
                           check_matched_netlist, match_dfg, match_netlist)
from .broadcast import broadcast_pipelining
from .cache import (DEFAULT_CACHE, DEFAULT_STAGE_CACHE, CompileCache,
                    DiskCache, StagePool, app_fingerprint, attach_disk_cache,
                    attach_stage_disk_cache, code_fingerprint, compile_key,
                    dfg_fingerprint, stage_key)
from .compiler import (BATCH_BACKENDS, CACHED_STAGES, BatchCompileError,
                       CascadeCompiler, CompileResult, MultiAppSpec,
                       PassConfig, compile_batch, compile_multi,
                       resident_config)
from .config import (PNR_BACKENDS, SIM_BACKENDS, STA_BACKENDS, cache_dir,
                     default_power_cap_mw, disk_cache_enabled, env_flag,
                     env_float, env_int, place_debug, pnr_backend,
                     sched_latency_weight, service_batch_window_s,
                     service_max_batch, sim_backend, sta_backend,
                     worker_count)
from .dfg import DFG
from .explore import (ExploreSpec, FrontierPoint, ParetoFrontier,
                      evaluate_candidate, explore_frontier, pareto_prune)
from .flush import (SharedFlushReport, add_soft_flush,
                    flush_network_registers, remove_flush, shared_flush,
                    stateful_nodes)
from .interconnect import Fabric, Hop, Region, SubFabric, Tile
from .metrics import DesignMetrics, combine_metrics, evaluate_design
from .multi import (MultiAppResult, PackingError, RectRequest, aligned_cols,
                    assemble_pack, fabric_report, find_slot, fragmentation,
                    free_area, pack_rects, pack_regions, region_request,
                    repack_rects, sink_tiles_by_app, validate_regions)
from .netlist import Netlist, RoutedDesign, extract_netlist
from .passes import (CONFIG_FIELD_STAGE, DEFAULT_SCHEDULE, EXPLORE_SCHEDULE,
                     MULTI_POWER_CAPPED_SCHEDULE, MULTI_SCHEDULE,
                     NAMED_SCHEDULES, PASS_REGISTRY, POWER_CAPPED_SCHEDULE,
                     STAGE_OF_PASS, STAGE_ORDER, CompileContext, Pass,
                     PassPipeline, StageArtifact, register_pass,
                     resolve_schedule, stage_plan)
from .pipelining import collapse_reg_chains, compute_pipelining, find_reg_chains
from .place import PlaceParams, place, placement_stats
from .post_pnr import PostPnRParams, post_pnr_pipeline
from .power import EnergyParams, PowerReport, power_report
from .power_cap import (DesignCheckpoint, ParetoPoint, PowerCapResult,
                        evaluate_point, power_capped_pipeline)
from .route import RouteParams, route
from .sched import (POLICIES, FabricScheduler, Resident, ScheduleOutcome,
                    compare_policies, evaluate_static)
from .schedule import Schedule, schedule_round2
from .service import (CompileService, ServiceCancelled, ServiceClosed,
                      ServiceTicket, ServiceTimeout)
from .sim import (clear_ref_memo, equivalent, output_latency, simulate,
                  simulate_sparse, sparse_equivalent)
from .sim_vec import (DenseProgram, SimLoweringError, SparseProgram,
                      lower_dense, lower_sparse, simulate_dense_vec,
                      simulate_sparse_vec)
from .sta import (STAReport, analyze, longest_path_maxplus,
                  sdf_simulate_fmax, timing_matrix)
from .sta_vec import IncrementalSTA, LoweredSTA, analyze_vec, lower_design
from .traffic import (AppTrafficStats, TrafficReport, TrafficTrace,
                      flush_downtime_cycles, periodic_trace, poisson_trace,
                      reconfig_cycles, replay, session_trace)
from .timing_model import TECH_NS, TimingModel, generate_timing_model
from .unroll import max_copies, subfabric_for

__all__ = [
    "ALL_APPS", "CONTROL_APPS", "DENSE_APPS", "SPARSE_APPS", "AppSpec",
    "CascadeCompiler", "CompileResult", "PassConfig", "compile_batch",
    "BATCH_BACKENDS", "BatchCompileError", "CACHED_STAGES",
    "CompileCache", "DiskCache", "StagePool", "DEFAULT_CACHE",
    "DEFAULT_STAGE_CACHE", "attach_disk_cache", "attach_stage_disk_cache",
    "compile_key", "stage_key", "app_fingerprint", "code_fingerprint",
    "cache_dir", "worker_count", "disk_cache_enabled", "env_float",
    "env_int", "default_power_cap_mw",
    "env_flag", "place_debug",
    "PNR_BACKENDS", "pnr_backend", "SIM_BACKENDS", "sim_backend",
    "STA_BACKENDS", "sta_backend",
    "CompileContext", "Pass", "PassPipeline", "PASS_REGISTRY",
    "DEFAULT_SCHEDULE", "NAMED_SCHEDULES", "resolve_schedule",
    "POWER_CAPPED_SCHEDULE", "EXPLORE_SCHEDULE", "STAGE_ORDER",
    "STAGE_OF_PASS", "CONFIG_FIELD_STAGE", "StageArtifact", "stage_plan",
    "DesignCheckpoint", "ParetoPoint", "PowerCapResult", "evaluate_point",
    "power_capped_pipeline",
    "ExploreSpec", "FrontierPoint", "ParetoFrontier", "evaluate_candidate",
    "explore_frontier", "pareto_prune",
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
    "MultiAppSpec", "MultiAppResult", "compile_multi", "PackingError",
    "pack_regions", "region_request", "validate_regions",
    "sink_tiles_by_app", "fabric_report", "RectRequest", "aligned_cols",
    "find_slot", "pack_rects", "repack_rects", "free_area", "fragmentation",
    "assemble_pack", "resident_config",
    "CompileService", "ServiceTicket", "ServiceClosed", "ServiceCancelled",
    "ServiceTimeout",
    "FabricScheduler", "Resident", "ScheduleOutcome", "POLICIES",
    "evaluate_static", "compare_policies",
    "SharedFlushReport", "shared_flush", "flush_network_registers",
    "stateful_nodes", "combine_metrics", "MULTI_SCHEDULE",
    "MULTI_POWER_CAPPED_SCHEDULE",
    "service_batch_window_s", "service_max_batch", "sched_latency_weight",
    "TrafficTrace", "TrafficReport", "AppTrafficStats", "replay",
    "periodic_trace", "poisson_trace", "session_trace",
    "flush_downtime_cycles", "reconfig_cycles",
]
