"""Multi-pod dry run: prove every (architecture x shape x mesh) cell runs on
the production mesh, and take the roofline terms from what one rank does.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

A cell's step (train, prefill or decode, as the launchers run it) runs once
on meta DTensors: the state, batch and cache are laid out by
``train_shardings`` / ``serve_shardings`` on ``make_production_mesh`` over
a ``"fake"`` process group of 256 (16 x 16) or 512 (2 x 16 x 16) ranks, and
no rank holds any storage. That the step runs through is the port's
counterpart of the reference's "lowers, SPMD-partitions and compiles": every
op found a sharding strategy on the production mesh. The fake world needs
no card and computes nothing; its mesh has the host's device type, on which
DTensor lowers a change of sharded dim (an all-to-all on the cards) to an
all-gather and a chunk, since gloo has no all-to-all. ``Tally`` counts that
pair as the all-to-all it stands for. (A ``"cuda"`` mesh over the fake
world would lower it as the cards do, but torch builds some sharding
decisions on tensors of the mesh's device, which a torch without CUDA
cannot make.)

Per cell this records (``experiments/dryrun_torch/<cell>.json``, the
reference's file names and keys) from the local shards of rank 0:

  * memory           -- the peak of live local bytes over the step, the
                        arguments, the outputs and the outputs that alias
                        arguments (the donated state in train, the cache in
                        serve), temp = peak - arguments, and
                        ``resident_bytes_per_device`` by the reference's
                        formula. XLA's ``generated_code_size_in_bytes`` has
                        no counterpart and is left out.
  * cost             -- FLOPs of the local operands (``flop_registry``'s
                        formulas: matrix products and convolutions), the
                        bytes every local aten op reads and writes, views
                        excluded (what eager execution moves, not XLA's
                        fused count), and elements through transcendental
                        ops.
  * collective bytes -- for every collective DTensor issues, the
                        reference's ring convention: ``_wire_factor(op,
                        group size)`` x the result's bytes.
  * roofline terms   -- compute / memory / collective seconds and the
                        dominant term, at one H100 SXM's data-sheet rates
                        (``distributed.pipeline``): 989 TF/s dense bf16,
                        3.35 TB/s HBM3, and for collectives NVLink 4's 450
                        GB/s a direction. The 16-rank "model" axis spans two
                        8-GPU NVLink domains and "data" / "pod" cross nodes,
                        where a GPU's share of the network is about 50 GB/s
                        (400 Gb/s InfiniBand): the collective term is the
                        NVLink floor, a lower bound.

These numbers are modelled for a cluster of 256 or 512 cards, never
measured. ``chip_smoke.py``'s phase ``dryrun`` holds the counters to a real
step on one H100.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import time
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ARCHS, SHAPES, cell_is_runnable, get_config,
                                 model_flops)
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data.pipeline import batch_specs
from repro_torch.distributed import pipeline as _hw
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import LM

# ---------------------------------------------------------------------------
# hardware constants (one H100 SXM; see the module docstring)

PEAK_FLOPS = _hw.PEAK_FLOPS  # bf16 dense / card
HBM_BW = _hw.HBM_BW          # bytes/s / card
ICI_BW = _hw.NVLINK_BW       # bytes/s / card, one direction of NVLink 4

_DTYPE_BYTES = {"f64": 8, "s64": 8, "u64": 8, "c64": 8, "f32": 4, "s32": 4,
                "u32": 4, "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
                "s8": 1, "u8": 1, "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(m: re.Match) -> int:
    dt, dims = m.group(1), m.group(2)
    if dt not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dt]


def _wire_factor(op: str, n: int) -> float:
    """Per-device wire bytes as a multiple of the result-shape bytes for a
    ring implementation with n participants."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op == "all-gather":
        return (n - 1) / n                   # result is the gathered tensor
    if op == "reduce-scatter":
        return float(n - 1)                  # result is the 1/n shard
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0                               # collective-permute


def parse_collectives(hlo_text: str) -> Dict[str, Any]:
    """Sum per-device wire bytes of every collective in partitioned HLO
    text (the reference's parser, kept as a pure function; the port's own
    count comes from ``Tally``)."""
    per_op: Dict[str, float] = {c: 0.0 for c in _COLLECTIVES}
    counts: Dict[str, int] = {c: 0 for c in _COLLECTIVES}
    for line in hlo_text.splitlines():
        ls = line.strip()
        if " = " not in ls:
            continue
        rhs = ls.split(" = ", 1)[1]
        opname = None
        for c in _COLLECTIVES:
            # matches "bf16[...] all-gather(..." and async "-start" forms
            if f" {c}(" in f" {rhs}" or f" {c}-start(" in f" {rhs}":
                opname = c
                break
        if opname is None:
            continue
        n = 1
        g = _GROUPS_RE.search(rhs)
        if g:
            n = g.group(1).count(",") + 1
        else:
            gi = _GROUPS_IOTA_RE.search(rhs)
            if gi:
                n = int(gi.group(2))
        head = rhs.split(f"{opname}-start(")[0] if f"{opname}-start(" in rhs \
            else rhs.split(f"{opname}(")[0]
        rbytes = sum(_shape_bytes(m) for m in _SHAPE_RE.finditer(head))
        per_op[opname] += _wire_factor(opname, n) * rbytes
        counts[opname] += 1
    total = sum(per_op.values())
    return {"bytes_per_device": total,
            "per_op_bytes": per_op, "per_op_counts": counts}


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float
                   ) -> Dict[str, Any]:
    t_c = flops / PEAK_FLOPS
    t_m = hbm_bytes / HBM_BW
    t_x = coll_bytes / ICI_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "bound": dom[0],
            "step_time_lower_bound_s": max(t_c, t_m, t_x)}


# ---------------------------------------------------------------------------
# the counters: every local op of rank 0

# collective ops as they reach the local tensors, by (namespace, name)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor")
_NO_COST = ("wait_tensor", "_wrap_tensor_autograd")
_TRANSCENDENTAL = frozenset((
    "exp", "exp_", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid",
    "rsqrt", "sqrt", "sin", "cos", "silu", "gelu", "_softmax",
    "_log_softmax", "logaddexp", "pow"))
# allocate without reading or writing an element
_ALLOCATORS = frozenset(("empty", "empty_like", "empty_strided",
                         "new_empty", "new_empty_strided"))


def _subclasses() -> tuple:
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    return DTensor, AsyncCollectiveTensor


# the tensor subclasses that desugar into local ops first
_SUBCLASSES = _subclasses()
_FAKE = torch._C._TorchDispatchModeKey.FAKE


def _tensors(tree) -> list:
    """The tensor leaves of a tree of dicts, lists and tuples (NamedTuples
    too)."""
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            out.extend(_tensors(t))
    elif isinstance(tree, dict):
        for t in tree.values():
            out.extend(_tensors(t))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class Tally(TorchDispatchMode):
    """Counts the local aten ops of this rank.

    It returns ``NotImplemented`` for any op that has a DTensor (or a
    collective's not yet awaited result) among its types, so DTensor runs
    first and desugars into local ops and
    collectives on plain (local) tensors, which come back through this mode
    (``CommDebugMode``'s arrangement). So every count is of local shapes:
    ``torch.utils.flop_counter.FlopCounterMode`` wrapped around DTensor code
    would count global shapes.

    Memory: ``track(tensors)`` marks the arguments' storages, and every
    storage a local op creates adds its bytes to the live count until it is
    freed (a weak reference on the storage). ``peak`` is the most new bytes
    live at once, above the arguments."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.coll_bytes = {c: 0.0 for c in _COLLECTIVES}
        self.coll_counts = {c: 0 for c in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._held: set = set()
        self._owned: Dict[int, int] = {}
        self._alltoall = 0

    @contextlib.contextmanager
    def counting(self):
        """The mode, with DTensor's change of sharded dim marked: on a host
        mesh it runs as an all-gather and a chunk, counted as the
        all-to-all it stands for."""
        from torch.distributed.tensor import placement_types
        real = placement_types.shard_dim_alltoall

        def alltoall(*args, **kwargs):
            self._alltoall += 1
            try:
                return real(*args, **kwargs)
            finally:
                self._alltoall -= 1
        placement_types.shard_dim_alltoall = alltoall
        try:
            with self:
                yield self
        finally:
            placement_types.shard_dim_alltoall = real

    def track(self, tensors) -> None:
        """Storages that exist before the step (the arguments): not new."""
        for t in tensors:
            t = t._local_tensor if isinstance(t, DTensor) else t
            self._held.add(t.untyped_storage()._cdata)

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._owned.pop(key, None)

    def _new_storages(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held or key in self._owned:
                continue
            n = st.nbytes()
            self._owned[key] = n
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, _SUBCLASSES) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if torch._C._get_dispatch_mode(_FAKE) is not None or any(
                hasattr(t, "_spec") for t in ins):
            # DTensor's sharding decisions run ops at the global shapes: on
            # fake tensors, under a fake mode that this (user) mode comes
            # before, or through an op's decomposition on meta tensors that
            # carry the placement being tried. No rank runs them.
            return out
        if not isinstance(func, torch._ops.OpOverload):
            return out
        name = func._schema.name.split("::", 1)[-1]
        outs = _tensors(out)
        if func.namespace in _COLLECTIVE_NAMESPACES and \
                name in _COLLECTIVE_OPS:
            op = _COLLECTIVE_OPS[name]
            group = args[-1] if isinstance(args[-1], str) else \
                kwargs.get("group_name")
            n = _group_size(group)
            result = sum(_nbytes(t) for t in outs)
            if self._alltoall and op == "all-gather":
                # the host group's stand-in for an all-to-all, whose
                # result is one n-th of the gathered tensor
                op, result = "all-to-all", result / n
            self.coll_bytes[op] += _wire_factor(op, n) * result
            self.coll_counts[op] += 1
        elif func.namespace in _COLLECTIVE_NAMESPACES and \
                name not in _NO_COST:
            raise NotImplementedError(f"dry run: no wire count for {func}")
        pkt = func._overloadpacket
        if pkt in flop_registry:
            self.flops += flop_registry[pkt](*args, **kwargs, out_val=out)
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if not func.is_view and name not in _ALLOCATORS and \
                name not in _NO_COST:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        self._new_storages(outs)
        return out

    def cost(self) -> Dict[str, float]:
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes),
                "transcendentals": float(self.transcendentals)}

    def collectives(self) -> Dict[str, Any]:
        return {"bytes_per_device": sum(self.coll_bytes.values()),
                "per_op_bytes": dict(self.coll_bytes),
                "per_op_counts": dict(self.coll_counts)}


def _local_bytes(tensors) -> int:
    return sum(_nbytes(t._local_tensor if isinstance(t, DTensor) else t)
               for t in tensors)


def _storages(tensors) -> set:
    return {(t._local_tensor if isinstance(t, DTensor) else t
             ).untyped_storage()._cdata for t in tensors}


# ---------------------------------------------------------------------------
# the fake world


@contextlib.contextmanager
def fake_world(n: int):
    """A ``"fake"`` default process group of ``n`` ranks, this process rank
    0, for the span of the block. An existing fake group of ``n`` ranks is
    reused and left as it was."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != n:
            raise RuntimeError(
                f"the dry run needs a fake world of {n} ranks; a "
                f"{dist.get_backend()} group of {dist.get_world_size()} "
                f"ranks is running")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _ranks(multi_pod: bool) -> int:
    return 512 if multi_pod else 256


# ---------------------------------------------------------------------------
# cell construction


def build_cell(cfg: ModelConfig, shape: ShapeSpec, multi_pod: bool,
               mesh: Optional[DeviceMesh] = None,
               arrays: Optional[Tuple[Any, ...]] = None):
    """Returns (mesh, step, args, donated) for the cell: the step the
    launcher runs, its arguments as DTensors laid out by the port's
    shardings, and the argument that the step updates in place (the train
    state, the serve cache).

    ``mesh`` defaults to the production mesh over the running fake world
    (``fake_world``); ``arrays`` are the argument trees to lay out (default:
    meta tensors of their shapes), e.g. real tensors on one card. The rules
    stay set for the step (``shard`` reads them)."""
    model = LM(cfg)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    shd.set_rules(S.rules_for(cfg))
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt_cfg = S.make_optimizer_config(cfg)
        st_sh, b_sh = S.train_shardings(model, opt_cfg, mesh, shape)
        fn = S.make_train_step(model, opt_cfg, grad_specs=st_sh["params"])
        trees = arrays or (S.train_state_shapes(model, opt_cfg),
                           batch_specs(cfg, shape))
        args = (S.place_tree(trees[0], st_sh), S.place_tree(trees[1], b_sh))
        donated = 0
    else:
        p_sh, b_sh, c_sh = S.serve_shardings(model, mesh, shape)
        trees = arrays or (model.shapes(), batch_specs(cfg, shape),
                           model.cache_shapes(b, s))
        # the serve steps run under inference_mode, whose views of a
        # DTensor made outside it cannot be taken
        with torch.inference_mode():
            args = tuple(S.place_tree(t, sh)
                         for t, sh in zip(trees, (p_sh, b_sh, c_sh)))
        if shape.kind == "prefill":
            fn = S.make_prefill_step(model)
        else:
            fn = S.make_decode_step(model)
            # the frontier at the last slot: the step reads the whole cache
            args = args + (s - 1,)
        donated = 2
    return mesh, fn, args, donated


def run_step(fn, args, donated: int) -> Tuple[Tally, Dict[str, int], Any]:
    """Run ``fn(*args)`` once under a ``Tally``; returns (the tally, the
    memory record, the outputs)."""
    leaves = [t for a in args for t in _tensors(a)]
    donated_leaves = _tensors(args[donated])
    tally = Tally()
    tally.track(leaves)
    with tally.counting():
        out = fn(*args)
    out_leaves = _tensors(out)
    arg_keys = _storages(leaves)
    alias = [t for t in out_leaves if _storages([t]) <= arg_keys]
    mem = {"argument_size_in_bytes": _local_bytes(leaves),
           "output_size_in_bytes": _local_bytes(out_leaves),
           "alias_size_in_bytes": _local_bytes(alias),
           "donated_size_in_bytes": _local_bytes(donated_leaves)}
    mem["temp_size_in_bytes"] = tally.peak
    mem["peak_memory_in_bytes"] = mem["argument_size_in_bytes"] + tally.peak
    mem["resident_bytes_per_device"] = (
        mem["argument_size_in_bytes"] - mem["alias_size_in_bytes"]
        + mem["output_size_in_bytes"] + mem["temp_size_in_bytes"])
    return tally, mem, out


def clear_sharding_cache() -> None:
    """Empty DTensor's caches of sharding decisions. Their keys leave out
    some arguments that shape an op's output (``topk``'s k), so a decision
    cached for one model can be wrong for the next one in the process."""
    torch._C._clear_DTensor_sharding_propagator_cache()
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding \
        .cache_clear()


def _run_meta(cfg, shape, multi_pod):
    """(mesh, tally, memory, build seconds, step seconds) of one cell on
    meta DTensors over the fake world."""
    clear_sharding_cache()
    t0 = time.time()
    mesh, fn, args, donated = build_cell(cfg, shape, multi_pod)
    t_build = time.time() - t0
    t0 = time.time()
    tally, mem, _ = run_step(fn, args, donated)
    return mesh, tally, mem, round(t_build, 2), round(time.time() - t0, 2)


def exact_arg_bytes(cfg: ModelConfig, shape: ShapeSpec, multi_pod: bool
                    ) -> int:
    """Analytic per-device input bytes from the placements: every leaf of
    the state and batch (train) or params, batch and cache (serve), at its
    local shard's shape on rank 0 of the production mesh. Needs the fake
    world of the mesh's ranks."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    model = LM(cfg)
    mesh = make_production_mesh(multi_pod=multi_pod)
    if shape.kind == "train":
        opt_cfg = S.make_optimizer_config(cfg)
        st_sh, b_sh = S.train_shardings(model, opt_cfg, mesh, shape)
        pairs = [(S.train_state_shapes(model, opt_cfg), st_sh),
                 (batch_specs(cfg, shape), b_sh)]
    else:
        p_sh, b_sh, c_sh = S.serve_shardings(model, mesh, shape)
        b, s = shape.global_batch, shape.seq_len
        pairs = [(model.shapes(), p_sh), (batch_specs(cfg, shape), b_sh),
                 (model.cache_shapes(b, s), c_sh)]
    def local(t, sh):          # a meta tensor of this rank's shard
        shape, _ = compute_local_shape_and_global_offset(t.shape, *sh)
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return sum(_nbytes(t) for shapes, shardings in pairs
               for t in _tensors(shd.tree_map(
                   local, shapes, shardings,
                   is_leaf=lambda x: isinstance(x, torch.Tensor))))


# ---------------------------------------------------------------------------
# cost probes: reduced-depth steps, extrapolated
#
# The reference's scanned full-depth module counts a scan body once, so it
# lowers 1- and 2-unit unrolled probes and extrapolates. The port loops
# over layers, so its full-depth run counts every layer exactly
# (``cost_scanned_raw`` keeps the reference's name for that exact count);
# the probes stay for the roofline, as the reference's: einsum attention
# (loop-free) at 1 and 2 structural units of depth, every count
# extrapolated linearly: total(L) = c1 + (L/u - 1) * (c2 - c1). Attention
# score traffic is afterwards corrected from "materialized f32 scores"
# (what the einsum probe does) to "streamed blocks" -- see
# _attn_traffic_correction.


def probe_unit(cfg: ModelConfig) -> int:
    """Structural unit: smallest layer group the architecture repeats."""
    if cfg.family == "moe":
        return cfg.moe_layer_period
    if cfg.family == "hybrid":
        return cfg.shared_attn_every or 1
    if cfg.family == "vlm":
        return cfg.cross_attn_every or 1
    return 1


def make_probe_cfg(cfg: ModelConfig, units: int) -> ModelConfig:
    u = probe_unit(cfg)
    kw = dict(num_layers=u * units, attn_impl="einsum")
    if cfg.family == "audio":
        kw["encoder_layers"] = max(
            1, cfg.encoder_layers * u * units // cfg.num_layers)
    return cfg.replace(**kw)


def _extrapolate(c1: float, c2: float, n_units: int) -> float:
    return c1 + (n_units - 1) * (c2 - c1)


def run_probes(cfg: ModelConfig, shape: ShapeSpec, multi_pod: bool
               ) -> Dict[str, Any]:
    u = probe_unit(cfg)
    n_units = cfg.num_layers // u
    res = []
    for units in (1, 2):
        pcfg = make_probe_cfg(cfg, units)
        _, tally, _, _, t_c = _run_meta(pcfg, shape, multi_pod)
        res.append({"cost": tally.cost(), "coll": tally.collectives(),
                    "compile_s": t_c})
    out: Dict[str, Any] = {"unit_layers": u, "units": n_units,
                           "probe_compile_s": [r["compile_s"] for r in res]}
    for key in ("flops", "bytes accessed", "transcendentals"):
        c1 = res[0]["cost"].get(key, 0.0)
        c2 = res[1]["cost"].get(key, 0.0)
        out[key] = _extrapolate(c1, c2, n_units)
    out["collective_bytes_per_device"] = _extrapolate(
        res[0]["coll"]["bytes_per_device"],
        res[1]["coll"]["bytes_per_device"], n_units)
    out["collective_per_op"] = {
        op: _extrapolate(res[0]["coll"]["per_op_bytes"][op],
                         res[1]["coll"]["per_op_bytes"][op], n_units)
        for op in _COLLECTIVES}
    out["collective_counts_unit"] = {
        op: res[1]["coll"]["per_op_counts"][op]
        - res[0]["coll"]["per_op_counts"][op] for op in _COLLECTIVES}
    return out


def _attn_traffic_correction(cfg: ModelConfig, shape: ShapeSpec,
                             n_model: int, n_batch: int) -> Dict[str, float]:
    """Per-device HBM-byte delta: einsum-probe score materialization ->
    streamed blockwise attention (the impl the full run actually uses
    for q-length >= 4096).  Returns {"subtract": ..., "add": ...}."""
    s = shape.seq_len
    if shape.kind == "decode" or s < 4096 or cfg.family == "ssm":
        return {"subtract": 0.0, "add": 0.0}
    b_loc = max(1, shape.global_batch // n_batch)
    hq = cfg.num_heads
    hq_loc = hq // n_model if hq % n_model == 0 else hq
    hkv = cfg.num_kv_heads
    hkv_loc = hkv // n_model if hkv % n_model == 0 else hkv
    hd = cfg.resolved_head_dim

    # how many self-attention layers at this q-length?
    if cfg.family == "hybrid":
        n_attn = cfg.num_layers // (cfg.shared_attn_every or cfg.num_layers)
    elif cfg.family in ("dense", "moe", "vlm", "audio"):
        n_attn = cfg.num_layers
    else:
        n_attn = 0

    # score-tensor passes: fwd write+read (softmax) + prob write+read = 4;
    # training adds remat re-forward (4) and backward dS/dP traffic (8)
    passes = 16.0 if shape.kind == "train" else 4.0
    score_bytes = b_loc * hq_loc * float(s) * float(s) * 4.0
    subtract = n_attn * passes * score_bytes
    # streamed impl re-reads K/V once per 512-row q block
    n_qb = max(1, s // 512)
    kv_bytes = b_loc * float(s) * hkv_loc * hd * 2.0 * 2.0     # K and V, bf16
    add = n_attn * (3.0 if shape.kind == "train" else 1.0) * n_qb * kv_bytes
    return {"subtract": subtract, "add": add}


# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: Optional[str] = "experiments/dryrun_torch",
             full: bool = True, probes: bool = True,
             cfg_override: Optional[ModelConfig] = None,
             tag: str = "") -> Dict[str, Any]:
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                            "mesh": mesh_name}
    if tag:
        cell["tag"] = tag
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        cell["skipped"] = why
        return _emit(cell, out_dir)

    n_dev = _ranks(multi_pod)
    n_model = 16
    n_batch = n_dev // n_model

    with fake_world(n_dev), shd.use_rules(shd.get_rules()):
        if full:
            mesh, tally, mem, t_lower, t_compile = _run_meta(
                cfg, shape, multi_pod)
            cell["lower_s"] = t_lower
            cell["compile_s"] = t_compile
            cell["devices"] = mesh.size()
            cell["memory"] = mem
            cell["memory"]["args_bytes_exact"] = exact_arg_bytes(
                cfg, shape, multi_pod)
            cell["cost_scanned_raw"] = tally.cost()
            cell["collectives"] = tally.collectives()

        if probes:
            pr = run_probes(cfg, shape, multi_pod)
            cell["probe"] = pr
            flops = pr.get("flops", 0.0)
            hbm = pr.get("bytes accessed", 0.0)
            corr = _attn_traffic_correction(cfg, shape, n_model, n_batch)
            cell["attn_traffic_correction"] = corr
            hbm_corr = max(0.0, hbm - corr["subtract"]) + corr["add"]
            coll = pr.get("collective_bytes_per_device", 0.0)
            cell["roofline"] = roofline_terms(flops, hbm_corr, coll)
            cell["roofline"]["memory_s_uncorrected"] = hbm / HBM_BW
            mf = model_flops(cfg, shape)
            cell["model_flops_total"] = mf
            cell["model_flops_per_device"] = mf / n_dev
            if flops:
                cell["useful_flop_ratio"] = round(mf / n_dev / flops, 4)
                cell["roofline_fraction"] = round(
                    (mf / n_dev / PEAK_FLOPS) /
                    cell["roofline"]["step_time_lower_bound_s"], 4)
    return _emit(cell, out_dir)


def _emit(cell: Dict[str, Any], out_dir: Optional[str]) -> Dict[str, Any]:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{cell['tag']}" if cell.get("tag") else ""
        name = f"{cell['arch']}_{cell['shape']}_{cell['mesh']}{suffix}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(cell, f, indent=1, default=float)
    status = "SKIP" if "skipped" in cell else \
        cell.get("roofline", {}).get("bound", "?")
    print(f"[dryrun] {cell['arch']} x {cell['shape']} x {cell['mesh']}: "
          f"{status} "
          f"(compile {cell.get('compile_s', '-')}s)", flush=True)
    return cell


def _sweep_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
                full: bool, probes: bool) -> Optional[str]:
    """One cell of ``--all``; the failure's repr, or None."""
    try:
        run_cell(arch, shape, multi_pod, out_dir, full=full, probes=probes)
    except Exception as e:
        print(f"[dryrun] FAIL {arch} x {shape} x "
              f"{'2x16x16' if multi_pod else '16x16'}: {e!r}", flush=True)
        return repr(e)[:200]
    return None


def _sweep_order(cell: Tuple[str, str, bool]) -> Tuple[int, int]:
    """Longest cells first: the recurrences' chunk loops, then depth."""
    cfg = ARCHS[cell[0]]
    return (cfg.family not in ("ssm", "hybrid"), -cfg.num_layers)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--no-full", action="store_true",
                    help="skip the full-depth feasibility run")
    ap.add_argument("--no-probes", action="store_true",
                    help="skip the cost probes (feasibility only)")
    args = ap.parse_args(argv)

    if args.all:
        # roofline probes are a single-pod deliverable; multi-pod proves
        # the "pod" axis shards (full only)
        cells = [(arch, shape, mp, args.out, not args.no_full,
                  not (args.no_probes or mp))
                 for arch in ARCHS for shape in SHAPES for mp in (False, True)]
        # one spawned worker a core, each with its own fake world; the
        # longest cells first
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        t0 = time.time()
        cells.sort(key=_sweep_order)
        with ProcessPoolExecutor(
                os.cpu_count(),
                mp_context=multiprocessing.get_context("spawn")) as ex:
            errors = list(ex.map(_sweep_cell, *zip(*cells)))
        failures = [(c[0], c[1], c[2], e) for c, e in zip(cells, errors)
                    if e is not None]
        print(f"[dryrun] sweep done in {time.time() - t0:.1f}s, "
              f"{len(failures)} failures")
        for f in failures:
            print("   ", f)
        return 1 if failures else 0
    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    run_cell(args.arch, args.shape, args.multi_pod, args.out,
             full=not args.no_full, probes=not args.no_probes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
