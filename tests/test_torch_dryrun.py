"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) against the
JAX package's (``repro.launch.dryrun``).

The reference's pure helpers (wire factors, the HLO collective parser, the
roofline terms, the probe configs, the attention-traffic correction, the
skipped-cell record) are replayed against the port. The per-device argument
bytes of every runnable cell equal the reference's specs resolved on an
``AbstractMesh`` of the production shape. The port's own counters are held
to known cases on DTensors over a ``"fake"`` world of 256 ranks, which a
module fixture starts and destroys.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

# repro.launch.dryrun sets XLA_FLAGS for 512 host devices at import: lock
# jax's backend first (as tests/test_launch.py does) and put the variable
# back, so that later subprocesses of this worker start one device
jax.devices()
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as RD  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import (Replicate, Shard,  # noqa: E402
                                      distribute_tensor)
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.data.pipeline import batch_specs as ref_batch_specs  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, cell_is_runnable  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_HLO = """
  %ag = bf16[16,512]{1,0} all-gather(bf16[16,32]{1,0} %x), replica_groups={{0,1,2,3}}, dimensions={1}
  %ar = (f32[128]{0}, f32[64]{0}) all-reduce(%a, %b), replica_groups=[2,8]<=[16], to_apply=%sum
  %rs = bf16[8,4]{1,0} reduce-scatter-start(bf16[128,4]{1,0} %y), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}
  %a2a = f32[64]{0} all-to-all(f32[64]{0} %z), replica_groups=[4,4]<=[16]
  %cp = s32[10]{0} collective-permute(s32[10]{0} %w), source_target_pairs={{0,1}}
  %other = f32[4]{0} add(f32[4]{0} %p, f32[4]{0} %q)
"""


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_launch.py) and its pure helpers


def test_wire_factors():
    assert D._wire_factor("all-reduce", 16) == pytest.approx(2 * 15 / 16)
    assert D._wire_factor("all-gather", 16) == pytest.approx(15 / 16)
    assert D._wire_factor("reduce-scatter", 16) == 15
    assert D._wire_factor("collective-permute", 2) == 1.0
    assert D._wire_factor("all-reduce", 1) == 0.0
    for op in RD._COLLECTIVES:
        for n in (1, 2, 8, 16, 256, 512):
            assert D._wire_factor(op, n) == RD._wire_factor(op, n)
    assert D._COLLECTIVES == RD._COLLECTIVES
    assert D._DTYPE_BYTES == RD._DTYPE_BYTES


def test_parse_collectives_counts_shapes_and_groups():
    hlo = """
  %ag = bf16[16,512]{1,0} all-gather(bf16[16,32]{1,0} %x), replica_groups={{0,1,2,3}}, dimensions={1}
  %ar = (f32[128]{0}, f32[64]{0}) all-reduce(%a, %b), replica_groups=[2,8]<=[16], to_apply=%sum
  %other = f32[4]{0} add(f32[4]{0} %p, f32[4]{0} %q)
"""
    out = D.parse_collectives(hlo)
    ag = 16 * 512 * 2 * (3 / 4)
    ar = (128 * 4 + 64 * 4) * 2 * (7 / 8)
    assert out["per_op_bytes"]["all-gather"] == pytest.approx(ag)
    assert out["per_op_bytes"]["all-reduce"] == pytest.approx(ar)
    assert out["per_op_counts"]["all-gather"] == 1
    assert out["bytes_per_device"] == pytest.approx(ag + ar)


def test_parse_collectives_equals_reference():
    """Every collective kind, async form and group syntax: the same
    record."""
    assert D.parse_collectives(_HLO) == RD.parse_collectives(_HLO)


def test_roofline_terms_dominance():
    r = D.roofline_terms(D.PEAK_FLOPS, D.HBM_BW * 2, D.ICI_BW * 0.5)
    assert r["compute_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(2.0)
    assert r["collective_s"] == pytest.approx(0.5)
    assert r["bound"] == "memory"
    assert r["step_time_lower_bound_s"] == 2.0


def test_constants_are_the_h100s():
    from repro_torch.distributed import pipeline
    assert (D.PEAK_FLOPS, D.HBM_BW, D.ICI_BW) == (
        pipeline.PEAK_FLOPS, pipeline.HBM_BW, pipeline.NVLINK_BW) == (
        989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_probe_configs_cover_structure(arch):
    """The reference's case without its scan_layers assert (the port loops
    over layers), and the probe configs equal the reference's field for
    field."""
    cfg = ARCHS[arch]
    u = D.probe_unit(cfg)
    assert cfg.num_layers % u == 0
    assert u == RD.probe_unit(REF_ARCHS[arch])
    for units in (1, 2):
        p, r = D.make_probe_cfg(cfg, units), RD.make_probe_cfg(
            REF_ARCHS[arch], units)
        assert p.num_layers == u * units and p.attn_impl == "einsum"
        assert (p.num_layers, p.attn_impl, p.encoder_layers) == (
            r.num_layers, r.attn_impl, r.encoder_layers)
    p1, p2 = D.make_probe_cfg(cfg, 1), D.make_probe_cfg(cfg, 2)
    if cfg.family == "audio":
        assert p2.encoder_layers == 2 * p1.encoder_layers
    assert D._extrapolate(3.0, 5.0, 7) == RD._extrapolate(3.0, 5.0, 7) == 15.0


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_attn_traffic_correction_equals_reference(arch, shape):
    for n_model, n_batch in ((16, 16), (16, 32)):
        assert D._attn_traffic_correction(
            ARCHS[arch], SHAPES[shape], n_model, n_batch) == \
            RD._attn_traffic_correction(REF_ARCHS[arch], REF_SHAPES[shape],
                                        n_model, n_batch)


def test_skipped_cell_record_equals_reference(tmp_path):
    """A cell that cannot run: the same JSON file, word for word, and no
    world is started for it."""
    for arch in sorted(ARCHS):
        ok, _ = cell_is_runnable(ARCHS[arch], SHAPES["long_500k"])
        if ok:
            continue
        for multi in (False, True):
            got = D.run_cell(arch, "long_500k", multi, str(tmp_path / "p"))
            want = RD.run_cell(arch, "long_500k", multi, str(tmp_path / "r"))
            assert got == want
    names = sorted(os.listdir(tmp_path / "r"))
    assert names == sorted(os.listdir(tmp_path / "p")) and len(names) == 16
    for n in names:
        assert json.loads((tmp_path / "p" / n).read_text()) == json.loads(
            (tmp_path / "r" / n).read_text())
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# per-device argument bytes of every runnable cell, both meshes


@pytest.fixture(params=[False, True], ids=["mesh16x16", "mesh2x16x16"])
def world(request):
    """(multi_pod, the reference's abstract mesh) with the fake world of
    the mesh's ranks running."""
    multi = request.param
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=D._ranks(multi))
    try:
        shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi else \
            ((16, 16), ("data", "model"))
        yield multi, AbstractMesh(shape, axes)
    finally:
        dist.destroy_process_group()


def _ref_leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _ref_spec_leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def ref_arg_bytes(cfg, shape, amesh):
    """The reference's ``exact_arg_bytes``, its specs resolved on the
    abstract mesh (no devices), plus what the port's int64 token leaves add
    over the reference's int32 ones."""
    model = RefLM(cfg)
    sizes = dict(zip(amesh.axis_names, amesh.axis_sizes))
    rules = RS.rules_for(cfg)
    with jax.sharding.use_abstract_mesh(amesh):
        if shape.kind == "train":
            oc = RS.make_optimizer_config(cfg)
            trees = [(RS.train_state_axes(model, oc),
                      RS.train_state_shapes(model, oc),
                      RS.rules_for(cfg, params=True)),
                     (None, ref_batch_specs(cfg, shape), rules)]
        else:
            b, s = shape.global_batch, shape.seq_len
            trees = [(model.logical_axes(), model.shapes(),
                      RS.rules_for(cfg, params=True)),
                     (None, ref_batch_specs(cfg, shape), rules),
                     (model.cache_logical_axes(b, s),
                      model.cache_shapes(b, s), rules)]
        total = extra = 0
        for axes, shapes, r in trees:
            if axes is None:
                from repro.data.pipeline import batch_logical_axes
                axes = batch_logical_axes(cfg, shape)
            specs = _ref_spec_leaves(ref_shd.specs_for_tree(axes, shapes,
                                                            rules=r))
            for sds, spec in zip(_ref_leaves(shapes), specs):
                n = 1
                for dim, entry in zip(sds.shape, tuple(spec) + (None,) * (
                        len(sds.shape) - len(tuple(spec)))):
                    names = () if entry is None else (
                        (entry,) if isinstance(entry, str) else entry)
                    n *= dim // math.prod(sizes[a] for a in names)
                total += n * np.dtype(sds.dtype).itemsize
                if np.dtype(sds.dtype) == np.int32 and sds.ndim == 2:
                    extra += 4 * n                    # int32 -> int64 tokens
    return total + extra


def test_exact_arg_bytes_equal_reference(world):
    multi, amesh = world
    n = 0
    for arch in sorted(ARCHS):
        for name in sorted(SHAPES):
            if not cell_is_runnable(ARCHS[arch], SHAPES[name])[0]:
                continue
            assert D.exact_arg_bytes(ARCHS[arch], SHAPES[name], multi) == \
                ref_arg_bytes(REF_ARCHS[arch], REF_SHAPES[name], amesh), (
                    arch, name)
            n += 1
    assert n == 32


# ---------------------------------------------------------------------------
# the counters on known cases (256 fake ranks)


@pytest.fixture
def mesh():
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield make_production_mesh()
    finally:
        dist.destroy_process_group()


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def tally_of(fn):
    tally = D.Tally()
    with tally.counting():
        out = fn()
    return tally, out


def test_sharded_matmul_counts_one_ranks_flops(mesh):
    """[128, 4096] @ [4096, 14336], the batch over "data" and the output
    over "model": each rank does 1/256 of the global product (what
    FlopCounterMode around DTensor code would count whole)."""
    x = distribute_tensor(meta(128, 4096), mesh, [Shard(0), Replicate()])
    w = distribute_tensor(meta(4096, 14336), mesh, [Replicate(), Shard(1)])
    tally, y = tally_of(lambda: x @ w)
    assert tally.flops == 2 * 128 * 4096 * 14336 // 256
    assert tally.collectives()["bytes_per_device"] == 0
    assert tuple(y.to_local().shape) == (8, 896)
    # bytes: both local operands read, the local product written
    assert tally.bytes == 2 * (8 * 4096 + 4096 * 896 + 8 * 896)


def test_contracting_dim_product_reduces(mesh):
    """[64, 4096] @ [4096, 1024] with the contracted dim over "model": a
    partial sum, reduced by an all-reduce (2 (n-1)/n x the result) or
    scattered by a reduce-scatter ((n-1) x the 1/n result)."""
    x = distribute_tensor(meta(64, 4096), mesh, [Shard(0), Shard(1)])
    w = distribute_tensor(meta(4096, 1024), mesh, [Replicate(), Shard(0)])
    local = 4 * 1024 * 2                          # [64/16, 1024] bf16
    tally, y = tally_of(lambda: (x @ w).redistribute(
        mesh, [Shard(0), Replicate()]))
    c = tally.collectives()
    assert c["per_op_counts"]["all-reduce"] == 1
    assert c["per_op_bytes"]["all-reduce"] == pytest.approx(
        2 * 15 / 16 * local)
    assert c["bytes_per_device"] == c["per_op_bytes"]["all-reduce"]
    assert tally.flops == 2 * 4 * 256 * 1024
    tally, y = tally_of(lambda: (x @ w).redistribute(
        mesh, [Shard(0), Shard(1)]))
    c = tally.collectives()
    assert c["per_op_counts"]["reduce-scatter"] == 1
    assert c["per_op_bytes"]["reduce-scatter"] == pytest.approx(
        15 * local / 16)
    assert c["bytes_per_device"] == c["per_op_bytes"]["reduce-scatter"]


def test_change_of_sharded_dim_is_an_all_to_all(mesh):
    """Shard(0) -> Shard(1) on "model": one all-to-all of (n-1)/n x its
    result, not the host group's all-gather stand-in."""
    x = distribute_tensor(meta(64, 128), mesh, [Replicate(), Shard(0)])
    tally, y = tally_of(lambda: x.redistribute(mesh, [Replicate(),
                                                      Shard(1)]))
    c = tally.collectives()
    assert tuple(y.to_local().shape) == (64, 8)
    assert c["per_op_counts"] == {"all-gather": 0, "all-reduce": 0,
                                  "reduce-scatter": 0, "all-to-all": 1,
                                  "collective-permute": 0}
    assert c["per_op_bytes"]["all-to-all"] == pytest.approx(
        15 / 16 * 64 * 8 * 2)


def test_memory_counts_live_local_storages(mesh):
    """Two temporaries of one rank's shard, one freed before the other is
    made: the peak is the larger one plus the output."""
    x = distribute_tensor(meta(256, 1024, dtype=torch.float32), mesh,
                          [Shard(0), Replicate()])

    def step():
        a = x * 2.0                   # [16, 1024] f32 = 64 KiB
        b = a.sum(dim=1)              # 64 B
        del a
        c = torch.cat([x, x], dim=1)  # 128 KiB
        return (c * b[:, None]).sum()

    tally = D.Tally()
    tally.track([x])
    with tally.counting():
        out = step()
    # at the last product: b, c, c * b and the sum's scalar
    assert tally.peak == 16 * 4 + 2 * 16 * 2048 * 4 + 4
    del out
    assert tally.live == 0


def _smoke_cell(arch, kind, **edits):
    cfg = ARCHS[arch].smoke().replace(**edits)
    return cfg, ShapeSpec(kind, 16, 256, kind)


def test_dp_train_cell_syncs_only_the_gradients(mesh):
    """Under the "dp" profile every weight is replicated and the batch
    spans all 256 ranks: the step's only traffic is the gradient sync, an
    all-reduce of every parameter's bytes (grad_specs: the parameters'
    placements)."""
    cfg, shape = _smoke_cell("llama3-8b", "train", sharding_profile="dp")
    D.clear_sharding_cache()
    _, fn, args, donated = D.build_cell(cfg, shape, False, mesh=mesh)
    tally, mem, _ = D.run_step(fn, args, donated)
    c = tally.collectives()
    param_bytes = sum(t.numel() * t.element_size()
                      for t in D._tensors(args[0]["params"]))
    n_params = len(D._tensors(args[0]["params"]))
    assert {k for k, v in c["per_op_counts"].items() if v} == {"all-reduce"}
    # DTensor reduces a gradient that is partial over ("data", "model") as
    # two all-reduces, one over each 16-rank axis (2 x 15/16 x its bytes
    # each), where one ring over 256 ranks would move 2 x 255/256
    assert c["per_op_counts"]["all-reduce"] == 2 * n_params
    assert c["per_op_bytes"]["all-reduce"] == pytest.approx(
        2 * (2 * 15 / 16) * param_bytes, rel=1e-12)
    assert mem["argument_size_in_bytes"] == D._local_bytes(
        D._tensors(args))
    assert mem["alias_size_in_bytes"] == mem["donated_size_in_bytes"] - 4


def test_decode_probes_extrapolate_to_the_full_count(tmp_path):
    """Decode layers are alike: the 1- and 2-unit probes extrapolate to the
    full-depth run's exact counts."""
    for arch in ("llama3-8b", "granite-moe-1b-a400m"):
        cfg = ARCHS[arch].smoke()
        cell = D.run_cell(arch, "decode_32k", out_dir=None,
                          cfg_override=cfg)
        full, pr = cell["cost_scanned_raw"], cell["probe"]
        assert pr["units"] == cfg.num_layers // D.probe_unit(cfg) > 2
        assert pr["flops"] == pytest.approx(full["flops"], rel=1e-9)
        # bytes: the first run in a process also builds DTensor's fake mesh
        # for a decomposition (a few bytes of coordinates)
        for key in ("bytes accessed", "transcendentals"):
            assert pr[key] == pytest.approx(full[key], rel=1e-6), (arch, key)
        assert pr["collective_bytes_per_device"] == pytest.approx(
            cell["collectives"]["bytes_per_device"], rel=1e-9)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the CLI


def test_dryrun_cli_single_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-small", "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "whisper-small x decode_32k" in r.stdout
    path = tmp_path / "whisper-small_decode_32k_16x16.json"
    cell = json.loads(path.read_text())
    for key in ("arch", "shape", "mesh", "lower_s", "compile_s", "devices",
                "memory", "cost_scanned_raw", "probe",
                "attn_traffic_correction", "roofline", "model_flops_total",
                "model_flops_per_device", "useful_flop_ratio",
                "roofline_fraction"):
        assert key in cell, key
    assert cell["devices"] == 256
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "alias_size_in_bytes",
                "peak_memory_in_bytes", "resident_bytes_per_device",
                "args_bytes_exact"):
        assert key in cell["memory"], key
    assert cell["memory"]["argument_size_in_bytes"] == \
        cell["memory"]["args_bytes_exact"]
    assert set(cell["roofline"]) == {
        "compute_s", "memory_s", "collective_s", "bound",
        "step_time_lower_bound_s", "memory_s_uncorrected"}
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks.roofline import load_cells
    finally:
        sys.path.remove(str(ROOT))
    cells = load_cells(str(tmp_path))
    assert [c["arch"] for c in cells] == ["whisper-small"]
