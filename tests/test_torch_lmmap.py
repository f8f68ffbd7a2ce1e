"""The port's LM-block lowering (``repro_torch.core.lmmap``) and its Amber
configuration (``repro_torch.configs.cgra_amber``) against the reference's,
on the CPU.

For every arch of ``configs.ARCHS`` (the port's own copies of the ten arch
files): the same family, width and expert count as the reference's arch;
the lowered DFG equal node for node (names, kinds, ops, widths,
latencies, depths, constants, metadata) and edge for edge, MoE with both
the mux and the predicated router; the same ``AppSpec`` fields; and
compiles on the host backends at ``place_moves=20`` (unpipelined and full,
as ``benchmarks/lm_lowering.py`` runs them) with equal summaries and
design digests. The Amber fabric, timing model and energy parameters
equal the reference's.
"""

import dataclasses
import json
import pickle

import pytest

import repro.core as ref
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import cgra_amber as ref_amber
from repro.core.lmmap import lower_block as ref_lower_block
from repro_torch.configs import ARCHS, cgra_amber
from repro_torch.core import CascadeCompiler, CompileCache, PassConfig
from repro_torch.core.lmmap import lower_block
from repro_torch.core.netlist import design_digest

MOVES = 20


def dfg_bytes(g) -> tuple:
    """A DFG node for node and edge for edge."""
    return (g.name, g.sparse,
            [(n.name, n.kind, n.op, n.width, n.latency, n.input_reg, n.depth,
              n.value, json.dumps(n.meta, sort_keys=True, default=repr))
             for n in g.nodes.values()],
            [(e.src, e.dst, e.port, e.width) for e in g.edges])


def spec_fields(spec) -> tuple:
    return (spec.name, spec.sparse, spec.frame, spec.unroll,
            spec.unroll_baseline, spec.work_tokens, vars(spec.builder))


def test_arch_registry_equals_reference():
    assert list(ARCHS) == list(REF_ARCHS)
    for name, cfg in ARCHS.items():
        want = REF_ARCHS[name]
        assert (cfg.family, cfg.d_model, cfg.num_experts) == \
            (want.family, want.d_model, want.num_experts), name


@pytest.mark.parametrize("predicated", [False, True])
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_lowered_dfg_equals_reference(arch, predicated):
    got = lower_block(ARCHS[arch], predicated=predicated)
    want = ref_lower_block(REF_ARCHS[arch], predicated=predicated)
    assert spec_fields(got) == spec_fields(want)
    for copies in (1, 2):
        assert dfg_bytes(got.build(copies)) == dfg_bytes(want.build(copies))
    # a spec ships to process workers: it pickles and comes back equal
    back = pickle.loads(pickle.dumps(got))
    assert dfg_bytes(back.build(1)) == dfg_bytes(got.build(1))


@pytest.fixture(scope="module")
def compiled():
    """Every arch's block, unpipelined and full, through both packages'
    ``compile_batch`` on the thread backend."""
    out = {}
    for pkg, lower, archs, key in (
            (ref, ref_lower_block, REF_ARCHS, "ref"),
            (__import__("repro_torch.core", fromlist=["x"]), lower_block,
             ARCHS, "port")):
        c = pkg.CascadeCompiler(cache=pkg.CompileCache(),
                                stage_cache=pkg.CompileCache())
        jobs = [(lower(archs[a]), f(place_moves=MOVES))
                for a in sorted(archs)
                for f in (pkg.PassConfig.unpipelined, pkg.PassConfig.full)]
        out[key] = c.compile_batch(jobs, backend="thread")
    return out


@pytest.mark.parametrize("i", range(2 * len(REF_ARCHS)))
def test_block_compiles_equal_reference(compiled, i):
    got, want = compiled["port"][i], compiled["ref"][i]
    assert got.app.name == want.app.name
    assert json.dumps(got.summary(), sort_keys=True) == \
        json.dumps(want.summary(), sort_keys=True)
    assert design_digest(got.design) == design_digest(want.design)
    assert got.sta.critical_path_ns == want.sta.critical_path_ns
    assert got.power.edp_js == want.power.edp_js


def test_lm_lowering_ratios_equal_reference(compiled):
    """``benchmarks/lm_lowering.py``'s columns from both packages."""
    def rows(res):
        return [(r0.app.name, r0.sta.max_freq_mhz, r1.sta.max_freq_mhz,
                 r0.sta.critical_path_ns / r1.sta.critical_path_ns,
                 r0.power.edp_js / r1.power.edp_js)
                for r0, r1 in zip(res[::2], res[1::2])]
    got = rows(compiled["port"])
    assert got == rows(compiled["ref"])
    assert all(cp >= 1.0 for _, _, _, cp, _ in got)


@pytest.mark.parametrize("arch,flow", [("llama3-8b", "unpipelined"),
                                       ("rwkv6-7b", "full"),
                                       ("zamba2-2.7b", "full")])
def test_block_compile_on_the_amber_array_verifies(arch, flow):
    """A block compiled on the Amber configuration simulates equal to its
    source DFG. (Fully pipelined, the attention tile fails ``verify`` in
    the reference and in the port alike; ``ROADMAP.md`` records it.)"""
    c = CascadeCompiler(fabric=cgra_amber.make_fabric(),
                        timing=cgra_amber.make_timing_model(),
                        energy=cgra_amber.make_energy_params(),
                        cache=CompileCache(), stage_cache=CompileCache())
    r = c.compile(lower_block(ARCHS[arch]),
                  getattr(PassConfig, flow)(place_moves=MOVES), verify=True)
    assert r.sta.max_freq_mhz > 0
    assert "verify" in r.pass_stats["pipeline"]


def test_amber_config_equals_reference():
    f, rf = cgra_amber.make_fabric(), ref_amber.make_fabric()
    assert dataclasses.asdict(f) == dataclasses.asdict(rf)
    assert (f.rows, f.cols) == (32, 16)
    tm, rtm = cgra_amber.make_timing_model(), ref_amber.make_timing_model()
    assert tm.entries == rtm.entries and tm.fabric_name == rtm.fabric_name
    assert dataclasses.asdict(cgra_amber.make_energy_params()) == \
        dataclasses.asdict(ref_amber.make_energy_params())
