"""The port's lowered STA engines against the JAX package's, on the CPU.

The port's ``sta_vec`` carries the reference's lowering, numpy engine and
``IncrementalSTA`` over, and replaces the jitted jax propagate with a
float64 torch level loop (``device="cpu"`` here).  Both engines must give
reports exactly equal — not approximately — to the reference's scalar
walk and numpy engine on the same routed designs (the reference's jax
engine is not an oracle: it needs ``jax.experimental.enable_x64``, which
the installed jax lacks), and the post-PnR loop driven by either must be
byte-identical to the reference's numpy-engine loop on every stop path
the port has.  The designs come from the two packages' own compiles,
whose digests agree.
"""

import copy
import dataclasses
import pickle
import random

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro.core import ALL_APPS as REF_APPS  # noqa: E402
from repro.core import CascadeCompiler as RefCompiler  # noqa: E402
from repro.core import PassConfig as RefPassConfig  # noqa: E402
from repro.core import analyze as ref_analyze  # noqa: E402
from repro.core import generate_timing_model as ref_timing_model  # noqa: E402
from repro.core import lower_design as ref_lower_design  # noqa: E402
from repro.core import post_pnr_pipeline as ref_post_pnr  # noqa: E402
from repro.core import PostPnRParams as RefPostPnRParams  # noqa: E402
from repro_torch.core import (ALL_APPS, DENSE_APPS, CascadeCompiler,  # noqa: E402
                              IncrementalSTA, LoweredSTA, PassConfig,
                              PostPnRParams, analyze, analyze_vec,
                              generate_timing_model, lower_design,
                              post_pnr_pipeline)
from repro_torch.core.netlist import design_digest  # noqa: E402

#: the port's lowered engines; torch runs on the CPU here
BACKENDS = ("numpy", "torch")
DEV = "cpu"

#: (app, unroll) design points — dense and sparse, unrolled and not
APPS = (("gaussian", 1), ("harris", 1), ("mttkrp", 2))

# tests/test_predication.py's pins of the straight-line apps under
# PassConfig.full(place_moves=40): (design digest, critical path ns,
# physical registers)
STRAIGHT_LINE_PINS = {
    "gaussian": ("a3a27512474fe9396edeb6f63f642286873820b92ee2701b95b0b98dae1f81f3",
                 1.375, 62),
    "unsharp": ("f51ce187b41722194946e24ed3fc93e9ab044bb59a2bb0eaee081e4ba152eaef",
                1.47, 91),
    "harris": ("1bd4154ffbd6ad87d2b51b31c4b8831d96ac0883aa7aecd0eeec371981153b01",
               2.005, 228),
}

_ROUTED = {}


def _routed(name, unroll):
    """((port design, port timing), (reference design, reference timing))
    of the routed, not yet pipelined compile, each timing model that of the
    design's placement fabric (as the compile's own post-PnR pass uses);
    the cached masters are never mutated — tests deepcopy them."""
    key = (name, unroll)
    if key not in _ROUTED:
        pc, rc = CascadeCompiler(device=DEV), RefCompiler()
        got = pc.compile(ALL_APPS[name], PassConfig(post_pnr=False),
                         unroll=unroll)
        want = rc.compile(REF_APPS[name], RefPassConfig(post_pnr=False),
                          unroll=unroll, use_cache=False)
        assert design_digest(got.design) == design_digest(want.design)
        _ROUTED[key] = ((got.design, generate_timing_model(got.design.fabric)),
                        (want.design, ref_timing_model(want.design.fabric)))
    return _ROUTED[key]


def _assert_reports_identical(ref, got):
    """Exact equality on every report field."""
    assert got.critical_path_ns == ref.critical_path_ns
    assert got.max_freq_mhz == ref.max_freq_mhz
    assert got.clock_period_ns == ref.clock_period_ns
    assert got.n_segments == ref.n_segments
    assert got.critical_path == ref.critical_path
    assert got.arrival_out == ref.arrival_out


def _reg_state(design):
    return ({k: sorted(rb.reg_hops) for k, rb in design.routes.items()},
            {b.key: b.n_regs for b in design.netlist.branches})


def _same(a, b) -> bool:
    """Structural equality through numpy arrays, lists, tuples and dicts,
    dtypes included."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


# ---------------------------------------------------------------------------
# the lowering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app,unroll", APPS)
def test_lowering_equals_reference(app, unroll):
    (d, tm), (rd, rtm) = _routed(app, unroll)
    got, want = lower_design(d, tm), ref_lower_design(rd, rtm)
    names = [f.name for f in dataclasses.fields(LoweredSTA)
             if not f.name.startswith("_")]
    assert len(names) > 30
    for name in names:
        assert _same(getattr(got, name), getattr(want, name)), name
    # np.maximum.reduceat needs every multi-pred segment non-empty
    assert (got.mp_ecnt[got.vp_kind == 2] > 0).all()


# ---------------------------------------------------------------------------
# one-shot reports: the port's engines vs the reference's scalar and numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app,unroll", APPS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_reports_equal_reference_on_routed_designs(app, unroll, backend):
    (d, tm), (rd, rtm) = _routed(app, unroll)
    want = ref_analyze(rd, rtm)
    _assert_reports_identical(want, ref_analyze(rd, rtm, backend="numpy"))
    _assert_reports_identical(want, analyze(d, tm))
    _assert_reports_identical(want, analyze(d, tm, backend=backend,
                                            device=DEV))
    _assert_reports_identical(want, analyze_vec(d, tm, backend=backend,
                                                device=DEV))


@pytest.mark.parametrize("backend", BACKENDS)
def test_reports_equal_reference_after_pipelining(backend):
    (d0, tm), (rd0, rtm) = _routed("harris", 1)
    d, rd = copy.deepcopy(d0), copy.deepcopy(rd0)
    post_pnr_pipeline(d, tm, PostPnRParams(max_iters=8))
    ref_post_pnr(rd, rtm, RefPostPnRParams(max_iters=8))
    assert _reg_state(d) == _reg_state(rd)
    _assert_reports_identical(ref_analyze(rd, rtm),
                              analyze(d, tm, backend=backend, device=DEV))


@pytest.mark.parametrize("backend", BACKENDS)
def test_clock_granularity_quantization_matches(backend):
    (d, tm), (rd, rtm) = _routed("gaussian", 1)
    want = ref_analyze(rd, rtm, clock_granularity_ns=0.25)
    got = analyze(d, tm, backend=backend, clock_granularity_ns=0.25,
                  device=DEV)
    _assert_reports_identical(want, got)


def test_sampled_delay_path_stays_on_scalar_walk():
    """``rng`` draws one factor per instance in scalar visit order, so a
    sampled analysis runs on the scalar walk whatever the backend."""
    (d, tm), _ = _routed("gaussian", 1)
    a = analyze(d, tm, rng=np.random.default_rng(7))
    b = analyze(d, tm, rng=np.random.default_rng(7), backend="torch")
    _assert_reports_identical(a, b)
    assert a.critical_path_ns != analyze(d, tm).critical_path_ns


def test_unknown_backends_rejected():
    (d, tm), _ = _routed("gaussian", 1)
    with pytest.raises(ValueError, match="unknown STA backend"):
        analyze_vec(d, tm, backend="jax")
    with pytest.raises(ValueError, match="unknown STA backend"):
        analyze(d, tm, backend="jax")
    with pytest.raises(ValueError, match="unknown STA engine backend"):
        IncrementalSTA(d, tm, backend="jax")


# ---------------------------------------------------------------------------
# random register states
# ---------------------------------------------------------------------------


def _scatter_regs(design, seed):
    """Scatter registers over hop sites of a deepcopied design (the same
    draws on either package's design: routes iterate in the same order)."""
    d = copy.deepcopy(design)
    rng = random.Random(seed)
    for rb in d.routes.values():
        for i in range(len(rb.hops)):
            if rng.random() < 0.3:
                rb.reg_hops.add(i)
        rb.branch.n_regs = len(rb.reg_hops)
    return d


def _check_random_reg_state(app_idx, seed):
    (d0, tm), (rd0, rtm) = _routed(*APPS[app_idx])
    d, rd = _scatter_regs(d0, seed), _scatter_regs(rd0, seed)
    assert _reg_state(d) == _reg_state(rd)
    want = ref_analyze(rd, rtm)
    _assert_reports_identical(want, ref_analyze(rd, rtm, backend="numpy"))
    for backend in BACKENDS:
        _assert_reports_identical(want, analyze(d, tm, backend=backend,
                                                device=DEV))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, len(APPS) - 1), st.integers(0, 2**31 - 1))
def test_random_reg_states_equal_reference(app_idx, seed):
    _check_random_reg_state(app_idx, seed)


def test_random_reg_states_seeded_sweep():
    """The same property under a fixed seeded sweep, so the randomized
    coverage runs where hypothesis is not installed."""
    rng = random.Random(0xCA5CADE)
    for app_idx in range(len(APPS)):
        for _ in range(3):
            _check_random_reg_state(app_idx, rng.getrandbits(31))


# ---------------------------------------------------------------------------
# the incremental engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_incremental_engine_tracks_mutations(backend):
    (d0, tm), (rd0, rtm) = _routed("harris", 1)
    d, rd = copy.deepcopy(d0), copy.deepcopy(rd0)
    eng = IncrementalSTA(d, tm, backend=backend, device=DEV)

    def check():
        assert _reg_state(d) == _reg_state(rd)
        _assert_reports_identical(ref_analyze(rd, rtm),
                                  eng.analyze(with_arrivals=True))

    rng = random.Random(11)
    added = []
    for rb in d.routes.values():
        for i in range(len(rb.hops)):
            if i not in rb.reg_hops and rng.random() < 0.1:
                added.append((rb.branch.key, i))
    for dd in (d, rd):
        for bkey, i in added:
            dd.routes[bkey].reg_hops.add(i)
    eng.notify_added(added)
    check()
    # remove a few again; the cone must shrink back bit-identically
    removed = added[::3]
    for dd in (d, rd):
        for bkey, i in removed:
            dd.routes[bkey].reg_hops.discard(i)
    eng.notify_removed(removed)
    check()
    # resync from the design after an external edit
    for dd in (d, rd):
        for rb in dd.routes.values():
            if rb.hops:
                rb.reg_hops.add(0)
    eng.resync()
    check()


@pytest.mark.parametrize("backend", BACKENDS)
def test_lowering_is_shared_and_picklable(backend):
    (d, tm), (rd, rtm) = _routed("gaussian", 1)
    L = lower_design(d, tm)
    want = ref_analyze(rd, rtm)
    # one lowering serves a deepcopied fork (structure is shared)
    fork = copy.deepcopy(d)
    _assert_reports_identical(want, analyze_vec(fork, tm, backend=backend,
                                                lowering=L, device=DEV))
    assert bool(L._torch) == (backend == "torch")
    # pickles (device tensors and scalar mirrors are dropped), still exact
    L2 = pickle.loads(pickle.dumps(L))
    assert L2._torch == {} and L2._scalar == {}
    _assert_reports_identical(want, analyze_vec(d, tm, backend=backend,
                                                lowering=L2, device=DEV))


# ---------------------------------------------------------------------------
# the pipelining loop: byte-identical to the reference's numpy-engine loop
# ---------------------------------------------------------------------------


def _loop_state(design, res):
    return (res.history, res.stop_reason, res.iterations, res.initial_ns,
            res.final_ns, res.registers_added, _reg_state(design))


@pytest.mark.parametrize("app,unroll", APPS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_post_pnr_loop_equals_reference(app, unroll, backend):
    (d0, tm), (rd0, rtm) = _routed(app, unroll)
    rd = copy.deepcopy(rd0)
    want = ref_post_pnr(rd, rtm, RefPostPnRParams(max_iters=40),
                        sta_backend="numpy")
    d = copy.deepcopy(d0)
    got = post_pnr_pipeline(d, tm, PostPnRParams(max_iters=40),
                            sta_backend=backend, device=DEV)
    assert _loop_state(d, got) == _loop_state(rd, want)
    assert analyze(d, tm).critical_path_ns == got.final_ns


@pytest.mark.parametrize("backend", BACKENDS)
def test_register_budget_stop_equals_reference(backend):
    (d0, tm), (rd0, rtm) = _routed("harris", 1)
    rd, d = copy.deepcopy(rd0), copy.deepcopy(d0)
    want = ref_post_pnr(rd, rtm, RefPostPnRParams(max_iters=40,
                                                  register_budget=2),
                        sta_backend="numpy")
    got = post_pnr_pipeline(d, tm, PostPnRParams(max_iters=40,
                                                 register_budget=2),
                            sta_backend=backend, device=DEV)
    assert want.stop_reason == "register_budget"
    assert _loop_state(d, got) == _loop_state(rd, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_round_hook_stop_equals_reference(backend):
    (d0, tm), (rd0, rtm) = _routed("harris", 1)

    def run(loop, design, tm, params, **kw):
        d = copy.deepcopy(design)
        calls = []

        def hook(dd, rep):
            calls.append(rep.critical_path_ns)
            return len(calls) < 2        # reject the second round

        res = loop(d, tm, params, round_hook=hook, **kw)
        return _loop_state(d, res), calls

    want = run(ref_post_pnr, rd0, rtm, RefPostPnRParams(max_iters=40),
               sta_backend="numpy")
    got = run(post_pnr_pipeline, d0, tm, PostPnRParams(max_iters=40),
              sta_backend=backend, device=DEV)
    assert want[0][1] == "round_hook"
    assert got == want


# ---------------------------------------------------------------------------
# whole compiles: digests and pins with the lowered engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("app", sorted(STRAIGHT_LINE_PINS))
@pytest.mark.parametrize("backend", BACKENDS)
def test_full_compile_equals_reference_numpy_sta(app, backend):
    got = CascadeCompiler(device=DEV).compile(
        DENSE_APPS[app], PassConfig.full(place_moves=40, sta_backend=backend))
    want = RefCompiler().compile(
        REF_APPS[app], RefPassConfig.full(place_moves=40, sta_backend="numpy"),
        use_cache=False)
    assert got.summary() == want.summary()
    assert design_digest(got.design) == design_digest(want.design)
    digest, cp, regs = STRAIGHT_LINE_PINS[app]
    assert design_digest(got.design) == digest
    assert round(got.sta.critical_path_ns, 6) == cp
    assert got.design.physical_register_count() == regs
