"""The port's power-capped schedule against the JAX package's, on the CPU.

Replays ``tests/test_power_cap.py`` against ``repro_torch.core``: the named
schedules, byte-identity of the uncapped flow with the default schedule,
cap enforcement with rollback, the infeasible cap, checkpoints and cache
keying. Every capped result is also held to the reference's compile of the
same config, and the torch STA (on the CPU) to the host engines.
"""

import json

import pytest

from repro.core import ALL_APPS as REF_APPS  # noqa: E402
from repro.core import CascadeCompiler as RefCompiler  # noqa: E402
from repro.core import CompileCache as RefCompileCache  # noqa: E402
from repro.core import PassConfig as RefPassConfig  # noqa: E402
from repro_torch.core import (ALL_APPS, DENSE_APPS,  # noqa: E402
                              CascadeCompiler, CompileCache,
                              DesignCheckpoint, PassConfig, PassPipeline,
                              compile_key)
from repro_torch.core.passes import (DEFAULT_SCHEDULE,  # noqa: E402
                                     NAMED_SCHEDULES, POWER_CAPPED_SCHEDULE,
                                     resolve_schedule)

MOVES = 20
APP = "unsharp"


def _reg_state(design):
    return ({k: sorted(rb.reg_hops) for k, rb in design.routes.items()},
            {b.key: b.n_regs for b in design.netlist.branches})


def _capped(r) -> tuple:
    """What a power-capped compile reports: the summary, the controller's
    outcome and its whole trajectory."""
    pc = r.power_cap
    return (json.dumps(r.summary()), json.dumps(pc.summary()),
            [(p.round, p.critical_path_ns, p.freq_mhz, p.power_mw, p.edp_js,
              p.registers_added) for p in pc.trajectory],
            pc.rounds_rolled_back, r.post_pnr.history,
            r.post_pnr.stop_reason)


@pytest.fixture(scope="module")
def compiler():
    return CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())


@pytest.fixture(scope="module")
def ref_compiler():
    return RefCompiler(cache=RefCompileCache(), stage_cache=RefCompileCache())


@pytest.fixture(scope="module")
def uncapped(compiler):
    return compiler.compile(ALL_APPS[APP],
                            PassConfig.power_capped(None, place_moves=MOVES))


def _ref(ref_compiler, cap, app=APP, **kw):
    return ref_compiler.compile(REF_APPS[app], RefPassConfig.power_capped(
        cap, place_moves=MOVES, **kw), use_cache=False)


def test_named_schedule_resolution():
    assert resolve_schedule(None) == DEFAULT_SCHEDULE
    assert resolve_schedule("default") == DEFAULT_SCHEDULE
    assert resolve_schedule("power_capped") == POWER_CAPPED_SCHEDULE
    assert resolve_schedule(("build", "pnr")) == ("build", "pnr")
    assert set(NAMED_SCHEDULES) == {"default", "power_capped", "explore",
                                    "multi", "multi_power_capped"}
    # the capped schedules are their base flows with post_pnr swapped out
    assert POWER_CAPPED_SCHEDULE == tuple(
        "power_capped_pipeline" if n == "post_pnr" else n
        for n in DEFAULT_SCHEDULE)
    assert NAMED_SCHEDULES["multi_power_capped"] == tuple(
        "power_capped_pipeline" if n == "post_pnr" else n
        for n in NAMED_SCHEDULES["multi"])


def test_unknown_named_schedule_raises():
    with pytest.raises(KeyError, match="unknown named schedule"):
        PassPipeline.from_config(PassConfig(schedule="no_such_flow"))


def test_uncapped_matches_default_schedule_byte_identical(
        compiler, ref_compiler, uncapped):
    r_def = compiler.compile(ALL_APPS[APP], PassConfig.full(place_moves=MOVES))
    assert json.dumps(r_def.summary()) == json.dumps(uncapped.summary())
    assert _reg_state(r_def.design) == _reg_state(uncapped.design)
    assert r_def.post_pnr.stop_reason == uncapped.post_pnr.stop_reason
    assert r_def.post_pnr.history == uncapped.post_pnr.history
    r_inf = compiler.compile(ALL_APPS[APP], PassConfig.power_capped(
        float("inf"), place_moves=MOVES))
    assert json.dumps(r_inf.summary()) == json.dumps(uncapped.summary())
    assert _capped(uncapped) == _capped(_ref(ref_compiler, None))


def test_uncapped_records_monotone_power_trajectory(uncapped):
    pc = uncapped.power_cap
    assert pc.feasible and pc.cap_mw is None
    assert len(pc.trajectory) >= 2
    powers = [p.power_mw for p in pc.trajectory]
    assert powers == sorted(powers)
    regs = [p.registers_added for p in pc.trajectory]
    assert regs[0] == 0 and regs == sorted(regs)
    assert pc.final == pc.trajectory[-1]
    assert pc.final.power_mw == uncapped.power.power_mw
    assert pc.final.freq_mhz == uncapped.sta.max_freq_mhz


def test_cap_enforced_with_rollback(compiler, ref_compiler, uncapped):
    traj = uncapped.power_cap.trajectory
    cap = (traj[0].power_mw + traj[-1].power_mw) / 2.0
    r = compiler.compile(ALL_APPS[APP],
                         PassConfig.power_capped(cap, place_moves=MOVES))
    pc = r.power_cap
    assert pc.feasible and pc.stop_reason == "power_cap"
    assert pc.rounds_rolled_back == 1
    assert r.power.power_mw <= cap
    assert pc.final.power_mw == r.power.power_mw
    assert r.sta.max_freq_mhz < uncapped.sta.max_freq_mhz
    assert pc.final.registers_added < \
        uncapped.power_cap.final.registers_added
    capped_powers = [p.power_mw for p in pc.trajectory]
    assert capped_powers == [p.power_mw for p in traj[:len(capped_powers)]]
    assert _capped(r) == _capped(_ref(ref_compiler, cap))


def test_infeasible_cap_reports_initial_state(compiler, ref_compiler,
                                              uncapped):
    initial = uncapped.power_cap.initial
    cap = initial.power_mw * 0.5
    r = compiler.compile(ALL_APPS[APP], PassConfig.power_capped(
        cap, place_moves=MOVES))
    pc = r.power_cap
    assert not pc.feasible and pc.stop_reason == "cap_infeasible"
    assert pc.rounds_rolled_back == 0
    assert pc.final.registers_added == 0
    assert pc.final.power_mw == initial.power_mw
    assert pc.post_pnr.iterations == 0
    assert _capped(r) == _capped(_ref(ref_compiler, cap))


def test_checkpoint_roundtrip(compiler):
    design = compiler.compile(ALL_APPS[APP],
                              PassConfig.full(place_moves=MOVES)).design
    before = _reg_state(design)
    ckpt = DesignCheckpoint.capture(design)
    for rb in design.routes.values():
        if rb.hops:
            rb.reg_hops = set(range(len(rb.hops)))
        rb.branch.n_regs += 3
    assert _reg_state(design) != before
    ckpt.restore(design)
    assert _reg_state(design) == before


def test_checkpoint_forks_do_not_alias(compiler):
    design = compiler.compile(ALL_APPS[APP],
                              PassConfig.full(place_moves=MOVES)).design
    captured = _reg_state(design)
    ckpt = DesignCheckpoint.capture(design)
    for rb in design.routes.values():
        rb.branch.n_regs += 2
    f1, f2 = ckpt.fork(), ckpt.fork()
    for k in f1.reg_hops:
        f1.reg_hops[k].add(10_000)
    for k in f1.n_regs:
        f1.n_regs[k] += 5
    assert all(10_000 not in s for s in f2.reg_hops.values())
    assert all(10_000 not in s for s in ckpt.reg_hops.values())
    assert f2.n_regs == ckpt.n_regs and f1.n_regs != f2.n_regs
    f2.restore(design)
    assert _reg_state(design) == captured
    next(iter(design.routes.values())).branch.n_regs += 7
    assert f2.n_regs == ckpt.n_regs
    state_before_f1 = _reg_state(design)
    ckpt.fork().restore(design)
    assert _reg_state(design) == captured != state_before_f1


def test_cache_keys_on_cap_and_schedule(compiler):
    app = ALL_APPS[APP]
    f, t, e = compiler.fabric, compiler.timing, compiler.energy
    k_def = compile_key(app, PassConfig.full(), f, t, e)
    k_unc = compile_key(app, PassConfig.power_capped(None), f, t, e)
    k_300 = compile_key(app, PassConfig.power_capped(300.0), f, t, e)
    k_301 = compile_key(app, PassConfig.power_capped(301.0), f, t, e)
    assert len({k_def, k_unc, k_300, k_301}) == 4


def test_capped_results_cached_independently(compiler, uncapped):
    traj = uncapped.power_cap.trajectory
    cap = (traj[0].power_mw + traj[-1].power_mw) / 2.0
    cfg = PassConfig.power_capped(cap, place_moves=MOVES)
    r1 = compiler.compile(ALL_APPS[APP], cfg)
    r2 = compiler.compile(ALL_APPS[APP], cfg)
    assert r2.cache_hit
    assert _capped(r2) == _capped(r1)


@pytest.mark.parametrize("sta_backend", ["numpy", "torch"])
def test_capped_compile_on_every_sta_engine_equals_reference(
        ref_compiler, uncapped, sta_backend):
    """The controller's per-round STA on the numpy engine and on the torch
    engine (here on the CPU) gives the scalar reference's capped result."""
    traj = uncapped.power_cap.trajectory
    cap = (traj[0].power_mw + traj[-1].power_mw) / 2.0
    c = CascadeCompiler(cache=CompileCache(), device="cpu")
    r = c.compile(ALL_APPS[APP], PassConfig.power_capped(
        cap, place_moves=MOVES, sta_backend=sta_backend))
    assert _capped(r) == _capped(_ref(ref_compiler, cap))


@pytest.mark.slow
def test_every_dense_app_compiles_under_two_caps(ref_compiler):
    """Every dense app under two feasible caps through compile_batch: each
    result never exceeds its cap and equals the reference's compile of the
    same config."""
    c = CascadeCompiler(cache=CompileCache())
    apps = sorted(DENSE_APPS)
    base = dict(zip(apps, c.compile_batch(
        [(ALL_APPS[a], PassConfig.power_capped(None, place_moves=MOVES))
         for a in apps], backend="thread")))
    jobs, caps = [], []
    for a in apps:
        pc = base[a].power_cap
        lo, hi = pc.initial.power_mw, pc.final.power_mw
        for frac in (0.35, 0.75):
            cap = lo + frac * (hi - lo)
            caps.append((a, cap))
            jobs.append((ALL_APPS[a], PassConfig.power_capped(
                cap, place_moves=MOVES)))
    for (a, cap), r in zip(caps, c.compile_batch(jobs, backend="thread")):
        assert r.power_cap.feasible, (a, cap)
        assert r.power.power_mw <= cap + 1e-9, (a, cap, r.power.power_mw)
        assert r.power.power_mw == r.power_cap.final.power_mw, a
        assert r.sta.max_freq_mhz <= base[a].sta.max_freq_mhz + 1e-9, a
        assert _capped(r) == _capped(_ref(ref_compiler, cap, app=a)), a
