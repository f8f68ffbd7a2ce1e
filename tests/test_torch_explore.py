"""The port's stage artifacts and design-space exploration against the JAX
package's, on the CPU.

Replays ``tests/test_explore.py`` against ``repro_torch.core``: the stage
model and its field audit, prefix stage keys, resumable compiles,
``compile_to_stage``, Pareto-frontier sweeps (byte-identical to
independent compiles), batch fan-out on threads and processes, and the
shared metric chain. Frontier points, resumes and stage artifacts are also
held to the reference's compiles of the same configs.
"""

import json
from dataclasses import dataclass, fields as dc_fields

import pytest

from repro.core import ALL_APPS as REF_APPS  # noqa: E402
from repro.core import CascadeCompiler as RefCompiler  # noqa: E402
from repro.core import CompileCache as RefCompileCache  # noqa: E402
from repro.core import ExploreSpec as RefExploreSpec  # noqa: E402
from repro.core import PassConfig as RefPassConfig  # noqa: E402
from repro_torch.core import (ALL_APPS, CONFIG_FIELD_STAGE,  # noqa: E402
                              DENSE_APPS, BatchCompileError, CascadeCompiler,
                              CompileCache, DesignMetrics, EnergyParams,
                              ExploreSpec, Fabric, PassConfig,
                              evaluate_design, evaluate_point,
                              generate_timing_model, stage_key, stage_plan)
from repro_torch.core.apps import AppSpec  # noqa: E402
from repro_torch.core.netlist import design_digest  # noqa: E402
from repro_torch.core.passes import (DEFAULT_SCHEDULE,  # noqa: E402
                                     EXPLORE_SCHEDULE, POWER_CAPPED_SCHEDULE,
                                     STAGE_OF_PASS, CompileContext)

MOVES = 20
APP = ALL_APPS["unsharp"]
REF_APP = REF_APPS["unsharp"]


@pytest.fixture(scope="module")
def compiler():
    return CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())


@pytest.fixture(scope="module")
def ref_compiler():
    return RefCompiler(cache=RefCompileCache(), stage_cache=RefCompileCache())


@pytest.fixture(scope="module")
def uncapped(compiler):
    return compiler.compile(APP, PassConfig.power_capped(None,
                                                         place_moves=MOVES))


def _spec_with_cap(uncapped, cls=ExploreSpec):
    """>= 4 (budget, cap) points, with a feasible mid-range cap."""
    traj = uncapped.power_cap.trajectory
    cap = (traj[0].power_mw + traj[-1].power_mw) / 2.0
    return cls(register_budgets=(4, 16, None), power_caps_mw=(cap, None))


def _independent_config(budget, cap):
    if cap is not None:
        return PassConfig.power_capped(cap, post_pnr_budget=budget,
                                       place_moves=MOVES)
    return PassConfig.full(post_pnr_budget=budget, place_moves=MOVES)


def _rows(frontier):
    return [p.scaled() for p in frontier.all_points()]


# ---------------------------------------------------------------------------
# schedules and stage structure
# ---------------------------------------------------------------------------


def test_explore_schedule_shape():
    assert EXPLORE_SCHEDULE == tuple(
        "pareto_frontier" if n == "post_pnr" else n for n in DEFAULT_SCHEDULE)
    assert "place" in DEFAULT_SCHEDULE and "route" in DEFAULT_SCHEDULE


def test_stage_plan_boundaries():
    plan = stage_plan(DEFAULT_SCHEDULE)
    assert plan == [("front_end", 1), ("mapped", 4), ("placed", 5),
                    ("routed", 6), ("pipelined", 7), ("report", 12)]
    assert stage_plan(POWER_CAPPED_SCHEDULE)[:4] == plan[:4]
    assert stage_plan(EXPLORE_SCHEDULE)[:4] == plan[:4]
    assert stage_plan(("build", "no_such_pass")) is None
    assert stage_plan(("place", "build")) is None
    assert stage_plan(("build", "pnr", "sta")) == [
        ("front_end", 1), ("routed", 2), ("report", 3)]


def test_config_field_stage_covers_every_field_exactly():
    """Every field of the port's PassConfig has a stage (else stage keys
    could alias configs) and no stale assignment lingers; every pass of a
    named schedule has a stage."""
    names = {f.name for f in dc_fields(PassConfig)}
    assert set(CONFIG_FIELD_STAGE) == names
    for sched in (DEFAULT_SCHEDULE, POWER_CAPPED_SCHEDULE, EXPLORE_SCHEDULE):
        assert all(n in STAGE_OF_PASS for n in sched)


def test_unmapped_config_field_refused():
    @dataclass
    class RogueConfig(PassConfig):
        mystery_knob: int = 3

    f = Fabric()
    with pytest.raises(KeyError, match="mystery_knob"):
        stage_key(APP, RogueConfig(), f, generate_timing_model(f),
                  EnergyParams(), stage="routed",
                  prefix=DEFAULT_SCHEDULE[:6])


def test_stage_key_shares_routed_prefix_across_post_pnr_knobs(compiler):
    f, t, e = compiler.fabric, compiler.timing, compiler.energy
    prefix = DEFAULT_SCHEDULE[:6]

    def routed(cfg):
        return stage_key(APP, cfg, f, t, e, stage="routed", prefix=prefix)

    base = routed(PassConfig.full())
    assert routed(PassConfig.full(post_pnr_budget=8)) == base
    assert routed(PassConfig.full(post_pnr_iters=7)) == base
    assert routed(PassConfig(power_cap_mw=300.0)) == base
    assert routed(PassConfig(explore=ExploreSpec(register_budgets=(1, 2)))) \
        == base
    assert routed(PassConfig(sta_backend="torch")) == base
    assert routed(PassConfig.full(seed=1)) != base
    assert routed(PassConfig.full(placement_alpha=2.0)) != base
    assert routed(PassConfig.full(rf_threshold=5)) != base
    assert routed(PassConfig.full(low_unroll_dup=False)) != base
    assert stage_key(APP, PassConfig.full(), f, t, e, stage="routed",
                     prefix=("build", "pnr")) != base
    assert stage_key(APP, PassConfig.full(), f, t, e, stage="placed",
                     prefix=DEFAULT_SCHEDULE[:5]) != base
    assert stage_key(ALL_APPS["gaussian"], PassConfig.full(), f, t, e,
                     stage="routed", prefix=prefix) != base


def test_compile_resumes_from_routed_artifact(compiler, ref_compiler,
                                              uncapped):
    """Same app, other post-PnR knobs: the compile resumes from the cached
    routed design and equals a cold compile, here and in the reference."""
    s0 = compiler.stage_cache.stats()["hits"]
    r = compiler.compile(APP, PassConfig.full(post_pnr_budget=8,
                                              place_moves=MOVES))
    assert r.pass_stats.get("stage_resume") == "routed"
    assert compiler.stage_cache.stats()["hits"] == s0 + 1
    cold = CascadeCompiler(cache=CompileCache()).compile(
        APP, PassConfig.full(post_pnr_budget=8, place_moves=MOVES),
        use_cache=False)
    assert json.dumps(r.summary()) == json.dumps(cold.summary())
    assert r.design.placement == cold.design.placement
    assert {k: sorted(rb.reg_hops) for k, rb in r.design.routes.items()} == \
        {k: sorted(rb.reg_hops) for k, rb in cold.design.routes.items()}
    ref_compiler.compile(REF_APP, RefPassConfig.power_capped(
        None, place_moves=MOVES))
    want = ref_compiler.compile(REF_APP, RefPassConfig.full(
        post_pnr_budget=8, place_moves=MOVES))
    assert want.pass_stats.get("stage_resume") == "routed"
    assert json.dumps(r.summary()) == json.dumps(want.summary())
    assert design_digest(r.design) == design_digest(want.design)


def test_compile_to_stage_artifact_roundtrip(compiler, ref_compiler):
    art = compiler.compile_to_stage(APP, PassConfig.full(place_moves=MOVES),
                                    stage="routed")
    assert art.stage == "routed"
    assert art.prefix == ("build", "compute_pipelining",
                          "broadcast_pipelining", "place", "route")
    assert art.state["design"] is not None
    assert art.state["design"].netlist is art.state["netlist"]
    want = ref_compiler.compile_to_stage(
        REF_APP, RefPassConfig.full(place_moves=MOVES), stage="routed")
    assert art.prefix == want.prefix
    assert art.state["placement"] == want.state["placement"]
    assert design_digest(art.state["design"]) == \
        design_digest(want.state["design"])


@pytest.mark.parametrize("app", sorted(DENSE_APPS))
def test_compile_to_stage_equals_reference_on_every_dense_app(app):
    """The routed artifact of every dense app: placement, design digest and
    executed passes equal the reference's."""
    got = CascadeCompiler(cache=CompileCache(),
                          stage_cache=CompileCache()).compile_to_stage(
        ALL_APPS[app], PassConfig.full(place_moves=MOVES), stage="routed")
    want = RefCompiler(cache=RefCompileCache(),
                       stage_cache=RefCompileCache()).compile_to_stage(
        REF_APPS[app], RefPassConfig.full(place_moves=MOVES), stage="routed")
    assert got.prefix == want.prefix
    assert got.state["placement"] == want.state["placement"]
    assert design_digest(got.state["design"]) == \
        design_digest(want.state["design"])


def test_stage_artifact_fork_is_fully_independent(compiler):
    art = compiler.compile_to_stage(APP, PassConfig.full(place_moves=MOVES),
                                    stage="routed")
    f1, f2 = art.fork(), art.fork()
    d1 = f1.state["design"]
    for rb in d1.routes.values():
        rb.branch.n_regs += 7
        if rb.hops:
            rb.reg_hops = set(range(len(rb.hops)))

    def regs(a):
        return [b.n_regs for b in a.state["design"].netlist.branches]
    assert regs(f1) != regs(f2)
    assert regs(f2) == regs(art)
    c1 = CompileContext(app=APP, config=PassConfig.full(place_moves=MOVES),
                        fabric=compiler.fabric, timing=compiler.timing,
                        energy=compiler.energy)
    f2.restore_into(c1)
    c1.design.netlist.branches[0].n_regs = 99
    assert f2.state["design"].netlist.branches[0].n_regs != 99


def test_mapped_netlist_equals_reference(compiler, ref_compiler):
    """The hardened config's mapped-stage netlist, node for node and
    branch for branch the reference's."""
    nl = compiler.mapped_netlist(APP)
    want = ref_compiler.mapped_netlist(REF_APP)
    assert sorted(nl.nodes) == sorted(want.nodes)
    assert sorted(b.key for b in nl.branches) == \
        sorted(b.key for b in want.branches)


# ---------------------------------------------------------------------------
# the frontier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frontier_result(compiler, uncapped):
    spec = _spec_with_cap(uncapped)
    return spec, compiler.compile(APP, PassConfig.frontier(spec,
                                                           place_moves=MOVES))


@pytest.fixture(scope="module")
def ref_frontier(ref_compiler, frontier_result):
    spec, _ = frontier_result
    ref_spec = RefExploreSpec(register_budgets=spec.register_budgets,
                              power_caps_mw=spec.power_caps_mw)
    return ref_compiler.compile(REF_APP, RefPassConfig.frontier(
        ref_spec, place_moves=MOVES), use_cache=False)


def test_frontier_equals_reference(frontier_result, ref_frontier):
    _, r = frontier_result
    assert _rows(r.frontier) == _rows(ref_frontier.frontier)
    assert json.dumps(r.summary()) == json.dumps(ref_frontier.summary())
    assert r.frontier.summary() == ref_frontier.frontier.summary()


@pytest.mark.parametrize("app", sorted(DENSE_APPS))
def test_frontier_equals_reference_on_every_dense_app(app):
    """A two-point sweep on every dense app, cold and warm: the frontier
    and the report equal the reference's."""
    spec = ExploreSpec(register_budgets=(8, None))
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    cold = c.compile(ALL_APPS[app], PassConfig.frontier(spec,
                                                        place_moves=MOVES))
    warm = c.compile(ALL_APPS[app], PassConfig.frontier(spec,
                                                        place_moves=MOVES))
    want = RefCompiler(cache=RefCompileCache()).compile(
        REF_APPS[app], RefPassConfig.frontier(
            RefExploreSpec(register_budgets=(8, None)), place_moves=MOVES),
        use_cache=False)
    assert warm.cache_hit
    for r in (cold, warm):
        assert _rows(r.frontier) == _rows(want.frontier)
        assert json.dumps(r.summary()) == json.dumps(want.summary())


def test_frontier_points_byte_identical_to_independent_compiles(
        compiler, frontier_result):
    spec, r = frontier_result
    fr = r.frontier
    assert len(fr.all_points()) == len(spec.points()) >= 4
    for budget, cap in spec.points():
        pt = fr.point_for(budget, cap)
        ind = compiler.compile(APP, _independent_config(budget, cap))
        assert pt.freq_mhz == ind.sta.max_freq_mhz, (budget, cap)
        assert pt.power_mw == ind.power.power_mw, (budget, cap)
        assert pt.edp_js == ind.power.edp_js, (budget, cap)
        assert pt.critical_path_ns == ind.sta.critical_path_ns, (budget, cap)
        assert pt.registers_added == ind.design.netlist.added_registers(), \
            (budget, cap)


def test_frontier_returns_only_nondominated_points(frontier_result):
    _, r = frontier_result
    front = r.frontier.points
    assert front
    for p in front:
        for q in front:
            if p is q:
                continue
            assert not ((q.freq_mhz >= p.freq_mhz
                         and q.power_mw <= p.power_mw)
                        and (q.freq_mhz > p.freq_mhz
                             or q.power_mw < p.power_mw))
    for d in r.frontier.dominated:
        assert d.dominated
        assert any(q.freq_mhz >= d.freq_mhz and q.power_mw <= d.power_mw
                   and (q.freq_mhz > d.freq_mhz or q.power_mw < d.power_mw)
                   for q in r.frontier.all_points())


def test_selected_point_is_materialized_in_the_report(frontier_result):
    _, r = frontier_result
    sel = r.frontier.selected
    assert sel in r.frontier.points and sel.feasible
    assert sel.edp_js == min(p.edp_js for p in r.frontier.points
                             if p.feasible)
    assert r.sta.max_freq_mhz == sel.freq_mhz
    assert r.power.power_mw == sel.power_mw
    assert r.power.edp_js == sel.edp_js
    assert r.design.netlist.added_registers() == sel.registers_added
    assert r.power_cap is sel.result or \
        r.power_cap.summary() == sel.result.summary()


def test_capped_points_respect_their_cap(frontier_result):
    _, r = frontier_result
    for p in r.frontier.all_points():
        if p.power_cap_mw is not None and p.feasible:
            assert p.power_mw <= p.power_cap_mw + 1e-9


def test_frontier_result_caches_and_roundtrips(compiler, frontier_result):
    spec, r = frontier_result
    again = compiler.compile(APP, PassConfig.frontier(spec,
                                                      place_moves=MOVES))
    assert again.cache_hit
    assert [p.scaled() for p in again.frontier.points] == \
        [p.scaled() for p in r.frontier.points]


def test_warm_reselect_resumes_from_the_routed_artifact(
        compiler, frontier_result, ref_compiler, ref_frontier):
    """Another selection policy over the same grid is a new compile that
    resumes from the routed artifact, as in the reference."""
    spec, _ = frontier_result
    spec = ExploreSpec(register_budgets=spec.register_budgets,
                       power_caps_mw=spec.power_caps_mw, select="max_freq")
    r = compiler.compile(APP, PassConfig.frontier(spec, place_moves=MOVES))
    assert r.pass_stats["stage_resume"] == "routed"
    want = ref_compiler.compile(REF_APP, RefPassConfig.frontier(
        RefExploreSpec(register_budgets=spec.register_budgets,
                       power_caps_mw=spec.power_caps_mw, select="max_freq"),
        place_moves=MOVES))
    assert _rows(r.frontier) == _rows(want.frontier)
    assert json.dumps(r.summary()) == json.dumps(want.summary())


def test_default_spec_degenerates_to_plain_flow(compiler):
    plain = compiler.compile(APP, PassConfig.full(place_moves=MOVES))
    one = compiler.compile(APP, PassConfig.frontier(place_moves=MOVES))
    assert json.dumps(plain.summary()) == json.dumps(one.summary())
    assert len(one.frontier.all_points()) == 1


def test_explore_schedule_honours_config_power_cap(compiler, uncapped):
    traj = uncapped.power_cap.trajectory
    cap = (traj[0].power_mw + traj[-1].power_mw) / 2.0
    r = compiler.compile(APP, PassConfig(schedule="explore",
                                         power_cap_mw=cap,
                                         place_moves=MOVES))
    assert r.frontier.spec.power_caps_mw == (cap,)
    assert r.power.power_mw <= cap + 1e-9
    capped = compiler.compile(APP, PassConfig.power_capped(cap,
                                                           place_moves=MOVES))
    assert r.power.power_mw == capped.power.power_mw
    with pytest.raises(ValueError, match="mutually exclusive"):
        compiler.compile(APP, PassConfig(schedule="explore",
                                         power_cap_mw=cap,
                                         explore=ExploreSpec(),
                                         place_moves=MOVES))


def test_compile_to_stage_repeat_is_pure_cache_fork(compiler):
    cfg = PassConfig.full(place_moves=MOVES)
    a1 = compiler.compile_to_stage(APP, cfg, stage="routed")
    h0 = compiler.stage_cache.stats()["hits"]
    a2 = compiler.compile_to_stage(APP, cfg, stage="routed")
    assert compiler.stage_cache.stats()["hits"] == h0 + 1
    assert [b.n_regs for b in a1.state["design"].netlist.branches] == \
        [b.n_regs for b in a2.state["design"].netlist.branches]
    a2.state["design"].netlist.branches[0].n_regs = 77
    a3 = compiler.compile_to_stage(APP, cfg, stage="routed")
    assert a3.state["design"].netlist.branches[0].n_regs != 77


def test_explore_spec_validation():
    with pytest.raises(ValueError, match="objective"):
        ExploreSpec(objectives=("freq_mhz", "nope")).validate()
    with pytest.raises(ValueError, match="select"):
        ExploreSpec(select="best_vibes").validate()
    with pytest.raises(ValueError, match="at least one"):
        ExploreSpec(register_budgets=()).validate()
    assert ExploreSpec().validate().points() == [(None, None)]


@pytest.mark.parametrize("sta_backend", ["numpy", "torch"])
def test_frontier_on_every_sta_engine_equals_reference(
        frontier_result, ref_frontier, sta_backend):
    """The sweep's STA on the numpy engine and on the torch engine (here on
    the CPU) gives the scalar reference's frontier."""
    spec, _ = frontier_result
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache(),
                        device="cpu")
    r = c.compile(APP, PassConfig.frontier(spec, place_moves=MOVES,
                                           sta_backend=sta_backend))
    assert _rows(r.frontier) == _rows(ref_frontier.frontier)


# ---------------------------------------------------------------------------
# batch fan-out
# ---------------------------------------------------------------------------


def test_compile_batch_fans_out_frontier_points_thread(frontier_result,
                                                       ref_frontier):
    spec, serial = frontier_result
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    (r,) = c.compile_batch([(APP, PassConfig.frontier(spec,
                                                      place_moves=MOVES))],
                           backend="thread")
    assert c.last_batch["explore_jobs"] == 1
    assert c.last_batch["explore_points"] == len(spec.points())
    assert json.dumps(r.summary()) == json.dumps(serial.summary())
    assert _rows(r.frontier) == _rows(serial.frontier) == \
        _rows(ref_frontier.frontier)


@pytest.mark.slow
def test_compile_batch_fans_out_frontier_points_process(frontier_result,
                                                        ref_frontier):
    spec, serial = frontier_result
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    (r,) = c.compile_batch([(APP, PassConfig.frontier(spec,
                                                      place_moves=MOVES))],
                           backend="process", max_workers=2)
    assert c.last_batch["explore_points"] == len(spec.points())
    assert json.dumps(r.summary()) == json.dumps(serial.summary())
    assert _rows(r.frontier) == _rows(serial.frontier) == \
        _rows(ref_frontier.frontier)


def _broken_builder(copy_idx, g, line_width):
    raise ValueError("builder exploded")


def test_batch_exception_names_job_and_app():
    boom = AppSpec("boomapp", _broken_builder)
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    jobs = [(APP, PassConfig.full(place_moves=MOVES)), (boom, None)]
    with pytest.raises(BatchCompileError) as ei:
        c.compile_batch(jobs, backend="thread", use_cache=False)
    assert ei.value.job_index == 1
    assert ei.value.app_name == "boomapp"
    assert "boomapp" in str(ei.value) and "job 1" in str(ei.value)


def test_batch_exception_names_frontier_point():
    spec = ExploreSpec(register_budgets=(4, None),
                       power_caps_mw=(None,), select="best_vibes")
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    with pytest.raises(BatchCompileError) as ei:
        c.compile_batch([(APP, PassConfig.frontier(spec,
                                                   place_moves=MOVES))],
                        backend="thread")
    assert ei.value.job_index == 0
    assert ei.value.app_name == APP.name


# ---------------------------------------------------------------------------
# the shared metric chain
# ---------------------------------------------------------------------------


def test_metric_chain_byte_identity_with_report_passes(compiler, uncapped):
    r = uncapped
    tm = generate_timing_model(r.design.fabric)
    iters = APP.iterations_for(r.design.unroll_copies)
    m = evaluate_design(r.design, tm, compiler.energy, iters)
    assert isinstance(m, DesignMetrics)
    assert m.freq_mhz == r.sta.max_freq_mhz
    assert m.critical_path_ns == r.sta.critical_path_ns
    assert m.power_mw == r.power.power_mw
    assert m.edp_js == r.power.edp_js
    assert m.schedule.total_cycles == r.schedule.total_cycles
    pt = evaluate_point(r.design, tm, compiler.energy, iters)
    assert (pt.freq_mhz, pt.power_mw, pt.edp_js) == \
        (m.freq_mhz, m.power_mw, m.edp_js)
    pc = r.power_cap
    assert pc.final.power_mw == r.power.power_mw
    assert pc.final.freq_mhz == r.sta.max_freq_mhz
    assert pc.final.edp_js == r.power.edp_js
