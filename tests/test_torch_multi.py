"""The port's multi-app fabric sharing (``repro_torch.core.multi``,
``compile_multi``, the ``"multi"`` schedules and the region fence), on the
CPU.

The first part is the reference's own cases (``tests/test_multi.py``)
replayed against ``repro_torch.core``. The second holds the port to the
reference: packs of ``benchmarks/multi_app.py``'s ``dense2`` and ``quad``
mixes at its 40 fast moves give equal regions, fabric summaries, flush
reports and per-resident design digests through both packages. The last
part covers what only the port has: a small pack on the torch engines
with ``device="cpu"`` (fenced, within the torch engines' cost bars), the
device rule of its keys, and no quiet fallback without CUDA.
"""

import warnings

import pytest

from repro_torch.core import (ALL_APPS, CascadeCompiler, CompileCache,
                        MultiAppSpec, PackingError, PassConfig, Region,
                        compile_key, env_float, flush_network_registers,
                        pack_regions, shared_flush, stateful_nodes)
from repro_torch.core.cache import stage_key
from repro_torch.core.dfg import CONTROL_PORT, DFG, INPUT, OUTPUT, PE
from repro_torch.core.flush import FLUSH, add_soft_flush, remove_flush
from repro_torch.core.interconnect import Fabric
from repro_torch.core.netlist import extract_netlist
from repro_torch.core.passes import (DEFAULT_SCHEDULE, MULTI_SCHEDULE,
                               NAMED_SCHEDULES, stage_plan)
from repro_torch.core.place import PlaceParams, place
from repro_torch.core.route import route


# ---------------------------------------------------------------------------
# regions and masked fabric views
# ---------------------------------------------------------------------------


def test_region_contains_and_io_ownership():
    r = Region(0, 4, 16, 8)
    assert r.contains((0, 4)) and r.contains((15, 11))
    assert not r.contains((16, 4)) and not r.contains((0, 3))
    assert r.contains((-1, 4)) and not r.contains((-1, 12))
    interior = Region(4, 4, 8, 8)
    assert not interior.contains((-1, 4))     # no IO off the north edge
    assert Region(0, 0, 4, 4).overlaps(Region(2, 2, 4, 4))
    assert not Region(0, 0, 4, 4).overlaps(Region(0, 4, 4, 4))


def test_subregion_masks_tiles_and_neighbors():
    f = Fabric()
    r = Region(0, 4, 16, 8)
    sub = f.subregion(r)
    assert all(r.contains(t) for t in sub.tiles())
    assert sub.io_tiles() == [(-1, c) for c in range(4, 12)]
    # adjacency never leaves the region, but tile kinds stay global
    assert (0, 3) not in sub.neighbors((0, 4))
    assert (16, 5) not in sub.neighbors((15, 5))
    assert sub.tile_kind((0, 7)) == f.tile_kind((0, 7)) == "mem"
    with pytest.raises(ValueError):
        f.subregion(Region(0, 12, 8, 8))      # spills past the east edge


# ---------------------------------------------------------------------------
# property-style: region-constrained placement + fenced routing
# ---------------------------------------------------------------------------

REGIONS = [Region(0, 0, 32, 8), Region(0, 8, 32, 8), Region(0, 4, 16, 8)]


@pytest.mark.parametrize("vectorized", [True, False])
@pytest.mark.parametrize("region", REGIONS)
def test_no_placed_node_or_routed_hop_leaves_region(vectorized, region):
    """Property: for both SA kernel paths, every placed node and every hop
    of every routed branch stays inside the app's region."""
    fabric = Fabric()
    nl = extract_netlist(ALL_APPS["vecadd"].build(1))
    pp = PlaceParams(seed=1, moves_per_node=20, vectorized=vectorized)
    placement = place(nl, fabric, pp, region=region)
    assert all(region.contains(t) for t in placement.values())
    design = route(nl, placement, fabric.subregion(region), region=region)
    for rb in design.routes.values():
        for h in rb.hops:
            assert region.contains(h.src) and region.contains(h.dst)


def test_scalar_and_vectorized_region_placements_identical():
    fabric = Fabric()
    nl = extract_netlist(ALL_APPS["unsharp"].build(1))
    region = Region(0, 0, 32, 8)
    a = place(nl, fabric, PlaceParams(seed=3, moves_per_node=20,
                                      vectorized=True), region=region)
    b = place(nl, fabric, PlaceParams(seed=3, moves_per_node=20,
                                      vectorized=False), region=region)
    assert a == b


def test_region_without_enough_sites_fails_loudly():
    fabric = Fabric()
    nl = extract_netlist(ALL_APPS["harris"].build(2))
    with pytest.raises(ValueError, match="region"):
        place(nl, fabric, PlaceParams(moves_per_node=10),
              region=Region(0, 0, 2, 4))


# ---------------------------------------------------------------------------
# the "multi" schedule and its stage-cache seams
# ---------------------------------------------------------------------------


def test_multi_schedule_registered_with_shared_physical_prefix():
    assert NAMED_SCHEDULES["multi"] == MULTI_SCHEDULE
    plan, dplan = stage_plan(MULTI_SCHEDULE), stage_plan(DEFAULT_SCHEDULE)
    # identical boundaries through the routed stage -> shared artifacts
    assert plan[:4] == dplan[:4]
    assert "region_fence_check" in MULTI_SCHEDULE


def test_region_keys_placed_but_not_mapped_stages():
    """PassConfig.region must key the placed/routed artifacts (different
    windows are different PnR problems) while leaving the mapped artifact
    shared with the app's ordinary compiles."""
    c = CascadeCompiler()
    app = ALL_APPS["unsharp"]
    plain = PassConfig.full(place_moves=20)
    from dataclasses import replace
    region = Region(0, 0, 32, 8)
    regioned = replace(plain, region=region, schedule="multi")
    prefix = DEFAULT_SCHEDULE[:4]
    args = (c.fabric, c.timing, c.energy)
    assert stage_key(app, plain, *args, stage="mapped", prefix=prefix) == \
        stage_key(app, regioned, *args, stage="mapped", prefix=prefix)
    placed_prefix = DEFAULT_SCHEDULE[:5]
    assert stage_key(app, plain, *args, stage="placed",
                     prefix=placed_prefix) != \
        stage_key(app, regioned, *args, stage="placed", prefix=placed_prefix)
    # and the final compile key separates regions too
    assert compile_key(app, plain, *args) != compile_key(app, regioned, *args)


def test_multi_compile_resumes_from_mapped_artifacts():
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    app, sp = ALL_APPS["unsharp"], ALL_APPS["vecadd"]
    cfg = PassConfig.full(place_moves=20)
    c.compile(app, cfg)                       # warms the app's mapped artifact
    c.compile(sp, cfg)
    m = c.compile_multi(MultiAppSpec.of(app, sp, config=cfg),
                        backend="thread")
    for r in m.results:
        assert r.pass_stats.get("stage_resume") == "mapped", r.app.name


# ---------------------------------------------------------------------------
# compile_multi: identity, packing, shared flush
# ---------------------------------------------------------------------------


def test_single_app_full_fabric_is_byte_identical_to_compile():
    """Acceptance: a 1-app pack in a full-fabric region is the identity —
    same cache key, same metrics as CascadeCompiler.compile."""
    import json
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    app = ALL_APPS["unsharp"]
    cfg = PassConfig.full(place_moves=20)
    r = c.compile(app, cfg)
    m = c.compile_multi(MultiAppSpec(jobs=((app, cfg),)))
    assert m.results[0].cache_hit              # hit r's entry: same key
    assert json.dumps(r.summary()) == json.dumps(m.results[0].summary())
    assert m.results[0].config.region is None  # config untouched
    assert m.regions[app.name].covers(c.fabric)
    assert m.summary["freq_mhz"] == pytest.approx(r.sta.max_freq_mhz)


def test_two_app_pack_disjoint_regions_and_shared_flush():
    """Acceptance: a dense+sparse pack has disjoint regions, one shared
    flush whose fanout is the sum of per-app stateful nodes, and a
    fabric-level min-freq / summed power+EDP rollup."""
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    cfg = PassConfig.full(place_moves=20)
    apps = (ALL_APPS["unsharp"], ALL_APPS["vecadd"])
    m = c.compile_multi(MultiAppSpec.of(*apps, config=cfg))
    regions = list(m.regions.values())
    assert len(regions) == 2
    assert not regions[0].overlaps(regions[1])
    for r in m.results:
        region = m.regions[r.app.name]
        assert all(region.contains(t) for t in r.design.placement.values())
        assert "region_fence_check" in r.pass_stats["pipeline"]
    expected = sum(len(stateful_nodes(r.design.netlist)) for r in m.results)
    assert m.flush.fanout == expected == sum(m.flush.per_app.values())
    assert m.flush.hardened
    assert m.flush.registers == flush_network_registers(c.fabric)
    assert m.flush.registers_separate == 2 * m.flush.registers
    assert m.flush.register_savings == m.flush.registers
    fabric_freq = min(r.sta.max_freq_mhz for r in m.results)
    assert m.summary["freq_mhz"] == pytest.approx(fabric_freq)
    # extensive quantities sum *at the shared clock*: each resident's
    # power is re-evaluated at the fabric frequency before summing
    from repro_torch.core import power_report
    at_clock = [power_report(r.design, fabric_freq, r.schedule, c.energy)
                for r in m.results]
    assert m.summary["power_mw"] == pytest.approx(
        sum(p.power_mw for p in at_clock))
    assert m.summary["edp_js"] == pytest.approx(
        sum(p.edp_js for p in at_clock))
    assert 0 < m.summary["utilization"] <= 1


def test_soft_flush_pack_never_aliases_mapped_artifacts():
    """Regression: a soft-flush pack must not resume from the standalone
    soft compile's mapped artifact (which contains the app's own routed
    ``__flush__``).  Residents are hardened per-app — harden_flush is a
    mapped-stage field, so the keys split — and the invariant must hold
    on the thread backend with warm caches, where resume actually
    happens (process workers compile cold and would mask aliasing)."""
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    cfg = PassConfig.full(place_moves=20, harden_flush=False)
    c.compile(ALL_APPS["unsharp"], cfg)   # warms soft-flush mapped artifact
    c.compile(ALL_APPS["vecadd"], cfg)
    m = c.compile_multi(MultiAppSpec.of(ALL_APPS["unsharp"],
                                        ALL_APPS["vecadd"], config=cfg),
                        backend="thread")
    for r in m.results:
        assert FLUSH not in r.design.netlist.nodes, r.app.name
        assert r.config.harden_flush      # pack hardens per-app flush
    assert not m.flush.hardened           # ... the *shared* flush is soft


def test_compile_multi_rejects_per_job_unroll():
    cfg = PassConfig.full(place_moves=20)
    with pytest.raises(ValueError, match="unroll"):
        CascadeCompiler().compile_multi([(ALL_APPS["unsharp"], cfg, 2)])
    # the spec path must reject the same shape, not silently drop job[2]
    with pytest.raises(ValueError, match="unroll"):
        MultiAppSpec(jobs=((ALL_APPS["unsharp"], cfg, 2),)).normalized()


def test_soft_shared_flush_caps_fabric_frequency():
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    cfg = PassConfig.full(place_moves=20, harden_flush=False)
    m = c.compile_multi(MultiAppSpec.of(ALL_APPS["unsharp"],
                                        ALL_APPS["vecadd"], config=cfg))
    assert not m.flush.hardened
    assert m.flush.register_savings == 0
    assert m.flush.critical_ns and m.flush.critical_ns > 0
    flush_freq = 1e3 / m.flush.critical_ns
    assert m.summary["freq_mhz"] <= flush_freq + 1e-9
    if flush_freq < min(r.sta.max_freq_mhz for r in m.results):
        assert m.summary["freq_limited_by"] == "__flush__"
    # a region'd resident never adds its own soft flush source
    for r in m.results:
        assert FLUSH not in r.design.netlist.nodes


def test_pack_regions_overflow_and_explicit_region_validation():
    f = Fabric()
    nls = [extract_netlist(ALL_APPS["unsharp"].build(1)) for _ in range(5)]
    with pytest.raises(PackingError, match="columns"):
        pack_regions(f, [(f"a{i}", nl) for i, nl in enumerate(nls)])
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    overlapping = (Region(0, 0, 32, 8), Region(0, 4, 32, 8))
    with pytest.raises(PackingError, match="overlap"):
        c.compile_multi(MultiAppSpec.of(ALL_APPS["unsharp"],
                                        ALL_APPS["vecadd"],
                                        config=PassConfig.full(place_moves=20),
                                        regions=overlapping))


def test_multi_spec_rejects_duplicate_names_and_preset_regions():
    app = ALL_APPS["unsharp"]
    with pytest.raises(ValueError, match="unique"):
        MultiAppSpec.of(app, app).normalized()
    cfg = PassConfig.full(region=Region(0, 0, 32, 8))
    with pytest.raises(ValueError, match="region"):
        MultiAppSpec(jobs=((app, cfg),)).normalized()
    capped = PassConfig.power_capped(300.0)
    with pytest.raises(ValueError, match="schedule"):
        MultiAppSpec(jobs=((app, capped),)).normalized()


# ---------------------------------------------------------------------------
# flush seam: soft-flush port allocation round-trip (bugfix)
# ---------------------------------------------------------------------------


def _dfg_snapshot(g):
    return (sorted((n.name, n.kind, n.op, n.width) for n in g.nodes.values()),
            list(g.edges))


def test_add_soft_flush_ports_never_collide_with_data():
    """Bugfix: a node with many in-edges must still get a side-band port at
    or above CONTROL_PORT — the old ``90 + fan-in`` scheme could collide
    with genuine data ports and drifted with connect order."""
    g = DFG("fat")
    srcs = [g.add(INPUT, name=f"in{i}") for i in range(95)]
    sink = g.add(PE, op="pass", latency=1)        # stateful: flush target
    g.connect(srcs[0], sink, port=0)
    for i, s in enumerate(srcs[1:], start=1):     # side-band-ish high ports
        g.connect(s, sink, port=CONTROL_PORT + i)
    existing = {e.port for e in g.in_edges(sink)}
    add_soft_flush(g)
    flush_edges = [e for e in g.edges if e.src == FLUSH]
    (edge,) = [e for e in flush_edges if e.dst == sink]
    assert edge.port >= CONTROL_PORT
    assert edge.port not in existing              # no collision, ever


def test_soft_flush_round_trip_is_byte_identical():
    g = ALL_APPS["unsharp"].build(1)
    before = _dfg_snapshot(g)
    fanout = add_soft_flush(g)
    assert fanout > 0 and FLUSH in g.nodes
    # every flush edge is side-band (control) — extraction must agree
    nl = extract_netlist(g)
    assert all(b.control for b in nl.branches if b.driver == FLUSH)
    remove_flush(g)
    assert _dfg_snapshot(g) == before


# ---------------------------------------------------------------------------
# config seams: env_float warning (bugfix)
# ---------------------------------------------------------------------------


def test_env_float_warns_on_unparsable_value(monkeypatch):
    monkeypatch.setenv("CASCADE_POWER_CAP_MW", "250mW")
    with pytest.warns(UserWarning, match="CASCADE_POWER_CAP_MW.*250mW"):
        assert env_float("CASCADE_POWER_CAP_MW") is None
    with pytest.warns(UserWarning):
        assert env_float("CASCADE_POWER_CAP_MW", 125.0) == 125.0
    monkeypatch.setenv("CASCADE_POWER_CAP_MW", "250.5")
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # parsable: no warning
        assert env_float("CASCADE_POWER_CAP_MW") == 250.5
    monkeypatch.delenv("CASCADE_POWER_CAP_MW")
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # unset: no warning
        assert env_float("CASCADE_POWER_CAP_MW", 1.0) == 1.0


# ---------------------------------------------------------------------------
# shared-flush unit behaviour
# ---------------------------------------------------------------------------


def test_shared_flush_report_shapes():
    f = Fabric()
    sinks = {"a": [(0, 0), (3, 2)], "b": [(5, 9)]}
    hard = shared_flush(sinks, f, harden=True)
    assert hard.residents == 2 and hard.fanout == 3
    assert hard.per_app == {"a": 2, "b": 1}
    assert hard.register_savings == flush_network_registers(f)
    assert hard.critical_ns is None
    from repro_torch.core import generate_timing_model
    soft = shared_flush(sinks, f, tm=generate_timing_model(f), harden=False)
    assert soft.registers == 0 and soft.critical_ns > 0


# ---------------------------------------------------------------------------
# the port against the reference: benchmarks/multi_app.py's mixes
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch.core import compile_multi, resident_config  # noqa: E402
from repro_torch.core.netlist import design_digest  # noqa: E402

# benchmarks/multi_app.py: its mixes and its fast move budget
FAST_MOVES = 40
MIXES = {"dense2": ("unsharp", "camera"),
         "quad": ("unsharp", "camera", "vecadd", "ttv")}


def pack_bytes(m) -> tuple:
    """A pack as the port is held to it: regions, the fabric summary, the
    shared flush report and each resident's summary and design digest."""
    return (sorted((n, (r.row0, r.col0, r.rows, r.cols))
                   for n, r in m.regions.items()),
            json.dumps(m.summary, sort_keys=True),
            json.dumps(dataclasses.asdict(m.flush), sort_keys=True),
            [(r.app.name, json.dumps(r.summary(), sort_keys=True),
              design_digest(r.design)) for r in m.results])


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_pack_equals_reference(mix):
    got, want = (
        pkg.CascadeCompiler(cache=pkg.CompileCache(),
                            stage_cache=pkg.CompileCache()).compile_multi(
            pkg.MultiAppSpec.of(*(pkg.ALL_APPS[a] for a in MIXES[mix]),
                                config=pkg.PassConfig.full(
                                    place_moves=FAST_MOVES)),
            verify=True, backend="thread")
        for pkg in (port, ref))
    assert pack_bytes(got) == pack_bytes(want)


def test_pack_equal_on_thread_and_process_backends():
    spec = MultiAppSpec.of(ALL_APPS["unsharp"], ALL_APPS["vecadd"],
                           config=PassConfig.full(place_moves=20))
    packs = [CascadeCompiler(cache=CompileCache(),
                             stage_cache=CompileCache()).compile_multi(
        spec, backend=b) for b in ("thread", "process")]
    assert pack_bytes(packs[0]) == pack_bytes(packs[1])


# ---------------------------------------------------------------------------
# the torch engines inside a region, on the CPU
# ---------------------------------------------------------------------------

TORCH = PassConfig.full(place_moves=20, pnr_backend="torch",
                        sta_backend="torch")


def resident_bars(c, app, cfg, region) -> tuple:
    """(torch placer cost, numpy placer cost in the same region, torch
    wirelength, A*'s wirelength on the torch placement) of one resident."""
    st = c.compile_to_stage(app, resident_config(cfg, region),
                            stage="routed").state
    host = c.compile_to_stage(
        app, resident_config(dataclasses.replace(cfg, pnr_backend="numpy"),
                             region), stage="routed").state
    astar = route(st["netlist"], st["placement"], st["place_fabric"],
                  region=region)
    return (st["pass_stats"]["pnr"]["place"]["best_cost"],
            host["pass_stats"]["pnr"]["place"]["best_cost"],
            st["design"].total_wirelength(), astar.total_wirelength())


def test_torch_engine_pack_on_cpu_fenced_and_within_bars():
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache(),
                        device="cpu")
    apps = (ALL_APPS["unsharp"], ALL_APPS["vecadd"])
    m = c.compile_multi(MultiAppSpec.of(*apps, config=TORCH),
                        backend="thread")
    for r in m.results:
        region = m.regions[r.app.name]
        fence = r.pass_stats["region_fence"]
        assert fence["region"] == (region.row0, region.col0, region.rows,
                                   region.cols)
        assert all(region.contains(t) for t in r.design.placement.values())
        cost_t, cost_n, wl_t, wl_a = resident_bars(c, r.app, TORCH, region)
        assert cost_t <= cost_n * 1.10          # tests/test_torch_pnr.py
        assert wl_t <= wl_a
    # the module-level driver takes the device too, and resumes nothing
    # from another compiler: the same pack from cold caches
    again = compile_multi(MultiAppSpec.of(*apps, config=TORCH),
                          device="cpu", backend="thread")
    assert pack_bytes(again) == pack_bytes(m)


def test_region_keys_carry_the_torch_placer_device():
    """A region'd torch placement made on the CPU is never served to a
    compile on the card: from the placed stage on, the keys differ by
    device; the mapped artifact stays shared."""
    cache, stages = CompileCache(), CompileCache()
    cpu = CascadeCompiler(cache=cache, stage_cache=stages, device="cpu")
    card = CascadeCompiler(cache=cache, stage_cache=stages, device="cuda")
    app = ALL_APPS["vecadd"]
    region = Region(0, 4, 32, 4)
    rc = resident_config(PassConfig.full(place_moves=20,
                                         pnr_backend="torch"), region)
    keys = [compile_key(app, rc, c.fabric, c.timing, c.energy,
                        device=c.device) for c in (cpu, card)]
    assert keys[0] != keys[1]
    same = {st: cpu.stage_key_for(app, rc, st) == card.stage_key_for(
        app, rc, st) for st in ("mapped", "placed", "routed")}
    assert same == {"mapped": True, "placed": False, "routed": False}
    r = cpu.compile(app, rc)
    assert cache.get(keys[0]) is not None and cache.get(keys[1]) is None
    assert stages.get(cpu.stage_key_for(app, rc, "placed")) is not None
    assert stages.get(card.stage_key_for(app, rc, "placed")) is None
    assert "region_fence_check" in r.pass_stats["pipeline"]
    # the host engines give the same result on either device: one key
    host = resident_config(PassConfig.full(place_moves=20), region)
    assert len({compile_key(app, host, c.fabric, c.timing, c.energy,
                            device=c.device) for c in (cpu, card)}) == 1


def test_torch_engine_pack_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("holds the behaviour without CUDA")
    spec = MultiAppSpec.of(ALL_APPS["unsharp"], ALL_APPS["vecadd"],
                           config=TORCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        CascadeCompiler(cache=CompileCache(),
                        stage_cache=CompileCache()).compile_multi(spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_multi(spec)
    sta_only = PassConfig.full(place_moves=20, sta_backend="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        compile_multi(MultiAppSpec.of(ALL_APPS["vecadd"], config=sta_only,
                                      regions=(Region(0, 0, 32, 4),)))
