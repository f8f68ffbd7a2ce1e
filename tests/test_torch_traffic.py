"""The port's trace-driven throughput replay (``repro_torch.core.traffic``),
on the CPU.

The reference's cases (``tests/test_traffic.py``) replayed against
``repro_torch.core``, then the same trace over the same pack through both
packages: equal ``TrafficReport`` rows, summary and objective.
"""

import pytest

from repro_torch.core import (ALL_APPS, CascadeCompiler, CompileCache,
                        MultiAppSpec, PassConfig, Region, TrafficTrace,
                        flush_downtime_cycles, periodic_trace, poisson_trace,
                        reconfig_cycles, replay, session_trace)
from repro_torch.core.interconnect import Fabric


@pytest.fixture(scope="module")
def pack():
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    cfg = PassConfig.full(place_moves=20)
    return c.compile_multi(MultiAppSpec.of(
        ALL_APPS["unsharp"], ALL_APPS["vecadd"], config=cfg))


# ---------------------------------------------------------------------------
# trace generators
# ---------------------------------------------------------------------------


def test_periodic_trace_shape_and_phase():
    t = periodic_trace(["a", "b"], period=100, n_requests=5, phase=7)
    assert t.arrivals["a"] == [0, 100, 200, 300, 400]
    assert t.arrivals["b"] == [7, 107, 207, 307, 407]
    assert t.total_requests() == 10
    assert t.horizon() == 407


def test_poisson_trace_deterministic_per_seed():
    a = poisson_trace(["x"], mean_gap=50, n_requests=20, seed=3)
    b = poisson_trace(["x"], mean_gap=50, n_requests=20, seed=3)
    c = poisson_trace(["x"], mean_gap=50, n_requests=20, seed=4)
    assert a.arrivals == b.arrivals
    assert a.arrivals != c.arrivals
    gaps = [y - x for x, y in zip(a.arrivals["x"], a.arrivals["x"][1:])]
    assert all(g >= 1 for g in gaps)          # strictly advancing arrivals


def test_trace_param_validation():
    with pytest.raises(ValueError):
        periodic_trace(["a"], period=0, n_requests=5)
    with pytest.raises(ValueError):
        periodic_trace(["a"], period=10, n_requests=0)
    with pytest.raises(ValueError):
        poisson_trace(["a"], mean_gap=-1, n_requests=5)


def test_empty_trace_helpers():
    t = TrafficTrace({"a": []}, name="empty")
    assert t.total_requests() == 0 and t.horizon() == 0


# ---------------------------------------------------------------------------
# downtime charges
# ---------------------------------------------------------------------------


def test_flush_and_reconfig_charges():
    f = Fabric()
    assert flush_downtime_cycles(f, hardened=True) == 2 + f.rows
    assert flush_downtime_cycles(f, hardened=False) == 1
    assert reconfig_cycles(Region(0, 0, 4, 8)) == 32


# ---------------------------------------------------------------------------
# replay against a real pack
# ---------------------------------------------------------------------------


def test_replay_reports_sane_stats(pack):
    trace = periodic_trace(["unsharp", "vecadd"], period=5000,
                           n_requests=10, phase=13)
    rep = replay(pack, trace, iterations=256)
    assert set(rep.per_app) == {"unsharp", "vecadd"}
    assert rep.freq_mhz == pytest.approx(pack.summary["freq_mhz"])
    for s in rep.per_app.values():
        assert s.requests == 10
        assert s.fill_latency_cycles > 0
        assert s.service_cycles >= s.fill_latency_cycles
        assert s.mean_latency_cycles >= s.service_cycles
        assert s.p95_latency_cycles >= s.mean_latency_cycles - 1e-9
        assert s.steady_rps > 0 and s.achieved_rps > 0
        # downtime = one reconfig + a flush between each pair of requests
        assert s.downtime_cycles == (s.reconfig_cycles
                                     + (s.requests - 1) * s.flush_cycles)
        assert s.busy_cycles == s.requests * s.service_cycles
        assert s.makespan_cycles >= s.busy_cycles
    summary = rep.summary()
    assert summary["requests"] == 20
    assert summary["achieved_rps"] == pytest.approx(
        sum(s.achieved_rps for s in rep.per_app.values()), rel=1e-3)
    row_keys = {k for r in rep.rows() for k in r}
    assert {"app", "steady_rps", "achieved_rps", "downtime_frac"} <= row_keys


def test_replay_saturation_vs_slack(pack):
    """A back-to-back trace queues (latency grows); a sparse trace does
    not (latency flat at service + flush)."""
    apps = ["unsharp"]
    tight = replay(pack, periodic_trace(apps, period=1, n_requests=20),
                   iterations=256)
    slack = replay(pack, periodic_trace(apps, period=10**6, n_requests=20),
                   iterations=256)
    t, s = tight.per_app["unsharp"], slack.per_app["unsharp"]
    assert t.mean_latency_cycles > s.mean_latency_cycles
    assert s.mean_latency_cycles <= s.service_cycles + s.flush_cycles \
        + s.reconfig_cycles
    # the saturated server approaches its steady-state ceiling
    assert t.achieved_rps == pytest.approx(t.steady_rps, rel=0.05)


def test_replay_iterations_scale_service(pack):
    trace = periodic_trace(["vecadd"], period=10**6, n_requests=4)
    small = replay(pack, trace, iterations=64)
    big = replay(pack, trace, iterations=4096)
    assert big.per_app["vecadd"].service_cycles > \
        small.per_app["vecadd"].service_cycles
    # fill latency is a property of the schedule, not the request size
    assert big.per_app["vecadd"].fill_latency_cycles == \
        small.per_app["vecadd"].fill_latency_cycles


def test_replay_objective_trades_throughput_against_latency(pack):
    rep = replay(pack, periodic_trace(["unsharp", "vecadd"], period=2000,
                                      n_requests=10, phase=13),
                 iterations=256)
    total_rps = sum(s.achieved_rps for s in rep.per_app.values())
    # weight 0: pure throughput; growing weight strictly penalizes latency
    assert rep.objective(latency_weight=0.0) == pytest.approx(total_rps)
    assert rep.objective(latency_weight=1.0) < total_rps
    assert rep.objective(latency_weight=10.0) < rep.objective(
        latency_weight=1.0)
    assert rep.summary()["objective"] == pytest.approx(rep.objective(),
                                                       abs=1e-3)


def test_replay_rejects_non_resident_apps(pack):
    trace = periodic_trace(["harris"], period=100, n_requests=3)
    with pytest.raises(ValueError, match="non-resident"):
        replay(pack, trace)


# ---------------------------------------------------------------------------
# online traces: departures, event streams, windows, sessions
# ---------------------------------------------------------------------------


def test_departures_extend_horizon_and_order_events():
    t = TrafficTrace({"a": [0, 100], "b": [50]}, name="online",
                     departures={"a": 300})
    assert t.horizon() == 300
    assert t.arrival_of("a") == 0 and t.arrival_of("missing") is None
    assert t.events() == [(0, "arrive", "a"), (50, "arrive", "b"),
                          (300, "depart", "a")]
    # at equal cycles the departure sorts first: the leaver frees its
    # region before the simultaneous arrival claims one
    t2 = TrafficTrace({"a": [0], "b": [200]}, departures={"a": 200})
    assert t2.events()[1:] == [(200, "depart", "a"), (200, "arrive", "b")]


def test_restricted_windows_arrivals_for_epoch_replay():
    t = TrafficTrace({"a": [0, 100, 200], "b": [50, 250]},
                     departures={"a": 220})
    sub = t.restricted(["a"], 100, 220)
    assert sub.arrivals == {"a": [100, 200]}
    assert sub.departures is None
    assert t.restricted(["a", "b"], 260, None).arrivals == {}


def test_session_trace_requests_and_validation():
    t = session_trace([("a", 0, 500), ("b", 100, None)], period=200,
                      name="s")
    assert t.arrivals["a"] == [0, 200, 400]
    assert t.arrivals["b"] == [100]              # open-ended: one request
    assert t.departures == {"a": 500}
    with pytest.raises(ValueError, match="duplicate"):
        session_trace([("a", 0, 100), ("a", 50, None)], period=10)
    with pytest.raises(ValueError, match="departs"):
        session_trace([("a", 100, 100)], period=10)
    with pytest.raises(ValueError, match="period"):
        session_trace([("a", 0, 100)], period=0)


def test_objective_latency_weight_default_pinned(pack):
    """Regression pin: the default latency weight is 1.0 — the online
    scheduler consumes objective() as its admission score, so a silent
    default change would reshuffle every admission decision."""
    trace = periodic_trace(["unsharp", "vecadd"], period=2000,
                           n_requests=8, phase=13)
    rep = replay(pack, trace, iterations=256)
    assert rep.latency_weight == 1.0
    assert rep.objective() == pytest.approx(rep.objective(latency_weight=1.0))
    # replay() threads a configurable weight into the report's default
    heavy = replay(pack, trace, iterations=256, latency_weight=5.0)
    assert heavy.latency_weight == 5.0
    assert heavy.objective() == pytest.approx(
        rep.objective(latency_weight=5.0))
    assert heavy.objective() < rep.objective()


def test_app_objectives_sum_to_objective(pack):
    trace = periodic_trace(["unsharp", "vecadd"], period=2000,
                           n_requests=8, phase=13)
    rep = replay(pack, trace, iterations=256, latency_weight=2.0)
    per_app = rep.app_objectives()
    assert set(per_app) == {"unsharp", "vecadd"}
    assert sum(per_app.values()) == pytest.approx(rep.objective())
    assert sum(rep.app_objectives(latency_weight=0.0).values()) == \
        pytest.approx(rep.objective(latency_weight=0.0))


# ---------------------------------------------------------------------------
# the port against the reference: the same trace over the same pack
# ---------------------------------------------------------------------------

import json  # noqa: E402

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402


@pytest.fixture(scope="module")
def ref_pack():
    c = ref.CascadeCompiler(cache=ref.CompileCache(),
                            stage_cache=ref.CompileCache())
    cfg = ref.PassConfig.full(place_moves=20)
    return c.compile_multi(ref.MultiAppSpec.of(
        ref.ALL_APPS["unsharp"], ref.ALL_APPS["vecadd"], config=cfg))


def traces(pkg, kind):
    apps = ["unsharp", "vecadd"]
    if kind == "periodic":
        return pkg.periodic_trace(apps, period=2000, n_requests=10, phase=13)
    if kind == "poisson":
        return pkg.poisson_trace(apps, mean_gap=1500.0, n_requests=12,
                                 seed=4)
    return pkg.session_trace([("unsharp", 0, 9_000), ("vecadd", 700, None)],
                             period=1_000, name="sessions")


def report_bytes(rep) -> tuple:
    return (json.dumps(rep.rows(), sort_keys=True),
            json.dumps(rep.summary(), sort_keys=True),
            rep.objective(), rep.objective(latency_weight=3.0),
            json.dumps(rep.app_objectives(), sort_keys=True))


@pytest.mark.parametrize("kind", ["periodic", "poisson", "session"])
@pytest.mark.parametrize("iterations", [None, 256])
def test_replay_equals_reference(pack, ref_pack, kind, iterations):
    got_t, want_t = traces(port, kind), traces(ref, kind)
    assert got_t.arrivals == want_t.arrivals
    assert got_t.departures == want_t.departures
    assert got_t.events() == want_t.events()
    assert report_bytes(replay(pack, got_t, iterations=iterations)) == \
        report_bytes(ref.replay(ref_pack, want_t, iterations=iterations))


def test_downtime_charges_equal_reference():
    for rows, cols, stride in ((32, 16, 4), (8, 16, 4), (12, 9, 3)):
        f = Fabric(rows=rows, cols=cols, mem_col_stride=stride)
        rf = ref.Fabric(rows=rows, cols=cols, mem_col_stride=stride)
        for hard in (True, False):
            assert flush_downtime_cycles(f, hard) == \
                ref.flush_downtime_cycles(rf, hard)
        assert reconfig_cycles(Region(0, 0, rows, cols)) == \
            ref.reconfig_cycles(ref.Region(0, 0, rows, cols))
