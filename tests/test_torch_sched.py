"""The port's online fabric scheduler (``repro_torch.core.sched``), on the
CPU.

The reference's fast cases (``tests/test_sched.py``) replayed against
``repro_torch.core``: admission, re-pack, eviction, waitlist readmission,
the pack-level power cap, online against static. Then the reference's
``benchmarks/serve_online.py`` ``wide_waves`` trace through both packages:
equal event logs and summaries. The reference's soak is in
``tests/test_torch_sched_soak.py``, a file of its own.
"""

import dataclasses
import json
import random

import pytest

from repro_torch.core import (ALL_APPS, CascadeCompiler, CompileCache,
                        CompileService, FabricScheduler, PassConfig,
                        evaluate_static, resident_config, session_trace,
                        validate_regions)
from repro_torch.core.interconnect import Fabric

CFG = PassConfig.full(place_moves=20)

# 8x16 @ stride 4: four column groups.  vecadd/elemmul/ttv need one group
# (width 4), mttkrp needs two adjacent groups (width 8) — which is what
# makes departures fragment the column space.
FABRIC = Fabric(rows=8, cols=16, mem_col_stride=4, name="sched8x16")
NARROW = Fabric(rows=8, cols=8, mem_col_stride=4, name="sched8x8")


def make_service(fabric):
    return CompileService(fabric=fabric, batch_window_s=0.0).start()


def configs(names):
    return {n: CFG for n in names}


def run_sched(trace, apps, fabric, **kw):
    svc = make_service(fabric)
    try:
        sched = FabricScheduler(service=svc, **kw)
        return sched.run(trace, apps, configs=configs(trace.arrivals))
    finally:
        svc.stop()


class AuditScheduler(FabricScheduler):
    """Checks region invariants after every logged event and records each
    seated compile, so the soak can verify byte-identity later."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seated = {}                 # app -> [(region, result), ...]

    def _log(self, out, cycle, kind, app, **detail):
        super()._log(out, cycle, kind, app, **detail)
        regs = {n: r.region for n, r in self._residents.items()}
        if regs:
            validate_regions(self.fabric, list(regs.values()),
                             list(regs), needs_io=[True] * len(regs))

    def _compile_into(self, app, cfg, slot, rows, cols, cycle, out):
        ok = super()._compile_into(app, cfg, slot, rows, cols, cycle, out)
        if ok:
            self.seated.setdefault(app.name, []).append(
                (slot, self._residents[app.name].result))
        return ok


# ---------------------------------------------------------------------------
# fast-lane behaviour tests
# ---------------------------------------------------------------------------


def test_admission_places_minimal_regions_and_accounts_epochs():
    trace = session_trace([("vecadd", 0, 3_000_000),
                           ("elemmul", 100, None)],
                          period=200_000, name="admit")
    out = run_sched(trace, ALL_APPS, FABRIC)
    assert out.admitted == 2 and out.rejected == 0
    assert out.objective > 0 and len(out.epochs) >= 1
    # minimal windows, not full-height strips
    assert out.final_pack is not None
    for region in out.final_pack.regions.values():
        assert region.rows < FABRIC.rows
        assert region.row0 == 0                  # IO apps own the north edge


def test_rejection_when_fabric_full_and_no_evict():
    trace = session_trace([("vecadd", 0, None),
                           ("elemmul", 100, None),
                           ("ttv", 2_000_000, 40_000_000)],
                          period=100_000, name="full")
    out = run_sched(trace, ALL_APPS, NARROW, allow_evict=False)
    assert out.admitted == 2
    assert out.rejected == 1
    reject = [e for e in out.events if e["event"] == "reject"]
    assert reject and reject[0]["app"] == "ttv"


def test_repack_defragments_for_wide_arrival():
    """Three width-4 residents, one departs from the middle: the width-8
    arrival only fits after the compacting re-pack."""
    trace = session_trace([("vecadd", 0, None),
                           ("elemmul", 100, 3_000_000),
                           ("ttv", 200, None),
                           ("mttkrp", 4_000_000, None)],
                          period=100_000, name="frag")
    out = run_sched(trace, ALL_APPS, FABRIC)
    assert out.admitted == 4 and out.rejected == 0
    assert out.repacks == 1
    repack = [e for e in out.events if e["event"] == "repack"][0]
    assert repack["app"] == "mttkrp" and repack["moved"]
    assert set(out.final_pack.regions) == {"vecadd", "ttv", "mttkrp"}
    # without repack the same trace rejects the wide app
    out_norepack = run_sched(trace, ALL_APPS, FABRIC, allow_repack=False,
                             allow_evict=False)
    assert out_norepack.rejected == 1


def test_eviction_prefers_low_remaining_offered_load():
    trace = session_trace([("vecadd", 0, 40_000_000),        # long session
                           ("elemmul", 100, 6_000_000),      # near its end
                           ("ttv", 2_000_000, 30_000_000)],  # heavy newcomer
                          period=100_000, name="evict")
    out = run_sched(trace, ALL_APPS, NARROW)
    assert out.evicted == 1
    evict = [e for e in out.events if e["event"] == "evict"][0]
    assert evict["app"] == "elemmul" and evict["for_app"] == "ttv"
    assert out.admitted == 3                     # ttv seated after the evict
    assert out.final_pack is None                # every session departed


def test_rejected_arrival_readmitted_after_departure_byte_identical():
    trace = session_trace([("vecadd", 0, 10_000_000),
                           ("elemmul", 100, None),
                           ("ttv", 5_000_000, 30_000_000)],
                          period=100_000, name="readmit")
    svc = make_service(NARROW)
    try:
        sched = AuditScheduler(service=svc, allow_evict=False)
        out = sched.run(trace, ALL_APPS, configs=configs(trace.arrivals))
    finally:
        svc.stop()
    assert out.rejected == 1 and out.readmitted == 1
    kinds = [(e["event"], e["app"]) for e in out.events]
    assert kinds.index(("reject", "ttv")) < kinds.index(("readmit", "ttv"))
    # the readmission compile is byte-identical to a fresh cold compile
    region, served = sched.seated["ttv"][-1]
    fresh = CascadeCompiler(fabric=NARROW, cache=CompileCache(),
                            stage_cache=CompileCache())
    direct = fresh.compile(ALL_APPS["ttv"], resident_config(CFG, region))
    assert served.design.placement == direct.design.placement
    assert (json.dumps(served.summary(), sort_keys=True)
            == json.dumps(direct.summary(), sort_keys=True))


def test_pack_power_cap_recompiles_residents():
    trace = session_trace([("vecadd", 0, None), ("elemmul", 100, None)],
                          period=200_000, name="cap")
    uncapped = run_sched(trace, ALL_APPS, NARROW)
    total = float(uncapped.final_pack.summary["power_mw"])
    cap = 0.8 * total
    capped = run_sched(trace, ALL_APPS, NARROW, power_cap_mw=cap)
    assert capped.recaps >= 1
    recap = [e for e in capped.events if e["event"] == "recap"][-1]
    assert recap["power_after_mw"] <= recap["power_before_mw"]
    assert float(capped.final_pack.summary["power_mw"]) < total
    for r in capped.final_pack.results:
        assert r.config.schedule == "multi_power_capped"
        assert r.config.power_cap_mw is not None


def test_online_beats_static_on_fragmentation_trace():
    trace = session_trace([("vecadd", 0, None),
                           ("elemmul", 100, 3_000_000),
                           ("ttv", 200, None),
                           ("mttkrp", 4_000_000, None)],
                          period=100_000, name="frag_cmp")
    svc = make_service(FABRIC)
    try:
        online = FabricScheduler(service=svc).run(
            trace, ALL_APPS, configs=configs(trace.arrivals))
        static = evaluate_static(trace, ALL_APPS, service=svc,
                                 configs=configs(trace.arrivals))
    finally:
        svc.stop()
    assert static.policy == "static" and static.repacks == 0
    assert online.rejected < static.rejected or \
        online.objective > static.objective
    # static strips are full-height
    if static.final_pack is not None:
        assert all(r.rows == FABRIC.rows
                   for r in static.final_pack.regions.values())


def test_scheduler_rejects_unknown_apps_and_policies():
    trace = session_trace([("mystery", 0, None)], period=1000)
    with pytest.raises(ValueError, match="mystery"):
        run_sched(trace, {}, NARROW)
    with pytest.raises(ValueError, match="policy"):
        FabricScheduler(service=make_service(NARROW), policy="greedy")


# ---------------------------------------------------------------------------
# the port against the reference: benchmarks/serve_online.py's wide_waves
# ---------------------------------------------------------------------------

import torch  # noqa: E402

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402

FAST_MOVES = 40                  # benchmarks/serve_online.py


def wide_waves(pkg):
    """``benchmarks/serve_online.py``'s ``wide_waves_trace`` in ``pkg``:
    four width-4 tenants, the 2nd and 4th depart, then the width-8 harris
    arrives, admissible online only through the compacting re-pack."""
    sessions = [("a0", 0, 20_000_000), ("a1", 100, 5_000_000),
                ("a2", 200, 20_000_000), ("a3", 300, 6_000_000),
                ("w1", 8_000_000, 20_000_000)]
    bases = {"a0": "vecadd", "a1": "elemmul", "a2": "ttv", "a3": "mttkrp",
             "w1": "harris"}
    apps = {n: dataclasses.replace(pkg.ALL_APPS[b], name=n)
            for n, b in bases.items()}
    return pkg.session_trace(sessions, period=100_000,
                             name="wide_waves"), apps


def serve_online(pkg):
    trace, apps = wide_waves(pkg)
    cfg = pkg.PassConfig.full(place_moves=FAST_MOVES)
    configs = {n: cfg for n in trace.arrivals}
    svc = pkg.CompileService(batch_window_s=0.0).start()
    try:
        online = pkg.FabricScheduler(service=svc).run(trace, apps,
                                                      configs=configs)
        static = pkg.evaluate_static(trace, apps, service=svc,
                                     configs=configs)
    finally:
        svc.stop()
    return [(json.dumps(o.events, sort_keys=True),
             json.dumps(o.epochs, sort_keys=True),
             json.dumps(o.summary(), sort_keys=True), o.objective)
            for o in (online, static)]


def test_wide_waves_equals_reference():
    got = serve_online(port)
    assert got == serve_online(ref)
    online, static = (json.loads(s) for _, _, s, _ in got)
    assert online["repacks"] >= 1
    assert (online["objective"] > static["objective"]
            or online["rejected"] < static["rejected"])


# ---------------------------------------------------------------------------
# the torch engines under the scheduler, on the CPU
# ---------------------------------------------------------------------------

TORCH = PassConfig.full(place_moves=20, pnr_backend="torch",
                        sta_backend="torch")


def test_torch_engine_readmission_byte_identical_on_cpu():
    trace = session_trace([("vecadd", 0, 10_000_000),
                           ("elemmul", 100, None),
                           ("ttv", 5_000_000, 30_000_000)],
                          period=100_000, name="readmit")
    svc = CompileService(fabric=NARROW, batch_window_s=0.0,
                         device="cpu").start()
    try:
        sched = AuditScheduler(service=svc, allow_evict=False)
        out = sched.run(trace, ALL_APPS,
                        configs={n: TORCH for n in trace.arrivals})
    finally:
        svc.stop()
    assert out.rejected == 1 and out.readmitted == 1
    region, served = sched.seated["ttv"][-1]
    assert "region_fence_check" in served.pass_stats["pipeline"]
    fresh = CascadeCompiler(fabric=NARROW, cache=CompileCache(),
                            stage_cache=CompileCache(), device="cpu")
    direct = fresh.compile(ALL_APPS["ttv"], resident_config(TORCH, region))
    assert served.design.placement == direct.design.placement
    assert (json.dumps(served.summary(), sort_keys=True)
            == json.dumps(direct.summary(), sort_keys=True))


def test_torch_engine_scheduler_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("holds the behaviour without CUDA")
    trace = session_trace([("vecadd", 0, None)], period=100_000)
    with pytest.raises(RuntimeError, match="CUDA"):
        FabricScheduler(fabric=NARROW).run(
            trace, ALL_APPS, configs={"vecadd": TORCH})
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_static(trace, ALL_APPS, fabric=NARROW,
                        configs={"vecadd": TORCH})
    out = FabricScheduler(fabric=NARROW, device="cpu").run(
        trace, ALL_APPS, configs={"vecadd": TORCH})
    assert out.admitted == 1
