"""The port's compile service (``repro_torch.core.service``), on the CPU.

The reference's cases (``tests/test_service.py``) replayed against
``repro_torch.core``: queue batching, in-flight dedup, cancellation and
timeout release, error isolation and the warm mapped-artifact pool. Then
what only the port has: a request for the torch engines on the CPU and one
for the card never merge, and without CUDA a card request raises.
"""

import json
import threading

import pytest

from repro_torch.core import (ALL_APPS, AppSpec, CascadeCompiler, CompileCache,
                        CompileService, PassConfig, ServiceCancelled,
                        ServiceClosed, ServiceTimeout)

CFG = PassConfig.full(place_moves=20)


def make_service(**kw):
    kw.setdefault("batch_window_s", 0.02)
    return CompileService(**kw)


def _boom_builder(copy, g, width):
    raise RuntimeError("boom: intentionally unbuildable app")


BOOM = AppSpec("boom", _boom_builder, sparse=True, work_tokens=16)


# ---------------------------------------------------------------------------
# dedup + batching (deterministic: submit while stopped, then start)
# ---------------------------------------------------------------------------


def test_duplicate_inflight_requests_dedup_to_one_compile():
    svc = make_service()
    app = ALL_APPS["vecadd"]
    tickets = [svc.submit(app, CFG) for _ in range(4)]
    assert tickets[0].key is not None
    assert all(t.key == tickets[0].key for t in tickets)
    svc.start()
    results = [t.result(timeout=300) for t in tickets]
    stats = svc.stats()
    svc.stop()
    assert stats["submitted"] == 4
    assert stats["dedup_inflight"] == 3            # one job, four tickets
    assert stats["completed"] == 1
    # every ticket owns a private object with identical content
    assert len({id(r) for r in results}) == 4
    blobs = {json.dumps(r.summary(), sort_keys=True) for r in results}
    assert len(blobs) == 1


def test_concurrent_submitters_drain_deterministically():
    apps = [ALL_APPS["vecadd"], ALL_APPS["elemmul"], ALL_APPS["vecadd"]]
    with make_service() as svc:
        out = [None] * len(apps)

        def worker(i):
            out[i] = svc.submit(apps[i], CFG).result(timeout=300)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(apps))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = svc.stats()
    assert [r.app.name for r in out] == ["vecadd", "elemmul", "vecadd"]
    # the two vecadd results are content-identical regardless of whether
    # they coalesced in flight or the second hit the result cache
    assert (json.dumps(out[0].summary(), sort_keys=True)
            == json.dumps(out[2].summary(), sort_keys=True))
    assert stats["completed"] + stats["dedup_inflight"] >= 2


def test_batch_window_coalesces_distinct_requests():
    svc = make_service(max_batch=8)
    t1 = svc.submit(ALL_APPS["vecadd"], CFG)
    t2 = svc.submit(ALL_APPS["elemmul"], CFG)
    svc.start()
    r1, r2 = t1.result(timeout=300), t2.result(timeout=300)
    stats = svc.stats()
    svc.stop()
    assert (r1.app.name, r2.app.name) == ("vecadd", "elemmul")
    assert stats["batches"] == 1                   # one dispatch for both
    assert stats["largest_batch"] == 2


def test_service_result_matches_direct_compiler():
    compiler = CascadeCompiler(cache=CompileCache(),
                               stage_cache=CompileCache())
    direct = compiler.compile(ALL_APPS["vecadd"], CFG)
    with make_service() as svc:
        served = svc.compile(ALL_APPS["vecadd"], CFG, timeout=300)
    assert (json.dumps(served.summary(), sort_keys=True)
            == json.dumps(direct.summary(), sort_keys=True))
    assert served.design.placement == direct.design.placement


# ---------------------------------------------------------------------------
# cancellation / timeout / shutdown release the caller's resources
# ---------------------------------------------------------------------------


def test_cancel_before_dispatch_skips_compile_and_fires_release_once():
    svc = make_service()
    released = []
    ticket = svc.submit(ALL_APPS["vecadd"], CFG,
                        on_release=lambda: released.append(1))
    assert ticket.cancel()
    assert released == [1]
    assert not ticket.cancel()                     # idempotent, no double fire
    assert released == [1]
    with pytest.raises(ServiceCancelled):
        ticket.result(timeout=1)
    svc.start()
    svc.stop()
    stats = svc.stats()
    assert stats["skipped_jobs"] == 1              # the compile never ran
    assert stats["completed"] == 0


def test_timeout_cancels_ticket_and_fires_release():
    svc = make_service()                           # never started: no result
    released = []
    ticket = svc.submit(ALL_APPS["vecadd"], CFG,
                        on_release=lambda: released.append(1))
    with pytest.raises(ServiceTimeout):
        ticket.result(timeout=0.05)
    assert ticket.cancelled and released == [1]
    svc.start()
    svc.stop()
    assert released == [1]                         # still exactly once


def test_stop_fails_pending_jobs_with_service_closed():
    svc = make_service()
    released = []
    ticket = svc.submit(ALL_APPS["vecadd"], CFG,
                        on_release=lambda: released.append(1))
    svc.stop()                                     # never started -> no drain
    with pytest.raises(ServiceClosed):
        ticket.result(timeout=1)
    assert released == [1]
    with pytest.raises(ServiceClosed):
        svc.submit(ALL_APPS["vecadd"], CFG)


def test_failing_job_is_isolated_and_batchmates_survive():
    svc = make_service()
    released = []
    bad = svc.submit(BOOM, CFG, on_release=lambda: released.append("bad"))
    good = svc.submit(ALL_APPS["vecadd"], CFG,
                      on_release=lambda: released.append("good"))
    svc.start()
    result = good.result(timeout=300)
    with pytest.raises(RuntimeError, match="boom"):
        bad.result(timeout=300)
    stats = svc.stats()
    svc.stop()
    assert result.app.name == "vecadd"
    assert stats["failed"] == 1 and stats["completed"] == 1
    assert released == ["bad"]                     # success never fires


# ---------------------------------------------------------------------------
# warm mapped-artifact pool
# ---------------------------------------------------------------------------


def test_warm_pool_pins_mapped_artifacts():
    with make_service() as svc:
        key = svc.warm_mapped(ALL_APPS["vecadd"], CFG)
        assert key is not None and key in svc.pool
        assert svc.warm_mapped(ALL_APPS["vecadd"], CFG) == key  # idempotent
        nl = svc.mapped_netlist(ALL_APPS["vecadd"], CFG)
        direct = svc.compiler.mapped_netlist(ALL_APPS["vecadd"], CFG)
        assert sorted(nl.nodes) == sorted(direct.nodes)
        pool = svc.pool.stats()
    assert pool["entries"] >= 1 and pool["hits"] >= 1


def test_service_constructor_validation():
    with pytest.raises(ValueError):
        CompileService(max_batch=0)
    with pytest.raises(ValueError):
        CompileService(batch_window_s=-1)


# ---------------------------------------------------------------------------
# the port against the reference, and the port's device rule
# ---------------------------------------------------------------------------

import torch  # noqa: E402

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
from repro_torch.core import compile_key  # noqa: E402
from repro_torch.core.netlist import design_digest  # noqa: E402

COUNTERS = ("submitted", "completed", "failed", "dedup_inflight",
            "cancelled_tickets", "skipped_jobs", "batches", "batched_jobs",
            "largest_batch")


def served(pkg):
    """One deterministic batch through ``pkg``'s service: submitted while
    stopped (a duplicate included), then started."""
    cfg = pkg.PassConfig.full(place_moves=20)
    svc = pkg.CompileService(batch_window_s=0.02, max_batch=8)
    names = ("vecadd", "elemmul", "unsharp", "vecadd")
    tickets = [svc.submit(pkg.ALL_APPS[n], cfg) for n in names]
    svc.warm_mapped(pkg.ALL_APPS["ttv"], cfg)
    svc.start()
    results = [t.result(timeout=300) for t in tickets]
    nl = svc.mapped_netlist(pkg.ALL_APPS["ttv"], cfg)
    stats = svc.stats()
    svc.stop()
    return ([(r.app.name, json.dumps(r.summary(), sort_keys=True),
              design_digest(r.design)) for r in results],
            {k: stats[k] for k in COUNTERS}, stats["pool"],
            sorted(nl.nodes), len(nl.branches))


def test_service_results_equal_reference():
    assert served(port) == served(ref)


TORCH = PassConfig.full(place_moves=20, pnr_backend="torch",
                        sta_backend="torch")


def test_cpu_and_card_requests_never_merge():
    """A torch-placer request on the CPU and one for the card have two
    dedup keys (the device type enters ``compile_key``); a host request
    has one key on either device."""
    app = ALL_APPS["vecadd"]
    cpu = make_service(device="cpu")
    card = make_service(device="cuda")
    c = cpu.compiler
    keys = {d: compile_key(app, TORCH, c.fabric, c.timing, c.energy,
                           device=d) for d in ("cpu", "cuda")}
    assert keys["cpu"] != keys["cuda"]
    t_cpu = [cpu.submit(app, TORCH) for _ in range(2)]
    assert [t.key for t in t_cpu] == [keys["cpu"]] * 2
    assert cpu.stats()["dedup_inflight"] == 1
    if torch.cuda.is_available():
        assert card.submit(app, TORCH).key == keys["cuda"]
    host = [s.submit(app, CFG).key for s in (cpu, card)]
    assert host[0] == host[1] == compile_key(app, CFG, c.fabric, c.timing,
                                             c.energy)
    cpu.start()
    results = [t.result(timeout=300) for t in t_cpu]
    cpu.stop()
    card.stop(drain=False)
    direct = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache(),
                             device="cpu").compile(app, TORCH)
    assert cpu.stats()["completed"] == 2        # the torch job and the host
    for r in results:
        assert design_digest(r.design) == design_digest(direct.design)
        assert json.dumps(r.summary()) == json.dumps(direct.summary())


def test_card_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("holds the behaviour without CUDA")
    with make_service() as svc:
        with pytest.raises(RuntimeError, match="CUDA"):
            svc.submit(ALL_APPS["vecadd"], TORCH)
        with pytest.raises(RuntimeError, match="CUDA"):
            svc.submit(ALL_APPS["vecadd"],
                       PassConfig.full(place_moves=20, sta_backend="torch"))
        # the host engines need no card
        assert svc.compile(ALL_APPS["vecadd"], CFG, timeout=300).sta
        assert svc.stats()["submitted"] == 1
