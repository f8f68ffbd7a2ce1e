"""The reference's randomized long-trace soak of the online fabric
scheduler (``tests/test_sched.py``), replayed against ``repro_torch.core``
on the CPU: region invariants after every event, every kind of transition
exercised, and an evicted-then-readmitted app's compile byte-identical to
a fresh one. A file of its own, so that a distributed run gives it a
worker of its own.
"""

import dataclasses
import json
import random

from repro_torch.core import (ALL_APPS, CascadeCompiler, CompileCache,
                              resident_config, session_trace)

from test_torch_sched import CFG, FABRIC, AuditScheduler, configs, make_service

# ---------------------------------------------------------------------------
# randomized long-trace soak
# ---------------------------------------------------------------------------


def soak_trace(n_sessions: int, seed: int):
    """Overlapping random sessions over aliased sparse apps: the
    fragmentation-heavy arrival/departure churn of a shared fabric."""
    rng = random.Random(seed)
    bases = ["vecadd", "elemmul", "ttv", "mttkrp"]
    apps, sessions, t = {}, [], 0
    for i in range(n_sessions):
        base = rng.choice(bases)
        name = f"{base}_s{i}"
        apps[name] = dataclasses.replace(ALL_APPS[base], name=name)
        t += rng.randint(100_000, 400_000)
        sessions.append((name, t, t + rng.randint(300_000, 1_200_000)))
    return session_trace(sessions, period=100_000,
                         name=f"soak{seed}"), apps


def test_soak_long_trace_invariants_and_byte_identity():
    trace, apps = soak_trace(n_sessions=120, seed=7)
    svc = make_service(FABRIC)
    try:
        sched = AuditScheduler(service=svc)
        out = sched.run(trace, apps, configs=configs(trace.arrivals))
    finally:
        svc.stop()
    # hundreds of events, with every kind of transition exercised
    assert len(out.events) >= 240
    assert out.admitted + out.readmitted >= 100
    assert out.departed >= 60
    assert out.evicted > 0 and out.readmitted > 0 and out.repacks > 0
    assert out.objective > 0
    # an evicted-then-readmitted app compiles byte-identically fresh
    evicted_at = {}
    target = None
    for e in out.events:
        if e["event"] == "evict":
            evicted_at[e["app"]] = e["cycle"]
        elif e["event"] == "readmit" and e["app"] in evicted_at:
            target = e["app"]
    assert target is not None, "soak produced no evict->readmit app"
    region, served = sched.seated[target][-1]
    fresh = CascadeCompiler(fabric=FABRIC, cache=CompileCache(),
                            stage_cache=CompileCache())
    direct = fresh.compile(apps[target], resident_config(CFG, region))
    assert served.design.placement == direct.design.placement
    assert (json.dumps(served.summary(), sort_keys=True)
            == json.dumps(direct.summary(), sort_keys=True))
    # the service's shared tiers actually carried the run
    stats = svc.stats()
    assert stats["completed"] >= 100 and stats["failed"] == 0
