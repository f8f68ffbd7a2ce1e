"""The port's compile caches against the JAX package's, on the CPU.

Replays the reference's cache, key and disk-tier cases (``tests/
test_passes.py``, ``tests/test_pnr_perf.py``) against
``repro_torch.core``: every ``CompileResult`` metric of every dense app
equals the reference's serial compile with the cache cold and warm, the
keys cover every config field, and the port's own rule holds — the
compiler's device type keys a result of the torch placer (and every stage
artifact from ``placed`` on), so a placement made on the CPU is never
served to a compiler on the card; host-backend keys stay device-free.
"""

import json
import os
import time
from dataclasses import fields as dc_fields, replace
from pathlib import Path

import pytest

from repro.core import ALL_APPS as REF_APPS  # noqa: E402
from repro.core import CascadeCompiler as RefCompiler  # noqa: E402
from repro.core import CompileCache as RefCompileCache  # noqa: E402
from repro.core import PassConfig as RefPassConfig  # noqa: E402
from repro.core.cache import app_fingerprint as ref_app_fingerprint  # noqa: E402
from repro.core.cache import code_fingerprint as ref_code_fingerprint  # noqa: E402
from repro_torch.core import (ALL_APPS, DENSE_APPS,  # noqa: E402
                              CascadeCompiler, CompileCache, DiskCache,
                              ExploreSpec, PassConfig, app_fingerprint,
                              cache_dir, code_fingerprint, compile_key,
                              dfg_fingerprint, stage_key, worker_count)
from repro_torch.core.cache import DISK_SCHEMA_VERSION  # noqa: E402
from repro_torch.core.netlist import design_digest  # noqa: E402
from repro_torch.core.passes import DEFAULT_SCHEDULE  # noqa: E402

MOVES = 20
CORE = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "core"


def metrics(r) -> tuple:
    """Every metric a CompileResult reports, and the design's digest."""
    return (json.dumps(r.summary()), r.sta.critical_path_ns,
            r.sta.max_freq_mhz, r.power.power_mw, r.power.energy_j,
            r.power.edp_js, r.schedule.total_cycles,
            r.design.physical_register_count(), r.design.unroll_copies,
            r.pass_stats["pipeline"], design_digest(r.design))


@pytest.fixture(scope="module")
def ref_dense():
    """The reference's serial compile of every dense app, once."""
    c = RefCompiler(cache=RefCompileCache(), stage_cache=RefCompileCache())
    return {a: c.compile(REF_APPS[a], RefPassConfig.full(place_moves=MOVES),
                         use_cache=False)
            for a in sorted(DENSE_APPS)}


@pytest.mark.parametrize("app", sorted(DENSE_APPS))
def test_compile_cold_and_warm_equals_reference(app, ref_dense):
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    cfg = PassConfig.full(place_moves=MOVES)
    cold = c.compile(ALL_APPS[app], cfg)
    warm = c.compile(ALL_APPS[app], cfg)
    assert not cold.cache_hit and warm.cache_hit
    assert metrics(cold) == metrics(warm) == metrics(ref_dense[app])


def test_cache_hit_returns_identical_summary():
    c = CascadeCompiler(cache=CompileCache())   # isolated: exact stat asserts
    app = ALL_APPS["unsharp"]
    cfg = PassConfig.full(place_moves=MOVES)
    r1 = c.compile(app, cfg)
    r2 = c.compile(app, cfg)
    assert not r1.cache_hit and r2.cache_hit
    assert json.dumps(r1.summary()) == json.dumps(r2.summary())
    s = c.cache.stats()
    assert s["hits"] == 1 and s["misses"] == 1


def test_cache_keys_separate_configs_and_flags():
    c = CascadeCompiler()
    app = ALL_APPS["unsharp"]
    base = compile_key(app, PassConfig.full(), c.fabric, c.timing, c.energy)
    assert base == compile_key(app, PassConfig.full(), c.fabric, c.timing,
                               c.energy)
    assert base != compile_key(app, PassConfig.full(rf_threshold=5),
                               c.fabric, c.timing, c.energy)
    assert base != compile_key(app, PassConfig.unpipelined(), c.fabric,
                               c.timing, c.energy)
    assert base != compile_key(app, PassConfig.full(), c.fabric, c.timing,
                               c.energy, verify=True)
    assert base != compile_key(app, PassConfig.full(), c.fabric, c.timing,
                               c.energy, unroll=2)
    assert base != compile_key(ALL_APPS["gaussian"], PassConfig.full(),
                               c.fabric, c.timing, c.energy)


def _perturb(value):
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value + 1
    if isinstance(value, str):
        return value + "_x"
    if isinstance(value, tuple):
        return value + ("x",)
    return "__perturbed__"              # None / anything else


def test_compile_key_covers_every_config_field():
    """Two configs differing only in one field never collide; a field
    someone forgets to hash fails here."""
    c = CascadeCompiler()
    app = ALL_APPS["unsharp"]
    base_cfg = PassConfig()
    base = compile_key(app, base_cfg, c.fabric, c.timing, c.energy)
    keys = {None: base}
    for f in dc_fields(PassConfig):
        cfg = replace(base_cfg, **{f.name: _perturb(getattr(base_cfg,
                                                            f.name))})
        keys[f.name] = compile_key(app, cfg, c.fabric, c.timing, c.energy)
        assert keys[f.name] != base, \
            f"PassConfig.{f.name} does not affect the compile key"
    assert len(set(keys.values())) == len(keys)
    for cfg in (replace(base_cfg, power_cap_mw=300.0),
                replace(base_cfg, schedule="power_capped"),
                replace(base_cfg, explore=ExploreSpec()),
                replace(base_cfg, sta_backend="numpy")):
        assert compile_key(app, cfg, c.fabric, c.timing, c.energy) != base


def test_compile_key_covers_every_explore_spec_subfield():
    c = CascadeCompiler()
    app = ALL_APPS["unsharp"]
    base_spec = ExploreSpec()
    base_cfg = PassConfig.frontier(base_spec)
    base = compile_key(app, base_cfg, c.fabric, c.timing, c.energy)
    keys = {None: base}
    for f in dc_fields(ExploreSpec):
        spec = replace(base_spec,
                       **{f.name: _perturb(getattr(base_spec, f.name))})
        keys[f.name] = compile_key(app, replace(base_cfg, explore=spec),
                                   c.fabric, c.timing, c.energy)
        assert keys[f.name] != base, \
            f"ExploreSpec.{f.name} does not affect the compile key"
    assert len(set(keys.values())) == len(keys)
    k1 = compile_key(app, replace(base_cfg, explore=ExploreSpec(
        register_budgets=(4, 8))), c.fabric, c.timing, c.energy)
    k2 = compile_key(app, replace(base_cfg, explore=ExploreSpec(
        register_budgets=(8, 4))), c.fabric, c.timing, c.energy)
    assert k1 != k2


def test_app_fingerprint_is_content_hash():
    """Content hashes, equal to the reference's for every app."""
    assert app_fingerprint(ALL_APPS["unsharp"]) == \
        app_fingerprint(ALL_APPS["unsharp"])
    assert app_fingerprint(ALL_APPS["unsharp"]) != \
        app_fingerprint(ALL_APPS["camera"])
    g1, g2 = ALL_APPS["ttv"].build(1), ALL_APPS["ttv"].build(1)
    assert dfg_fingerprint(g1) == dfg_fingerprint(g2)
    for name in sorted(ALL_APPS):
        assert app_fingerprint(ALL_APPS[name]) == \
            ref_app_fingerprint(REF_APPS[name]), name


def test_cache_entries_isolated_from_caller_mutation():
    c = CascadeCompiler(cache=CompileCache())
    app = ALL_APPS["unsharp"]
    cfg = PassConfig.full(place_moves=MOVES)
    r1 = c.compile(app, cfg)
    r1.pass_stats["poison"] = True            # mutate the miss result
    r1.design.unroll_copies = 999
    r2 = c.compile(app, cfg)
    assert r2.cache_hit
    assert "poison" not in r2.pass_stats and r2.design.unroll_copies != 999
    r2.design.placement.clear()               # mutate a hit result
    r3 = c.compile(app, cfg)
    assert r3.design.placement


def test_cache_bypass_and_lru_eviction():
    c = CascadeCompiler(cache=CompileCache(maxsize=1))
    app = ALL_APPS["unsharp"]
    r1 = c.compile(app, PassConfig.full(place_moves=MOVES), use_cache=False)
    assert len(c.cache) == 0                 # bypass never stores
    c.compile(app, PassConfig.full(place_moves=MOVES))
    c.compile(app, PassConfig.unpipelined(place_moves=MOVES))
    assert len(c.cache) == 1                 # first entry evicted
    assert c.cache.stats()["evictions"] == 1
    assert not r1.cache_hit


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------


def test_keys_carry_the_device_only_for_the_torch_placer():
    """The torch placer's results key on the device type (compile keys,
    and stage keys from ``placed`` on); the ``mapped`` prefix and every
    host-backend key are the same on the CPU and on the card."""
    c = CascadeCompiler()
    f, t, e = c.fabric, c.timing, c.energy
    app = ALL_APPS["harris"]
    torch_cfg = PassConfig.full(pnr_backend="torch", sta_backend="torch")
    for cfg, differs in ((torch_cfg, True),
                         (PassConfig.full(sta_backend="torch"), False),
                         (PassConfig.full(), False)):
        keys = {dev: compile_key(app, cfg, f, t, e, device=dev)
                for dev in (None, "cuda", "cuda:0", "cpu")}
        assert keys[None] == keys["cuda"] == keys["cuda:0"]
        assert (keys["cpu"] != keys["cuda"]) == differs
        for stage, end in (("mapped", 4), ("placed", 5), ("routed", 6)):
            sk = {dev: stage_key(app, cfg, f, t, e, stage=stage,
                                 prefix=DEFAULT_SCHEDULE[:end], device=dev)
                  for dev in ("cuda", "cpu")}
            assert (sk["cpu"] != sk["cuda"]) == (differs
                                                 and stage != "mapped")
    cpu, card = CascadeCompiler(device="cpu"), CascadeCompiler()
    assert cpu.stage_key_for(app, torch_cfg, "routed") != \
        card.stage_key_for(app, torch_cfg, "routed")
    assert cpu.stage_key_for(app, torch_cfg, "mapped") == \
        card.stage_key_for(app, torch_cfg, "mapped")


def test_a_cpu_placement_is_never_served_to_a_compiler_on_the_card(
        monkeypatch):
    """A torch-engine result compiled on the CPU misses for a compiler on
    the card sharing both caches (so it runs, and without CUDA raises),
    while a host-backend result is served to it."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cache, stages = CompileCache(), CompileCache()
    cpu = CascadeCompiler(cache=cache, stage_cache=stages, device="cpu")
    card = CascadeCompiler(cache=cache, stage_cache=stages)
    app = ALL_APPS["gaussian"]
    torch_cfg = PassConfig.full(place_moves=4, pnr_backend="torch",
                                sta_backend="torch")
    host_cfg = PassConfig.full(place_moves=4)
    r = cpu.compile(app, torch_cfg)
    assert not r.cache_hit and cpu.compile(app, torch_cfg).cache_hit
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        card.compile(app, torch_cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        card.compile_to_stage(app, torch_cfg, stage="routed")
    cpu.compile(app, host_cfg)
    hit = card.compile(app, host_cfg)
    assert hit.cache_hit


# ---------------------------------------------------------------------------
# disk tier
# ---------------------------------------------------------------------------


def test_disk_cache_round_trip_across_cache_instances(tmp_path, ref_dense):
    """A fresh memory cache (a new process, in effect) is served from disk,
    and the result still equals the reference's."""
    disk = DiskCache(root=tmp_path)
    c1 = CascadeCompiler(cache=CompileCache(disk=disk))
    app, cfg = ALL_APPS["harris"], PassConfig.full(place_moves=MOVES)
    r1 = c1.compile(app, cfg)
    assert not r1.cache_hit and disk.stats()["puts"] == 1
    c2 = CascadeCompiler(cache=CompileCache(disk=DiskCache(root=tmp_path)))
    r2 = c2.compile(app, cfg)
    assert r2.cache_hit
    assert metrics(r2) == metrics(r1) == metrics(ref_dense["harris"])
    assert c2.cache.disk.stats()["hits"] == 1


def test_disk_cache_invalidated_on_schema_version_bump(tmp_path):
    disk = DiskCache(root=tmp_path)
    disk.put("k" * 64, {"payload": 1})
    assert DiskCache(root=tmp_path).get("k" * 64) == {"payload": 1}
    bumped = DiskCache(root=tmp_path, schema=DISK_SCHEMA_VERSION + 1)
    assert bumped.get("k" * 64) is None            # new namespace: cold
    assert bumped.stats()["misses"] == 1


def test_disk_cache_namespace_isolates_code_changes(tmp_path):
    a = DiskCache(root=tmp_path, namespace="aaaa")
    b = DiskCache(root=tmp_path, namespace="bbbb")
    a.put("key1", "from-a")
    assert b.get("key1") is None
    assert a.get("key1") == "from-a"


def test_code_fingerprint_hashes_the_ports_own_sources():
    import hashlib
    h = hashlib.sha256()
    for f in sorted(CORE.glob("*.py")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    assert code_fingerprint() == h.hexdigest() != ref_code_fingerprint()


def test_disk_cache_corrupt_entry_is_a_miss(tmp_path):
    disk = DiskCache(root=tmp_path)
    disk.put("deadbeef", [1, 2, 3])
    path = disk._path("deadbeef")
    path.write_bytes(b"not a pickle")
    assert disk.get("deadbeef") is None
    assert not path.exists()                       # corrupt entry removed


def test_disk_cache_bounded_size_evicts_oldest(tmp_path):
    disk = DiskCache(root=tmp_path, max_bytes=4096)
    for i in range(8):
        disk.put(f"key{i}", os.urandom(400).hex())   # ~900B pickled
        time.sleep(0.01)                             # distinct mtimes
    assert disk.size_bytes() <= 4096
    assert disk.stats()["evictions"] > 0
    assert disk.get("key7") is not None              # newest survives


def test_disk_cache_sweeps_stale_tmp_orphans(tmp_path):
    disk = DiskCache(root=tmp_path, max_bytes=1)    # every put trims
    orphan = disk.dir / "orphan.tmp"
    orphan.write_bytes(b"stranded")
    old = 120.0
    os.utime(orphan, (orphan.stat().st_atime - old,
                      orphan.stat().st_mtime - old))
    fresh = disk.dir / "inflight.tmp"
    fresh.write_bytes(b"writing")
    disk.put("key", "value")
    assert not orphan.exists()
    assert fresh.exists()                           # recent: left alone


def test_disk_cache_unpicklable_value_is_skipped(tmp_path):
    disk = DiskCache(root=tmp_path)
    disk.put("k", lambda: None)
    assert disk.stats()["put_errors"] == 1 and len(disk) == 0


def test_stage_disk_cache_resumes_a_second_compiler(tmp_path):
    """A stage tier on disk: a second compiler with fresh memory tiers
    resumes from the routed artifact and equals a cold compile."""
    def make():
        return CascadeCompiler(
            cache=CompileCache(),
            stage_cache=CompileCache(disk=DiskCache(root=tmp_path)))
    app = ALL_APPS["unsharp"]
    make().compile(app, PassConfig.full(place_moves=MOVES))
    r = make().compile(app, PassConfig.full(place_moves=MOVES,
                                            post_pnr_budget=8))
    assert r.pass_stats["stage_resume"] == "routed"
    cold = CascadeCompiler(cache=CompileCache()).compile(
        app, PassConfig.full(place_moves=MOVES, post_pnr_budget=8),
        use_cache=False)
    assert metrics(r)[:-2] == metrics(cold)[:-2]
    assert design_digest(r.design) == design_digest(cold.design)


# ---------------------------------------------------------------------------
# env-var config plumbing
# ---------------------------------------------------------------------------


def test_cache_dir_env_override(monkeypatch, tmp_path):
    monkeypatch.setenv("CASCADE_CACHE_DIR", str(tmp_path / "custom"))
    assert cache_dir() == tmp_path / "custom"
    disk = DiskCache()
    assert str(disk.dir).startswith(str(tmp_path / "custom"))
    monkeypatch.delenv("CASCADE_CACHE_DIR")
    assert cache_dir().name == "cascade-repro"


def test_worker_count_env_override(monkeypatch):
    monkeypatch.setenv("CASCADE_WORKERS", "3")
    assert worker_count() == 3
    monkeypatch.setenv("CASCADE_WORKERS", "not-a-number")
    assert worker_count(jobs=2) <= 2               # falls back, job-clamped
    monkeypatch.delenv("CASCADE_WORKERS")
    assert 1 <= worker_count() <= 8


def test_worker_count_env_clamped_to_jobs(monkeypatch):
    monkeypatch.setenv("CASCADE_WORKERS", "8")
    assert worker_count(jobs=2) == 2
    assert worker_count(jobs=1) == 1
    assert worker_count(jobs=16) == 8              # env still caps upward
    assert worker_count() == 8                     # no jobs: env verbatim
    monkeypatch.setenv("CASCADE_WORKERS", "0")
    assert worker_count(jobs=4) == 1               # floor stays at 1


@pytest.mark.parametrize("var,fn,value,want", [
    ("CASCADE_POWER_CAP_MW", "default_power_cap_mw", "250.5", 250.5),
    ("CASCADE_POWER_CAP_MW", "default_power_cap_mw", "250mW", None),
    ("CASCADE_POWER_CAP_MW", "default_power_cap_mw", "", None),
    ("CASCADE_DISK_CACHE", "disk_cache_enabled", "1", True),
    ("CASCADE_DISK_CACHE", "disk_cache_enabled", "off", False)])
def test_driver_env_knobs(monkeypatch, var, fn, value, want):
    from repro_torch.core import config
    monkeypatch.setenv(var, value)
    if value == "250mW":
        with pytest.warns(UserWarning, match=var):
            assert getattr(config, fn)() == want
    else:
        assert getattr(config, fn)() == want
