"""The port's ``compile_batch`` against the JAX package's serial compiles,
on the CPU.

Replays the reference's batch cases (``tests/test_passes.py``: batch equals
serial, dedup, repeats from the cache; ``tests/test_pnr_perf.py``: the
process backend, the auto backend, unpicklable jobs, independent objects,
``CASCADE_WORKERS``) against ``repro_torch.core``. Expected results come
from the reference's serial compiles of the same inputs, computed once per
module. Process-backend cases use 2-job batches; their workers fork, or
spawn where this process has jax loaded (a fresh interpreter each, a few
seconds).
"""

import json
import pickle
import sys
from dataclasses import replace

import pytest
import torch

from repro.core import ALL_APPS as REF_APPS  # noqa: E402
from repro.core import CascadeCompiler as RefCompiler  # noqa: E402
from repro.core import CompileCache as RefCompileCache  # noqa: E402
from repro.core import PassConfig as RefPassConfig  # noqa: E402
from repro_torch.core import (ALL_APPS, DENSE_APPS,  # noqa: E402
                              BatchCompileError, CascadeCompiler,
                              CompileCache, PassConfig, compile_batch)
from repro_torch.core import compiler as compiler_mod  # noqa: E402
from repro_torch.core.netlist import design_digest  # noqa: E402

MOVES = 20


def _summaries(results):
    return [json.dumps(r.summary()) for r in results]


def _digests(results):
    return [design_digest(r.design) for r in results]


@pytest.fixture(scope="module")
def ref_serial():
    """The reference's serial compiles, by (app, seed), once."""
    c = RefCompiler(cache=RefCompileCache(), stage_cache=RefCompileCache())
    names = sorted(DENSE_APPS) + ["vecadd", "ttv"]
    out = {(a, 0): c.compile(REF_APPS[a],
                             RefPassConfig.full(place_moves=MOVES),
                             use_cache=False) for a in names}
    for s in (1, 2):
        out[("vecadd", s)] = c.compile(
            REF_APPS["vecadd"], RefPassConfig.full(place_moves=MOVES, seed=s),
            use_cache=False)
    return out


def test_compile_batch_matches_serial_exactly(ref_serial):
    jobs = [(ALL_APPS[a], PassConfig.full(place_moves=MOVES))
            for a in sorted(DENSE_APPS)]
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache())
    batch = c.compile_batch(jobs, backend="thread")
    want = [ref_serial[(a, 0)] for a in sorted(DENSE_APPS)]
    assert _summaries(batch) == _summaries(want)
    assert _digests(batch) == _digests(want)
    warm = c.compile_batch(jobs, backend="thread")
    assert all(r.cache_hit for r in warm)
    assert _summaries(warm) == _summaries(want)
    assert _digests(warm) == _digests(want)


def test_compile_batch_dedups_and_serves_repeats_from_cache(ref_serial):
    c = CascadeCompiler(cache=CompileCache())   # isolated: exact stat asserts
    app = ALL_APPS["unsharp"]
    cfg = PassConfig.full(place_moves=MOVES)
    first = c.compile_batch([(app, cfg), (app, cfg), (app, cfg)])
    assert c.cache.stats()["misses"] == 1    # identical jobs compiled once
    assert set(_summaries(first)) == set(_summaries(
        [ref_serial[("unsharp", 0)]]))
    again = c.compile_batch([(app, cfg)])
    assert again[0].cache_hit
    assert json.dumps(again[0].summary()) == json.dumps(first[0].summary())


def test_compile_batch_sparse_and_empty(ref_serial):
    c = CascadeCompiler(cache=CompileCache())
    assert c.compile_batch([]) == []
    (r,) = c.compile_batch([(ALL_APPS["vecadd"],
                             PassConfig.full(place_moves=MOVES))])
    assert _summaries([r]) == _summaries([ref_serial[("vecadd", 0)]])


def test_module_level_compile_batch(ref_serial):
    c = CascadeCompiler(cache=CompileCache())
    (r,) = compile_batch([(ALL_APPS["ttv"], PassConfig.full(
        place_moves=MOVES))], compiler=c, backend="thread")
    assert _summaries([r]) == _summaries([ref_serial[("ttv", 0)]])


# ---------------------------------------------------------------------------
# the process backend
# ---------------------------------------------------------------------------


def test_process_backend_byte_identical_to_serial(ref_serial):
    jobs = [(ALL_APPS[a], PassConfig.full(place_moves=MOVES))
            for a in ("unsharp", "vecadd")]
    c = CascadeCompiler(cache=CompileCache())
    batch = c.compile_batch(jobs, backend="process", max_workers=2)
    want = [ref_serial[(a, 0)] for a in ("unsharp", "vecadd")]
    assert _summaries(batch) == _summaries(want)
    assert _digests(batch) == _digests(want)
    assert c.last_batch["backend"] == "process"
    assert c.last_batch["start_method"] == \
        compiler_mod._process_context().get_start_method()
    assert c.last_batch["compiled"] == 2 and c.last_batch["cache_hits"] == 0
    # and the parent merged the worker results into its cache
    again = c.compile_batch(jobs, backend="process")
    assert all(r.cache_hit for r in again)
    assert c.last_batch["compiled"] == 0 and c.last_batch["cache_hits"] == 2


@pytest.mark.parametrize("pair", [("gaussian", "unsharp"),
                                  ("camera", "harris"), ("resnet", "gaussian")])
def test_auto_backend_equals_reference_on_every_dense_app(pair, ref_serial):
    """2-job batches over the dense apps: the auto backend takes the
    process workers and every result equals the reference's serial
    compile."""
    c = CascadeCompiler(cache=CompileCache())
    out = c.compile_batch([(ALL_APPS[a], PassConfig.full(place_moves=MOVES))
                           for a in pair])
    assert c.last_batch["backend"] == "process"
    want = [ref_serial[(a, 0)] for a in pair]
    assert _summaries(out) == _summaries(want)
    assert _digests(out) == _digests(want)


def test_auto_backend_picks_process_only_for_multi_miss_batches(ref_serial):
    c = CascadeCompiler(cache=CompileCache())
    app = ALL_APPS["vecadd"]
    c.compile_batch([(app, PassConfig.full(place_moves=MOVES))])
    assert c.last_batch["backend"] == "thread"     # single miss: no fork
    jobs = [(app, PassConfig.full(place_moves=MOVES, seed=s)) for s in (1, 2)]
    out = c.compile_batch(jobs)
    assert c.last_batch["backend"] == "process"
    assert _summaries(out) == _summaries([ref_serial[("vecadd", s)]
                                          for s in (1, 2)])
    c.compile_batch(jobs)                          # warm: all hits
    assert c.last_batch["cache_hits"] == 2 and c.last_batch["compiled"] == 0


def test_process_backend_unpicklable_job_falls_back_inline():
    app = ALL_APPS["vecadd"]
    orig = ALL_APPS["elemmul"].builder
    weird = replace(ALL_APPS["elemmul"],
                    builder=lambda c, g, w: orig(c, g, w),
                    name="elemmul_closure")
    with pytest.raises(Exception):
        pickle.dumps(weird)
    c = CascadeCompiler(cache=CompileCache())
    out = c.compile_batch([(app, PassConfig.full(place_moves=MOVES)),
                           (weird, PassConfig.full(place_moves=MOVES))],
                          backend="process", max_workers=2)
    assert [r.summary()["app"] for r in out] == ["vecadd", "elemmul_closure"]
    assert c.last_batch["inline_fallback"] == 1


def test_batch_results_are_independent_objects_even_on_dedup():
    c = CascadeCompiler(cache=CompileCache())
    app = ALL_APPS["vecadd"]
    cfg = PassConfig.full(place_moves=MOVES)
    out = c.compile_batch([(app, cfg), (app, cfg), (app, cfg)])
    assert c.cache.stats()["misses"] == 1          # deduped to one compile
    assert len({id(r) for r in out}) == 3
    assert len({id(r.design) for r in out}) == 3
    baseline = json.dumps(out[1].summary())
    out[0].design.placement.clear()                # vandalize result 0
    out[0].pass_stats["poison"] = True
    out[2].design.unroll_copies = 999
    assert json.dumps(out[1].summary()) == baseline
    assert out[1].design.placement and "poison" not in out[1].pass_stats
    fresh = c.compile_batch([(app, cfg)])[0]       # cache entry unharmed
    assert fresh.design.placement and "poison" not in fresh.pass_stats


def test_invalid_backend_rejected():
    with pytest.raises(ValueError):
        CascadeCompiler(cache=CompileCache()).compile_batch(
            [(ALL_APPS["vecadd"], None)], backend="mpi")
    with pytest.raises(ValueError):
        CascadeCompiler(batch_backend="mpi")


def test_compile_batch_honours_cascade_workers(monkeypatch, ref_serial):
    monkeypatch.setenv("CASCADE_WORKERS", "2")
    c = CascadeCompiler(cache=CompileCache())
    cfg = PassConfig.full(place_moves=MOVES)
    out = c.compile_batch([(ALL_APPS["vecadd"], cfg),
                           (ALL_APPS["ttv"], cfg)])
    assert c.last_batch["workers"] == 2
    assert _summaries(out) == _summaries([ref_serial[("vecadd", 0)],
                                          ref_serial[("ttv", 0)]])
    c2 = CascadeCompiler(cache=CompileCache())
    c2.compile_batch([(ALL_APPS["vecadd"], cfg)])
    assert c2.last_batch["workers"] == 1


@pytest.mark.parametrize("cuda,jax,platform,runs_torch,want", [
    (False, False, "linux", False, "fork"),
    (True, False, "linux", False, "spawn"),
    (False, True, "linux", False, "spawn"),
    (False, False, "darwin", False, "spawn"),
    (False, False, "linux", True, "spawn")])
def test_process_context_forks_only_without_cuda_or_jax(
        monkeypatch, cuda, jax, platform, runs_torch, want):
    """Fork only on Linux, while CUDA is not initialised and no jax is
    loaded, and only for work that runs no torch op; else spawn (a forked
    child cannot use CUDA once the parent has initialised it, and hangs in
    torch's OpenMP pool once the parent has used it)."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda)
    monkeypatch.setattr(sys, "platform", platform)
    if jax:
        monkeypatch.setitem(sys.modules, "jax", sys.modules.get("jax", sys))
    else:
        monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert compiler_mod._process_context(
        runs_torch).get_start_method() == want


def test_process_workers_carry_the_compiler_device():
    """The torch engines of a process batch run on the compiler's device
    (here the CPU): the results equal serial compiles in this process byte
    for byte, the reference's bar for its process backend."""
    jobs = [(ALL_APPS[a], PassConfig.full(place_moves=8, pnr_backend="torch",
                                          sta_backend="torch"))
            for a in ("gaussian", "unsharp")]
    torch.ones(1 << 20).sum()       # this process has used torch's pool
    c = CascadeCompiler(cache=CompileCache(), device="cpu")
    batch = c.compile_batch(jobs, backend="process", max_workers=2)
    assert c.last_batch["backend"] == "process"
    assert c.last_batch["start_method"] == "spawn"
    serial = [CascadeCompiler(device="cpu").compile(a, cfg, use_cache=False)
              for a, cfg in jobs]
    assert _summaries(batch) == _summaries(serial)
    assert _digests(batch) == _digests(serial)


def test_worker_failure_names_job_and_app():
    from repro_torch.core.apps import AppSpec

    c = CascadeCompiler(cache=CompileCache())
    bad = AppSpec("nobuild", builder=None)
    with pytest.raises(BatchCompileError) as ei:
        c.compile_batch([(ALL_APPS["vecadd"], None), (bad, None)],
                        backend="thread", use_cache=False)
    assert ei.value.job_index == 1 and ei.value.app_name == "nobuild"
