"""Compile cache — content-hash keyed memoization of Cascade compiles.

Every benchmark table and most tests re-compile identical
``(app, PassConfig, fabric, timing)`` tuples; the flow is deterministic
(seeded simulated annealing), so the result is too.  The cache keys on a
SHA-256 fingerprint of everything that influences the output:

* the app's *content* — the DFG its builder emits for one copy, plus every
  workload field of the :class:`~repro_torch.core.apps.AppSpec` (so two specs
  with the same name but different builders never collide);
* the full ``PassConfig`` (including a custom pass schedule, if any);
* the fabric geometry, the timing-model entries, the energy parameters;
* the unroll override and the verify flag;
* the compiler's device type (``"cuda"`` or ``"cpu"``) when the config's
  ``pnr_backend`` is ``"torch"``: the torch placer draws different numbers
  on the card and on the CPU, so a placement made on one is never served
  to a compiler on the other.  The host backends and every STA backend
  give the same result on either device, so their keys carry no device
  and a CPU compiler and a card compiler share them.

Two tiers:

* :class:`CompileCache` — thread-safe in-memory bounded LRU (``compile_batch``
  shares one across workers), with hit/miss counters via ``stats()``.
* :class:`DiskCache` — optional cross-*process* tier under
  ``repro_torch.core.config.cache_dir()`` (``CASCADE_CACHE_DIR``), so CI
  jobs and repeat benchmark invocations skip recompiles entirely.  Entries
  are pickles written atomically under a namespace that combines a schema
  version with a digest of this package's ``core`` sources, so neither a
  format change nor a compiler-code change can ever serve a stale result.
  Total size is bounded; the oldest entries (by mtime, refreshed on hit)
  are evicted first.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import shutil
import tempfile
import threading
import time
from collections import OrderedDict
from dataclasses import asdict, fields as dc_fields
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from .apps import AppSpec
from .config import cache_dir as _default_cache_root, disk_cache_enabled
from .dfg import DFG
from .interconnect import Fabric
from .power import EnergyParams
from .timing_model import TimingModel


def dfg_fingerprint(g: DFG) -> str:
    """Stable structural digest of a DFG (nodes + edges + flags)."""
    nodes = sorted(
        (n.name, n.kind, n.op, n.width, n.latency, n.depth, n.value,
         n.input_reg, tuple(sorted((k, repr(v)) for k, v in n.meta.items())))
        for n in g.nodes.values())
    edges = sorted((e.src, e.dst, e.port, e.width) for e in g.edges)
    h = hashlib.sha256()
    h.update(repr((g.name, g.sparse, nodes, edges)).encode())
    return h.hexdigest()


def app_fingerprint(app: AppSpec) -> str:
    """Content hash of an app spec: a two-copy build + all workload fields.

    Building copies is cheap (graphs are a few hundred nodes) and captures
    the *behaviour* of the builder callable, which may be a closure (e.g.
    ``lmmap.lower_block``) and therefore has no stable identity of its own.
    Two copies are built so per-copy-index divergence shows up in the hash;
    beyond that the repo-wide invariant holds that copies are identical
    stamps (copy index only feeds node names), which keeps higher copy
    counts out of the key.
    """
    spec_fields = (app.name, app.sparse, tuple(app.frame), app.unroll,
                   app.unroll_baseline, app.work_per_output, app.work_tokens,
                   app.line_width)
    return hashlib.sha256(
        (dfg_fingerprint(app.build(2)) + repr(spec_fields)).encode()
    ).hexdigest()


def device_type(device) -> str:
    """The type of a compiler's ``device``: ``None`` is the card."""
    return torch.device("cuda" if device is None else device).type


def _device_items(config: Any, device) -> tuple:
    """The device portion of a key: the device type where the torch placer
    runs (``pnr_backend="torch"``), else nothing."""
    if getattr(config, "pnr_backend", None) != "torch":
        return ()
    return (("device", device_type(device)),)


def _env_items(fabric: Fabric, timing: TimingModel, energy: EnergyParams):
    """The (fabric, timing, energy) portion of a content hash."""
    fabric_items = tuple(
        (f.name, getattr(fabric, f.name)) for f in dc_fields(fabric))
    timing_items = (timing.fabric_name,
                    tuple(sorted(timing.entries.items())))
    energy_items = tuple(sorted(asdict(energy).items()))
    return fabric_items, timing_items, energy_items


def compile_key(app: AppSpec, config: Any, fabric: Fabric,
                timing: TimingModel, energy: EnergyParams,
                unroll: Optional[int] = None, verify: bool = False,
                app_fp: Optional[str] = None, device=None) -> str:
    """The full content-hash cache key for one compile invocation.

    ``app_fp`` lets a caller that already fingerprinted the app (the
    compile driver computes one fingerprint per invocation and shares it
    with the stage keys) skip the redundant builder runs.  ``device`` is
    the compiler's (``None``: the card); its type enters the key when the
    config places with the torch engine.
    """
    cfg_items = tuple(sorted(asdict(config).items()))
    fabric_items, timing_items, energy_items = _env_items(
        fabric, timing, energy)
    h = hashlib.sha256()
    h.update((app_fp or app_fingerprint(app)).encode())
    h.update(repr((cfg_items, fabric_items, timing_items, energy_items,
                   unroll, verify) + _device_items(config, device)).encode())
    return h.hexdigest()


def stage_key(app: AppSpec, config: Any, fabric: Fabric,
              timing: TimingModel, energy: EnergyParams, stage: str,
              prefix: tuple, unroll: Optional[int] = None,
              app_fp: Optional[str] = None, device=None) -> str:
    """Prefix content hash for a stage artifact.

    Unlike :func:`compile_key`, only the inputs that can influence the
    flow *up to and including* ``stage`` participate:

    * the config fields whose :data:`~repro_torch.core.passes.CONFIG_FIELD_STAGE`
      assignment is at or before ``stage`` — so "same app, different
      post-PnR knobs" hashes to the same routed-stage key and resumes
      from the cached artifact;
    * the resolved schedule *prefix* (the actual pass names the artifact
      embodies) rather than the raw ``schedule`` field — the named
      schedules differ only after routing, so they share prefix keys;
    * the energy parameters only from the ``pipelined`` stage on (no
      earlier pass reads them);
    * never the ``verify`` flag (a report-stage concern), so verifying
      re-compiles resume from artifacts of non-verifying ones;
    * the compiler's device type from the ``placed`` stage on when the
      config's ``pnr_backend`` is ``"torch"`` (the torch placer's result
      depends on the device), never before: the ``mapped`` prefix stays
      shared across devices.

    A config field missing from ``CONFIG_FIELD_STAGE`` raises — an
    unclassified field must never silently alias stage artifacts.
    """
    from .passes import CONFIG_FIELD_STAGE, STAGE_ORDER
    si = STAGE_ORDER.index(stage)
    cfg_dict = asdict(config)
    cfg_items = []
    for name in sorted(cfg_dict):
        field_stage = CONFIG_FIELD_STAGE.get(name)
        if field_stage is None:
            raise KeyError(
                f"PassConfig field {name!r} has no CONFIG_FIELD_STAGE "
                f"assignment; classify it before stage-caching configs "
                f"that carry it")
        if name == "schedule":
            continue                  # represented by the resolved prefix
        if STAGE_ORDER.index(field_stage) <= si:
            cfg_items.append((name, cfg_dict[name]))
    fabric_items, timing_items, energy_items = _env_items(
        fabric, timing, energy)
    if si < STAGE_ORDER.index("pipelined"):
        energy_items = ()
    dev_items = (_device_items(config, device)
                 if si >= STAGE_ORDER.index("placed") else ())
    h = hashlib.sha256()
    h.update((app_fp or app_fingerprint(app)).encode())
    h.update(repr((stage, tuple(prefix), tuple(cfg_items), fabric_items,
                   timing_items, energy_items, unroll) + dev_items).encode())
    return "stage-" + h.hexdigest()


# ---------------------------------------------------------------------------
# disk tier
# ---------------------------------------------------------------------------

#: Bump when the on-disk entry format changes; old namespaces are ignored.
DISK_SCHEMA_VERSION = 1

_code_fp: Optional[str] = None


def code_fingerprint() -> str:
    """Digest of this package's ``core`` sources (computed once per
    process).

    Namespaces the disk cache: compile keys hash *inputs* (app content,
    config, fabric, timing), not the compiler itself, so an edit to any pass
    would otherwise happily serve results from the previous code.
    """
    global _code_fp
    if _code_fp is None:
        h = hashlib.sha256()
        root = Path(__file__).resolve().parent
        for f in sorted(root.glob("*.py")):
            h.update(f.name.encode())
            h.update(f.read_bytes())
        _code_fp = h.hexdigest()
    return _code_fp


class DiskCache:
    """Cross-process compile-result cache (pickled entries, atomic writes).

    Layout: ``<root>/v<schema>-<code fingerprint>/<key>.pkl``.  Writes go to
    a temp file in the same directory and ``os.replace`` in, so concurrent
    processes (CI shards, parallel benchmarks) never observe a torn entry;
    a corrupt or unreadable entry is treated as a miss and deleted.  After
    each put the namespace is trimmed to ``max_bytes`` oldest-first (hits
    refresh mtime, making eviction LRU-ish).
    """

    def __init__(self, root: Optional[os.PathLike] = None,
                 max_bytes: int = 256 * 1024 * 1024,
                 schema: int = DISK_SCHEMA_VERSION,
                 namespace: Optional[str] = None):
        base = Path(root) if root is not None else _default_cache_root()
        self.dir = base / f"v{schema}-{(namespace or code_fingerprint())[:12]}"
        if namespace is None:
            # a code edit moves the live namespace; reap the abandoned ones
            # so the size bound holds for the whole cache root, not just
            # the current namespace.  (Explicit namespaces opt out: tests
            # and tools may keep several alive side by side.)
            for stale in base.glob("v*-*"):
                if stale.is_dir() and stale != self.dir:
                    shutil.rmtree(stale, ignore_errors=True)
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.put_errors = 0
        self.evictions = 0
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.dir / f"{key}.pkl"

    def __len__(self) -> int:
        return sum(1 for _ in self.dir.glob("*.pkl"))

    def get(self, key: str) -> Optional[Any]:
        p = self._path(key)
        try:
            with open(p, "rb") as f:
                value = pickle.load(f)
        except FileNotFoundError:
            with self._lock:
                self.misses += 1
            return None
        except Exception:
            with self._lock:
                self.misses += 1
            try:
                p.unlink()
            except OSError:
                pass
            return None
        with self._lock:
            self.hits += 1
        try:
            os.utime(p)                      # refresh mtime: LRU-ish eviction
        except OSError:
            pass
        return value

    def put(self, key: str, value: Any) -> None:
        try:
            blob = pickle.dumps(value)
        except Exception:
            with self._lock:
                self.put_errors += 1         # unpicklable result: skip tier
            return
        tmp = None
        try:
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._path(key))
        except OSError:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            with self._lock:
                self.put_errors += 1
            return
        with self._lock:
            self.puts += 1
        self._enforce_limit()

    def _enforce_limit(self) -> None:
        now = time.time()
        for orphan in self.dir.glob("*.tmp"):
            # a killed process can strand its temp file mid-put; anything
            # older than a minute is certainly not an in-flight write
            try:
                if now - orphan.stat().st_mtime > 60:
                    orphan.unlink()
            except OSError:
                pass
        try:
            entries = []
            for p in self.dir.glob("*.pkl"):
                st = p.stat()
                entries.append((st.st_mtime, st.st_size, p))
        except OSError:
            return
        total = sum(size for _, size, _ in entries)
        if total <= self.max_bytes:
            return
        for _, size, p in sorted(entries):
            try:
                p.unlink()
            except OSError:
                continue
            with self._lock:
                self.evictions += 1
            total -= size
            if total <= self.max_bytes:
                break

    def size_bytes(self) -> int:
        try:
            return sum(p.stat().st_size for p in self.dir.glob("*.pkl"))
        except OSError:
            return 0

    def clear(self) -> None:
        for p in self.dir.glob("*.pkl"):
            try:
                p.unlink()
            except OSError:
                pass
        with self._lock:
            self.hits = self.misses = self.puts = 0
            self.put_errors = self.evictions = 0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {"hits": self.hits, "misses": self.misses,
                    "puts": self.puts, "put_errors": self.put_errors,
                    "evictions": self.evictions, "entries": len(self),
                    "size_bytes": self.size_bytes(),
                    "hit_rate": round(self.hits / total, 3) if total else 0.0,
                    "dir": str(self.dir)}


# ---------------------------------------------------------------------------
# memory tier (optionally backed by a DiskCache)
# ---------------------------------------------------------------------------


class CompileCache:
    """Bounded, thread-safe LRU cache of :class:`CompileResult` objects.

    With a ``disk`` tier attached, a memory miss falls through to disk and
    a disk hit is promoted back into memory; puts write both tiers.  The
    ``hits``/``misses`` counters track the memory tier only — per-tier
    rates live in ``stats()`` (the disk tier under ``"disk"``).
    """

    def __init__(self, maxsize: int = 256, disk: Optional[DiskCache] = None):
        self.maxsize = maxsize
        self.disk = disk
        self._data: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
        if self.disk is not None:
            value = self.disk.get(key)
            if value is not None:
                self._put_memory(key, value)     # promote
                return value
        return None

    def _put_memory(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1

    def put(self, key: str, value: Any) -> None:
        self._put_memory(key, value)
        if self.disk is not None:
            self.disk.put(key, value)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = self.misses = self.evictions = 0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            out = {"hits": self.hits, "misses": self.misses,
                   "evictions": self.evictions, "entries": len(self._data),
                   "hit_rate": round(self.hits / total, 3) if total else 0.0}
        if self.disk is not None:
            out["disk"] = self.disk.stats()
        return out


class StagePool:
    """Pinned pool of warm stage artifacts, keyed by stage content hash.

    The compile service's tenant-warming tier: unlike the LRU
    :class:`CompileCache` stage tier — where a burst of unrelated compiles
    can evict exactly the ``mapped`` artifacts the scheduler's resident
    compiles resume from — the pool holds one artifact per *warmed tenant*
    and only evicts when the tenant set itself outgrows ``maxsize``
    (oldest warm first).  ``get`` hands out private forks, so callers can
    mutate what they receive without corrupting the pooled copy.
    """

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._data: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            art = self._data.get(key)
            if art is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
        return art.fork()

    def put(self, key: str, artifact: Any) -> None:
        with self._lock:
            self._data[key] = artifact
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = self.misses = self.evictions = 0

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {"entries": len(self._data), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "hit_rate": round(self.hits / total, 3) if total
                    else 0.0}


#: Process-wide default cache.  Compilers created without an explicit cache
#: share it, so repeated benchmark invocations within one process reuse each
#: other's compiles (keys are full content hashes, so sharing is safe across
#: fabrics/timings/configs).  Pass ``cache=CompileCache()`` for isolation.
DEFAULT_CACHE = CompileCache(maxsize=512)


#: Process-wide default *stage-artifact* cache: the same two-tier
#: :class:`CompileCache` machinery, but keyed by :func:`stage_key` and
#: holding :class:`~repro_torch.core.passes.StageArtifact` snapshots instead of
#: final results.  Kept separate from :data:`DEFAULT_CACHE` so final-result
#: hit/miss statistics stay meaningful and artifacts can't evict results.
DEFAULT_STAGE_CACHE = CompileCache(maxsize=128)


def attach_disk_cache(cache: Optional[CompileCache] = None,
                      **disk_kwargs) -> DiskCache:
    """Attach (idempotently) a :class:`DiskCache` tier to ``cache``
    (``DEFAULT_CACHE`` when omitted) and return it.  Benchmark drivers call
    this so repeat *processes* skip recompiles; ``CASCADE_DISK_CACHE=1``
    does the same at import for every consumer of the default cache."""
    c = DEFAULT_CACHE if cache is None else cache
    if c.disk is None:
        c.disk = DiskCache(**disk_kwargs)
    return c.disk


def attach_stage_disk_cache(cache: Optional[CompileCache] = None,
                            **disk_kwargs) -> DiskCache:
    """Attach (idempotently) a disk tier for *stage artifacts* to ``cache``
    (``DEFAULT_STAGE_CACHE`` when omitted) and return it.

    Lives under ``<cache root>/stages`` — alongside, but not inside, the
    compile-result namespace — with the same schema/code-fingerprint
    namespacing, atomic writes, and size bound; a second process (CI
    shard, repeat benchmark) then resumes compiles from the deepest
    cached stage even on configs it has never fully compiled.
    """
    c = DEFAULT_STAGE_CACHE if cache is None else cache
    if c.disk is None:
        disk_kwargs.setdefault("root", _default_cache_root() / "stages")
        c.disk = DiskCache(**disk_kwargs)
    return c.disk


if disk_cache_enabled():
    attach_disk_cache()
    attach_stage_disk_cache()
