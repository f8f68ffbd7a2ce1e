"""Environment configuration — the single place Cascade env vars are read.

The knobs of the compile flow and its driver:

    CASCADE_CACHE_DIR    disk-cache root (default ``~/.cache/cascade-repro``)
    CASCADE_DISK_CACHE   truthy -> attach the disk tier to the process-wide
                         compile and stage caches at import
    CASCADE_WORKERS      ``compile_batch`` worker count (default: min(8,
                         cpu count), never more than the jobs)
    CASCADE_POWER_CAP_MW default power budget for driver CLIs; drivers copy
                         it into ``PassConfig.power_capped(...)``, the
                         compiler never reads it implicitly

    CASCADE_PLACE_DEBUG  truthy -> the SA placer re-derives the full cost
                         at every temperature step and asserts the
                         incremental bookkeeping agrees
    CASCADE_SIM_BACKEND  default simulator backend for driver CLIs:
                         "interpreter", "numpy" or "torch".  Driver-side
                         only — drivers pass it as the explicit
                         ``backend=`` argument; library code never reads it.
    CASCADE_PNR_BACKEND  default place-and-route kernel backend for driver
                         CLIs: "scalar", "numpy" or "torch".  Drivers copy
                         it into ``PassConfig.pnr_backend``; the compiler
                         never reads it implicitly.
    CASCADE_STA_BACKEND  default timing-analysis backend for driver CLIs:
                         "scalar", "numpy" or "torch".  Drivers copy it
                         into ``PassConfig.sta_backend``; the library never
                         reads it implicitly.
    CASCADE_SERVICE_BATCH_WINDOW_MS
                         how long the compile service's dispatcher holds
                         the queue open after the first request of a
                         batch, so concurrent arrivals coalesce into one
                         ``compile_batch`` (default 5 ms).  Driver-side
                         only: drivers pass it to the ``CompileService``
                         constructor, the service never reads env vars.
    CASCADE_SERVICE_MAX_BATCH
                         upper bound on requests per dispatched service
                         batch (default 8).  Driver-side only, as above.
    CASCADE_SCHED_LATENCY_WEIGHT
                         default latency weight of the traffic
                         ``objective()`` the online scheduler admits by:
                         requests/s of throughput one millisecond of mean
                         latency is worth (default 1.0).  Driver-side
                         only — drivers pass it into ``replay()`` /
                         ``FabricScheduler``; the library default stays
                         pinned at 1.0.

Every place, route, STA and simulator backend runs in this package
(``torch`` on the caller's device: the compiler's for place, route and
STA, the ``device=`` argument of ``simulate`` and ``simulate_sparse`` for
the simulator).  The simulator's ``torch`` is the reference's ``jax``.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Optional

_FALSY = ("", "0", "false", "no", "off")


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean env var: unset -> ``default``; "0"/"false"/"no"/"off" -> False."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in _FALSY


def cache_dir() -> Path:
    """Disk-cache root: ``CASCADE_CACHE_DIR`` or ``~/.cache/cascade-repro``."""
    root = os.environ.get("CASCADE_CACHE_DIR")
    if root:
        return Path(root).expanduser()
    return Path.home() / ".cache" / "cascade-repro"


def worker_count(jobs: Optional[int] = None, cap: int = 8) -> int:
    """Batch worker count: ``CASCADE_WORKERS`` wins; otherwise min(cap, cpu
    count), never more than ``jobs`` when given, always at least 1.  The
    ``jobs`` clamp applies to the env path too."""
    env = os.environ.get("CASCADE_WORKERS")
    if env:
        try:
            w = int(env)
        except ValueError:
            w = None
        if w is not None:
            if jobs is not None:
                w = min(w, jobs)
            return max(1, w)
    w = min(cap, os.cpu_count() or cap)
    if jobs is not None:
        w = min(w, jobs)
    return max(1, w)


def env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    """Float env var: unset or empty -> ``default``.  An unparsable value
    also falls back to ``default``, with a ``UserWarning`` naming the
    variable and the value (``CASCADE_POWER_CAP_MW=250mW`` must not
    silently compile uncapped)."""
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        return float(v)
    except ValueError:
        warnings.warn(
            f"ignoring unparsable {name}={v!r} (not a float); "
            f"falling back to default {default!r}",
            UserWarning, stacklevel=2)
        return default


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """Int env var: unset or empty -> ``default``; unparsable values warn
    (naming the variable and value) and fall back, like :func:`env_float`."""
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        return int(v)
    except ValueError:
        warnings.warn(
            f"ignoring unparsable {name}={v!r} (not an int); "
            f"falling back to default {default!r}",
            UserWarning, stacklevel=2)
        return default


def service_batch_window_s(default: float = 0.005) -> float:
    """Dispatcher batch window in *seconds* for the compile service
    (``CASCADE_SERVICE_BATCH_WINDOW_MS``, milliseconds in the env).

    Driver-side only: CLIs pass the value to the ``CompileService``
    constructor — the service itself never reads the environment, so its
    behaviour is fully determined by its arguments.
    """
    ms = env_float("CASCADE_SERVICE_BATCH_WINDOW_MS")
    return default if ms is None else max(0.0, ms / 1e3)


def service_max_batch(default: int = 8) -> int:
    """Max requests per dispatched service batch
    (``CASCADE_SERVICE_MAX_BATCH``), driver-side only; always >= 1."""
    n = env_int("CASCADE_SERVICE_MAX_BATCH", default)
    return max(1, n if n is not None else default)


def sched_latency_weight(default: float = 1.0) -> float:
    """Default objective latency weight for scheduler drivers
    (``CASCADE_SCHED_LATENCY_WEIGHT``).

    Driver-side only: benchmark CLIs pass it into ``replay()`` /
    ``FabricScheduler`` — the library's own default stays pinned at 1.0
    (regression-tested), so cached results and admission decisions never
    depend on ambient environment state.
    """
    w = env_float("CASCADE_SCHED_LATENCY_WEIGHT", default)
    return default if w is None else w


def default_power_cap_mw(default: Optional[float] = None) -> Optional[float]:
    """Default power budget for the power-capped schedule
    (``CASCADE_POWER_CAP_MW``); ``None`` means unconstrained.  Drivers copy
    it into the ``PassConfig`` they compile with — the compiler never reads
    it implicitly, keeping cache keys faithful."""
    return env_float("CASCADE_POWER_CAP_MW", default)


def disk_cache_enabled(default: bool = False) -> bool:
    return env_flag("CASCADE_DISK_CACHE", default)


#: The place-and-route kernel backends (``PassConfig.pnr_backend`` /
#: ``PlaceParams.backend`` / ``RouteParams.backend``).  ``scalar`` and
#: ``numpy`` are the bit-identical SA/A* pair; ``torch`` is the
#: parallel-tempering placer and batched router on a torch device.
PNR_BACKENDS = ("scalar", "numpy", "torch")

#: The simulator backends (``sim`` ``backend=`` argument).  ``interpreter``
#: is the deque-and-dict oracle; ``numpy`` and ``torch`` run the vectorized
#: lowerings of :mod:`repro_torch.core.sim_vec`, ``torch`` through the
#: ``sim_dense`` / ``sim_sparse`` kernels on the card.
SIM_BACKENDS = ("interpreter", "numpy", "torch")

#: The application-STA backends (``PassConfig.sta_backend`` / the
#: ``backend=`` argument of :func:`repro_torch.core.sta.analyze`).
#: ``scalar`` is the node-by-node oracle; ``numpy`` and ``torch`` run the
#: lowered level propagation (``torch`` on a torch device), bit-identical.
STA_BACKENDS = ("scalar", "numpy", "torch")


def _backend_env(var: str, choices, default: str) -> str:
    """A backend name from ``var``; an unknown value warns and falls back
    to ``default`` (a typo must not silently switch engines)."""
    v = os.environ.get(var)
    if v is None or not v.strip():
        return default
    v = v.strip().lower()
    if v not in choices:
        warnings.warn(
            f"ignoring unknown {var}={v!r} (expected one of {choices}); "
            f"falling back to {default!r}", UserWarning, stacklevel=3)
        return default
    return v


def sim_backend(default: str = "interpreter") -> str:
    """Default simulator backend (``CASCADE_SIM_BACKEND``), driver-side only."""
    return _backend_env("CASCADE_SIM_BACKEND", SIM_BACKENDS, default)


def sta_backend(default: str = "scalar") -> str:
    """Default timing-analysis backend (``CASCADE_STA_BACKEND``),
    driver-side only."""
    return _backend_env("CASCADE_STA_BACKEND", STA_BACKENDS, default)


def pnr_backend(default: str = "numpy") -> str:
    """Default PnR kernel backend (``CASCADE_PNR_BACKEND``), driver-side only."""
    return _backend_env("CASCADE_PNR_BACKEND", PNR_BACKENDS, default)


def place_debug(default: bool = False) -> bool:
    return env_flag("CASCADE_PLACE_DEBUG", default)
