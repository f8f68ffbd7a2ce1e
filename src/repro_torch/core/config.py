"""Environment configuration — the single place Cascade env vars are read.

The knobs of the default compile flow:

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

Every place, route, STA and simulator backend runs in this package
(``torch`` on the caller's device: the compiler's for place, route and
STA, the ``device=`` argument of ``simulate`` and ``simulate_sparse`` for
the simulator).  The simulator's ``torch`` is the reference's ``jax``.
"""

from __future__ import annotations

import os
import warnings

_FALSY = ("", "0", "false", "no", "off")


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean env var: unset -> ``default``; "0"/"false"/"no"/"off" -> False."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in _FALSY


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
