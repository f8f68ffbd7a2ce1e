"""What a run is: the cell of ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric is a file of its own under ``perfbench/``,
found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run (the arch
  name in the program's registry and every number of it), its source,
  what was reduced and what was assumed, and its plain reference
  (``reference/<module>.py``);
* ``mixes/<traffic>.json``: the traffic's parameters, read by the one
  driver of its ``kind``, ``drivers/<kind>.py`` (``train``, ``decode``);
* ``limits/<workload>.json``: the limit of each number compared, with the
  readings it was set from;
* ``metrics/<name>.py``: a per-layer metric's reader, ``read(run)``.

A name that has no file is refused, as is a file that disagrees with the
cell (another config, a missing number).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = BENCH_DIR.parent


class SpecError(ValueError):
    """A name or file the benchmark cannot take."""


def _read_json(path: Path) -> Dict:
    if not path.is_file():
        raise SpecError(f"no file {path}")
    with path.open() as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    moves: str = ""               # a per-layer metric's end-to-end metric


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: Dict                  # configs/<config>.json
    mix: Dict                     # mixes/<traffic>.json
    limits: Dict                  # limits/<workload>.json: {name: limit}
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)
    root: Path = ROOT             # the checkout the files were read from


def _applies(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its
    configuration, mix, limits and metrics."""
    bench = _read_json(root / "BENCHMARK.json")
    here = root / BENCH_DIR.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"unknown workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names unknown config "
                        f"{w['config']!r}")
    config = _read_json(root / configs[w["config"]]["file"])
    if config.get("name") != w["config"]:
        raise SpecError(f"{configs[w['config']]['file']} holds config "
                        f"{config.get('name')!r}, not {w['config']!r}")
    mix = _read_json(here / "mixes" / f"{w['traffic']}.json")
    if mix.get("name") != w["traffic"]:
        raise SpecError(f"mixes/{w['traffic']}.json holds mix "
                        f"{mix.get('name')!r}")
    if not (here / "drivers" / f"{mix.get('kind')}.py").is_file():
        raise SpecError(f"mixes/{w['traffic']}.json: no driver "
                        f"drivers/{mix.get('kind')}.py for its kind")
    limits = _read_json(here / "limits" / f"{name}.json")
    e2e = [Metric(m["name"], m["unit"])
           for m in bench["end_to_end"] if _applies(m, name)]
    per = [Metric(m["name"], m["unit"], m["moves"])
           for m in bench["per_layer"] if _applies(m, name)]
    for m in per:
        if not (here / "metrics" / f"{m.name}.py").is_file():
            raise SpecError(f"no reader metrics/{m.name}.py for metric "
                            f"{m.name!r}")
    return Cell(name, w["config"], w["traffic"], w["chips"], config, mix,
                {k: v["limit"] for k, v in limits["limits"].items()},
                e2e, per, root)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise SpecError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """``read(run)`` of the per-layer metric ``name``
    (``metrics/<name>.py``)."""
    path = root / BENCH_DIR.name / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"no reader metrics/{name}.py for metric {name!r}")
    mod = load_module(path, "perfbench_metric_" + name.replace(".", "_"))
    if not hasattr(mod, "read"):
        raise SpecError(f"metrics/{name}.py has no read(run)")
    return mod.read


DRIVER_STEPS = ("setup", "warm", "window", "traced", "check")


def driver(kind: str, root: Path = ROOT) -> ModuleType:
    """The driver of a mix kind (``drivers/<kind>.py``): ``setup(run)``
    builds the state, ``warm(run, st)`` takes every shape the window uses,
    ``window(run, st)`` measures, ``traced(run, st)`` profiles a stretch,
    ``check(run, st, sides)`` reads the numbers compared."""
    path = root / BENCH_DIR.name / "drivers" / f"{kind}.py"
    if not path.is_file():
        raise SpecError(f"no driver drivers/{kind}.py for mix kind {kind!r}")
    mod = load_module(path, f"perfbench_driver_{kind}")
    missing = [f for f in DRIVER_STEPS if not hasattr(mod, f)]
    if missing:
        raise SpecError(f"drivers/{kind}.py lacks {missing}")
    return mod


def reference_class(config: Dict):
    """The plain reference model the configuration names."""
    import importlib
    module, cls = config["reference"].rsplit(".", 1)
    return getattr(importlib.import_module(f"reference.{module}"), cls)
