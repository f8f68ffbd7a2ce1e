"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the comparison with the plain reference, the result line.

The driver of the cell's mix kind (``drivers/<kind>.py``, found by name)
fills a ``Run``: its end-to-end metrics over the window, the trace, the
work of a step counted from shapes, and the numbers compared. This module
turns it into the result: the cell's end-to-end metrics (``--trace 0``) or
its per-layer metrics (``--trace 1``, each from its reader in
``metrics/``), ``correct`` from the numbers and their limits, and the
device.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .spec import (Cell, ROOT, driver, load_cell, metric_reader,
                   reference_class)
from .trace import Trace

# top-level module names the run may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    # filled by the driver
    units: int = 0                # steps or calls in the window
    window_s: float = 0.0
    end_to_end: Dict[str, float] = field(default_factory=dict)  # but setup_s
    work: Dict[str, float] = field(default_factory=dict)  # a unit's
    setup_s: float = 0.0
    trace: Optional[Trace] = None
    bounds: Dict[str, float] = field(default_factory=dict)  # a traced
                                  # kernel's least seconds a call
    memory_peak: int = 0
    readings: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0

    @property
    def kind(self) -> str:
        return self.cell.mix["kind"]

    @property
    def cfg(self) -> Dict:
        return self.cell.config["config"]

    def port_config(self):
        """The program's config of this cell's arch, checked against every
        number the configuration file states."""
        port = program_config(self.cell.config["arch"])
        for key, want in self.cfg.items():
            have = getattr(port, key)
            if have != want:
                raise ValueError(
                    f"{self.cell.config_name}: the program's {key} is "
                    f"{have!r}, the configuration file states {want!r}")
        return port.replace(use_flash=True)

    def reference(self):
        return reference_class(self.cell.config)(self.cfg)


def program_config(arch: str):
    """The program's registered config of ``arch``."""
    from repro_torch.configs import get_config
    return get_config(arch)


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def strict_f32() -> None:
    """float32 products in float32, not TF32, for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def execute(run: Run, t_start: float,
            plant: Optional[Callable[[Run, Dict], None]] = None,
            sides: Sequence[str] = ("program",)) -> Dict[str, Dict]:
    """Set-up, window, trace and check of ``run``; ``t_start`` is the
    process's start on the host clock. ``plant(run, st)``, where given,
    changes the built state before its first step (a fault, in the
    harness's tests and calibration). Returns the readings of each of
    ``sides`` (``program``; ``control``: the plain reference in the
    program's place, computed a precision lower); ``run.readings`` are the
    program's."""
    d = driver(run.kind, run.cell.root)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.set_device(run.device)
        torch.zeros(1, device=run.device)      # the allocator, initialised
        torch.cuda.reset_peak_memory_stats(run.device)
    state = d.setup(run)
    if plant is not None:
        plant(run, state)
    d.warm(run, state)
    if cuda:
        torch.cuda.synchronize(run.device)
    run.setup_s = time.perf_counter() - t_start
    d.window(run, state)
    if run.traced:
        d.traced(run, state)
    if cuda:
        torch.cuda.synchronize(run.device)
        run.memory_peak = torch.cuda.max_memory_allocated(run.device)
    readings = d.check(run, state, tuple(sides))
    run.readings = readings["program"]
    return readings


def _judge(run: Run) -> Dict[str, Dict[str, float]]:
    limits = run.cell.limits
    missing = sorted(set(limits) - set(run.readings))
    if missing:
        raise RuntimeError(f"no reading of {missing}")
    return {k: {"value": run.readings[k], "limit": limits[k]}
            for k in limits}


def result(run: Run) -> Dict:
    checks = _judge(run)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and run.failed == 0
    metrics: Dict[str, Dict] = {}
    if run.traced:
        for m in run.cell.per_layer:
            value = metric_reader(m.name, run.cell.root)(run)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        e2e = dict(run.end_to_end, setup_s=run.setup_s)
        for m in run.cell.end_to_end:
            if m.name not in e2e:
                raise RuntimeError(f"the {run.kind} driver measured no "
                                   f"{m.name}")
            metrics[m.name] = {"value": e2e[m.name], "unit": m.unit}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": run.cell.chips,
              "memory_peak_bytes": run.memory_peak}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out


def write_trace_summary(run: Run) -> None:
    """The traced stretch's time by kernel and its idle gaps by host
    operation, whole, to build/perfbench/traces/<workload>.<seed>.json in
    the checkout (the result line carries the ten largest of each)."""
    t = run.trace
    path = ROOT / "build" / "perfbench" / "traces" / \
        f"{run.cell.name}.{run.seed}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    by_kernel = sorted(t.time_by_kernel().items(), key=lambda x: -x[1])
    path.write_text(json.dumps({
        "workload": run.cell.name, "seed": run.seed, "units": t.units,
        "window_s": t.window_s, "busy_s": t.busy_s, "span_s": t.span_s,
        "launches": t.launches, "kernels": len(t.kernels),
        "time_by_kernel": by_kernel, "idle_gaps": t.gaps_by_host_op},
        indent=1))


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None
         ) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="perfbench/run.py",
        description="Run one cell of BENCHMARK.json on this machine's card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 3
    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    execute(run, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}", file=sys.stderr)
        return 4
    out = result(run)
    if run.trace is not None:
        write_trace_summary(run)
    report(out)
    return 0


def report(out: Dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


__all__ = ["Run", "execute", "result", "report", "main", "ROOT",
           "load_cell"]
