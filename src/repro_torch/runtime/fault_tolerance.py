"""Fault-tolerant training loop: checkpoint/restart, straggler mitigation,
elastic rescale.

On a real multi-pod deployment the failure signals come from the cluster
manager (preemption notices, ICI link errors, heartbeat timeouts).  In this
container the same control-flow runs against a ``FailureInjector`` that
raises at configured steps — the recovery logic (restore-latest, reshard to
the surviving mesh, replay the data stream) is identical, only the signal
source is simulated.

Design points for 1000+ nodes:

* **Determinism** — the data pipeline is (seed, step)-pure, so recovery
  replays the exact global batches; no data loss or duplication.
* **Atomic checkpoints** — a step directory appears only via rename;
  a crash mid-save leaves the previous checkpoint authoritative.
* **Elastic rescale** — `on_failure="shrink"` rebuilds the mesh with the
  surviving device count and `device_put`s the restored state with the new
  shardings; global batch is preserved (per-replica batch grows).
* **Straggler mitigation** — a deadline policy over observed step times;
  steps past ``deadline_factor`` x median are counted, and hosts exceeding
  ``max_strikes`` would be cordoned (here: recorded + surfaced to the test).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

Tree = Any


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raise InjectedFailure at the given steps (each fires once)."""
    fail_at: Dict[int, str] = dataclasses.field(default_factory=dict)
    fired: List[int] = dataclasses.field(default_factory=list)

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.append(step)
            raise InjectedFailure(self.fail_at[step])


@dataclasses.dataclass
class StragglerPolicy:
    deadline_factor: float = 3.0
    max_strikes: int = 2
    window: int = 16

    def __post_init__(self):
        self.times: List[float] = []
        self.strikes = 0
        self.cordoned = False

    def observe(self, dt: float) -> bool:
        """Record a step time; returns True if this step was a straggler."""
        self.times.append(dt)
        hist = self.times[-self.window:]
        if len(hist) < 4:
            return False
        med = sorted(hist)[len(hist) // 2]
        if dt > self.deadline_factor * med:
            self.strikes += 1
            if self.strikes >= self.max_strikes:
                self.cordoned = True
            return True
        return False


@dataclasses.dataclass
class FaultTolerantLoop:
    """Drives `step_fn(state, batch) -> state` with checkpoint/restart.

    step_fn, state, and the checkpoint manager are supplied by the caller;
    this class owns only the control flow so it is testable without devices.
    """
    step_fn: Callable[[Tree, Any], Tree]
    batch_fn: Callable[[int], Any]
    ckpt_save: Callable[[int, Tree], None]
    ckpt_restore: Callable[[], tuple]          # -> (step | None, state | None)
    checkpoint_every: int = 50
    max_restarts: int = 3
    injector: Optional[FailureInjector] = None
    straggler: Optional[StragglerPolicy] = None
    on_failure: Optional[Callable[[Exception], None]] = None   # e.g. remesh

    def run(self, state: Tree, start_step: int, num_steps: int) -> tuple:
        step = start_step
        restarts = 0
        history: List[str] = []
        while step < start_step + num_steps:
            try:
                if self.injector is not None:
                    self.injector.check(step)
                t0 = time.monotonic()
                state = self.step_fn(state, self.batch_fn(step))
                dt = time.monotonic() - t0
                if self.straggler is not None and self.straggler.observe(dt):
                    history.append(f"straggler@{step}")
                step += 1
                if step % self.checkpoint_every == 0:
                    self.ckpt_save(step, state)
            except InjectedFailure as e:
                restarts += 1
                history.append(f"failure@{step}:{e}")
                if restarts > self.max_restarts:
                    raise
                if self.on_failure is not None:
                    self.on_failure(e)
                ck_step, ck_state = self.ckpt_restore()
                if ck_state is not None:
                    step, state = ck_step, ck_state
                    history.append(f"restored@{ck_step}")
                else:
                    step = start_step
                    history.append("restarted-from-scratch")
        return state, step, history
