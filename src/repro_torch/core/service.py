"""Long-lived compile service — the online front door to the compiler.

Everything before this module is one-shot: a driver builds a
:class:`~repro_torch.core.compiler.CascadeCompiler`, compiles, exits.  A
production deployment (heavy traffic from many
tenants) instead keeps one compiler *resident* and feeds it a stream of
requests.  :class:`CompileService` is that server:

* **Async request queue** — :meth:`~CompileService.submit` returns a
  :class:`ServiceTicket` immediately; a dispatcher thread drains the
  queue.  Requests that arrive within one ``batch_window_s`` of each
  other coalesce into a single :meth:`~CascadeCompiler.compile_batch`
  call (bounded by ``max_batch``), so concurrent tenants share the
  worker pool instead of serializing behind each other.
* **Shared cache tiers** — the service owns its compiler's
  memory/disk/stage tiers, so every tenant's compiles warm every other
  tenant's (identical requests are content-hash hits; post-PnR variants
  resume from shared stage artifacts).
* **In-flight dedup** — two *concurrent* submissions of the same compile
  (same content hash) attach to one underlying job: one compile runs,
  every ticket gets a private copy of the result.
* **Warm stage-artifact pool** — :meth:`~CompileService.warm_mapped`
  pins a tenant's ``mapped`` artifact in a :class:`~repro_torch.core.cache.
  StagePool` keyed by its mapped-stage hash, so the scheduler's sizing
  queries (:meth:`~CompileService.mapped_netlist`) and resident compiles
  never repeat the front end, even after unrelated compiles churn the
  LRU stage tier.
* **Cancellation / timeouts** — :meth:`ServiceTicket.cancel` and
  :meth:`ServiceTicket.result` timeouts end a ticket without a result;
  a ticket's ``on_release`` hook then fires exactly once, which is how
  the online scheduler (:mod:`repro_torch.core.sched`) guarantees a reserved
  fabric region is returned when its compile never lands.

The service reads no environment variables — drivers pass
``repro_torch.core.config.service_batch_window_s()`` /
``service_max_batch()`` in explicitly, keeping behaviour fully
determined by constructor arguments.
"""

from __future__ import annotations

import copy
import queue
import threading
import time
from dataclasses import dataclass, replace as dc_replace
from typing import Dict, List, Optional

from .apps import AppSpec
from .cache import CompileCache, StagePool, compile_key
from .compiler import CascadeCompiler, CompileResult, PassConfig
from .netlist import Netlist, extract_netlist


class ServiceClosed(RuntimeError):
    """The service stopped before (or while) the request could run."""


class ServiceCancelled(RuntimeError):
    """The ticket was cancelled before its result was delivered."""


class ServiceTimeout(TimeoutError):
    """``result(timeout=...)`` expired; the ticket has been cancelled."""


_PENDING, _RUNNING, _DONE = "pending", "running", "done"


class _Job:
    """One keyed unit of compile work; several tickets may share it."""

    __slots__ = ("key", "app", "config", "unroll", "verify", "tickets",
                 "state", "result", "error", "done", "claimed", "skipped")

    def __init__(self, key: Optional[str], app: AppSpec, config: PassConfig,
                 unroll: Optional[int], verify: bool):
        self.key = key
        self.app = app
        self.config = config
        self.unroll = unroll
        self.verify = verify
        self.tickets: List["ServiceTicket"] = []
        self.state = _PENDING
        self.result: Optional[CompileResult] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.claimed = False          # first ticket takes the result as-is
        self.skipped = False          # every ticket cancelled before dispatch


class ServiceTicket:
    """Handle for one submitted compile request.

    ``on_release`` (set at :meth:`CompileService.submit`) fires exactly
    once if the ticket ends *without* delivering a result — cancelled,
    timed out, service closed, or the compile failed — and never on
    success.  The online scheduler hangs its region reservation on it.
    """

    def __init__(self, service: "CompileService", job: _Job,
                 on_release=None):
        self._service = service
        self._job = job
        self._on_release = on_release
        self.cancelled = False
        self._released = False

    @property
    def app_name(self) -> str:
        return self._job.app.name

    @property
    def key(self) -> Optional[str]:
        return self._job.key

    def done(self) -> bool:
        return self._job.done.is_set()

    def _fire_release(self) -> None:
        # caller holds the service lock; run the hook outside it
        if self._released:
            return
        self._released = True
        hook, self._on_release = self._on_release, None
        if hook is not None:
            self._service._deferred_hooks.append(hook)

    def cancel(self) -> bool:
        """Withdraw the ticket; returns False when the result already
        landed.  A pending job whose every ticket cancelled is skipped by
        the dispatcher (its compile never runs); a running job finishes —
        only this ticket's delivery is abandoned."""
        return self._service._cancel(self)

    def result(self, timeout: Optional[float] = None) -> CompileResult:
        """Block for the compile result (private object, caller-owned).

        On ``timeout`` the ticket is cancelled (releasing its region hook)
        and :class:`ServiceTimeout` is raised; a previously cancelled
        ticket raises :class:`ServiceCancelled`.
        """
        if self.cancelled:
            raise ServiceCancelled(
                f"ticket for {self.app_name!r} was cancelled")
        if not self._job.done.wait(timeout):
            self.cancel()
            raise ServiceTimeout(
                f"no result for {self.app_name!r} within {timeout}s "
                f"(ticket cancelled)")
        return self._service._deliver(self)


class CompileService:
    """A long-lived, batching, cache-sharing compile server.

    Use as a context manager (``with CompileService() as svc``) or call
    :meth:`start` / :meth:`stop` explicitly.  All parameters are explicit
    (no env reads): ``batch_window_s`` is how long the dispatcher holds
    the queue open after a batch's first request, ``max_batch`` bounds
    requests per dispatched batch, ``backend``/``workers`` configure the
    underlying ``compile_batch`` pool.  ``device`` is the created
    compiler's (where the ``"torch"`` place, route and STA backends run:
    ``None`` is the card, and without CUDA they raise; ``"cpu"`` the CPU);
    a given ``compiler`` keeps its own.  Its type enters the dedup key of
    torch-placer compiles, so a CPU request and a card request never
    merge.
    """

    def __init__(self, compiler: Optional[CascadeCompiler] = None,
                 fabric=None, timing=None, energy=None,
                 batch_window_s: float = 0.005, max_batch: int = 8,
                 backend: str = "thread", workers: Optional[int] = None,
                 pool_size: int = 64, use_cache: bool = True,
                 name: str = "service", device=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if batch_window_s < 0:
            raise ValueError("batch_window_s must be >= 0")
        self.name = name
        self.compiler = compiler or CascadeCompiler(
            fabric=fabric, timing=timing, energy=energy,
            cache=CompileCache(maxsize=512),
            stage_cache=CompileCache(maxsize=256),
            batch_backend=backend, batch_workers=workers, device=device)
        self.batch_window_s = batch_window_s
        self.max_batch = max_batch
        self.use_cache = use_cache
        self.pool = StagePool(maxsize=pool_size)
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._inflight: Dict[str, _Job] = {}
        self._lock = threading.Lock()
        self._deferred_hooks: List = []     # on_release hooks to run unlocked
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._stopped = False
        self._counters = {
            "submitted": 0, "completed": 0, "failed": 0,
            "dedup_inflight": 0, "cancelled_tickets": 0,
            "skipped_jobs": 0, "batches": 0, "batched_jobs": 0,
            "largest_batch": 0,
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "CompileService":
        with self._lock:
            if self._stopped:
                raise ServiceClosed(f"service {self.name!r} already stopped")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._dispatch_loop,
                    name=f"cascade-{self.name}", daemon=True)
                self._thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the dispatcher.  ``drain`` (default) finishes every queued
        job first; otherwise queued jobs fail with :class:`ServiceClosed`
        (their tickets' release hooks fire)."""
        with self._lock:
            if self._stopped:
                return
            self._stopping = True
            drain_jobs = drain and self._thread is not None
        self._queue.put(None)                       # wake the dispatcher
        if self._thread is not None:
            self._thread.join()
        leftovers: List[_Job] = []
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            if job is not None:
                leftovers.append(job)
        if drain_jobs and leftovers:                # sentinel raced a put
            self._run_batch(leftovers)
            leftovers = []
        with self._lock:
            self._stopped = True
            for job in leftovers + [j for j in self._inflight.values()
                                    if not j.done.is_set()]:
                job.error = ServiceClosed(
                    f"service {self.name!r} stopped before compiling "
                    f"{job.app.name!r}")
                self._finish_job(job)
        self._run_release_hooks()

    def __enter__(self) -> "CompileService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission --------------------------------------------------------
    def submit(self, app: AppSpec, config: Optional[PassConfig] = None,
               unroll: Optional[int] = None, verify: bool = False,
               on_release=None) -> ServiceTicket:
        """Enqueue one compile; returns immediately.

        Identical concurrent requests (same content hash) dedup onto one
        in-flight job — every ticket still receives a private result
        object.  ``on_release`` is the no-result hook documented on
        :class:`ServiceTicket`.  A request for the torch engines on a
        device that is not there raises here
        (:meth:`~repro_torch.core.compiler.CascadeCompiler.check_device`).
        """
        cfg = config or PassConfig()
        self.compiler.check_device(cfg)
        key = None
        if self.use_cache and self.compiler.cache is not None:
            try:
                key = compile_key(app, cfg, self.compiler.fabric,
                                  self.compiler.timing, self.compiler.energy,
                                  unroll=unroll, verify=verify,
                                  device=self.compiler.device)
            except Exception:
                key = None      # unfingerprintable app: no dedup, and the
                                # build error surfaces via ticket.result()
        enqueue = None
        with self._lock:
            if self._stopping or self._stopped:
                raise ServiceClosed(f"service {self.name!r} is stopped")
            self._counters["submitted"] += 1
            job = self._inflight.get(key) if key is not None else None
            if job is not None and not job.done.is_set():
                self._counters["dedup_inflight"] += 1
            else:
                job = _Job(key, app, cfg, unroll, verify)
                if key is not None:
                    self._inflight[key] = job
                enqueue = job
            ticket = ServiceTicket(self, job, on_release=on_release)
            job.tickets.append(ticket)
        if enqueue is not None:
            self._queue.put(enqueue)
        return ticket

    def compile(self, app: AppSpec, config: Optional[PassConfig] = None,
                unroll: Optional[int] = None, verify: bool = False,
                timeout: Optional[float] = None) -> CompileResult:
        """Synchronous convenience: submit + wait."""
        return self.submit(app, config, unroll=unroll,
                           verify=verify).result(timeout=timeout)

    # -- warm mapped-artifact pool ----------------------------------------
    def warm_mapped(self, app: AppSpec,
                    config: Optional[PassConfig] = None,
                    unroll: Optional[int] = None) -> Optional[str]:
        """Pin the (hardened) mapped-stage artifact for ``(app, config)``
        in the pool; returns its mapped-stage hash (``None`` when the
        config's schedule has no stage structure).  Idempotent."""
        cfg = dc_replace(config or PassConfig(), harden_flush=True)
        key = self.compiler.stage_key_for(app, cfg, stage="mapped",
                                          unroll=unroll)
        if key is None:
            return None
        if key not in self.pool:
            art = self.compiler.compile_to_stage(
                app, cfg, stage="mapped", unroll=unroll,
                use_cache=self.use_cache)
            self.pool.put(key, art)
        return key

    def mapped_netlist(self, app: AppSpec,
                       config: Optional[PassConfig] = None,
                       unroll: Optional[int] = None) -> Netlist:
        """The app's mapped netlist, served from the warm pool (warming it
        on first use) — the scheduler's admission-sizing query."""
        key = self.warm_mapped(app, config, unroll=unroll)
        if key is None:
            return self.compiler.mapped_netlist(app, config, unroll=unroll,
                                                use_cache=self.use_cache)
        return extract_netlist(self.pool.get(key).state["graph"])

    # -- introspection -----------------------------------------------------
    def queue_depth(self) -> int:
        return self._queue.qsize()

    def stats(self) -> Dict[str, object]:
        with self._lock:
            out = dict(self._counters)
            out["inflight"] = sum(1 for j in self._inflight.values()
                                  if not j.done.is_set())
        out["queue_depth"] = self.queue_depth()
        out["pool"] = self.pool.stats()
        if self.compiler.cache is not None:
            out["cache"] = self.compiler.cache.stats()
        return out

    # -- internals ---------------------------------------------------------
    def _cancel(self, ticket: ServiceTicket) -> bool:
        with self._lock:
            job = ticket._job
            if job.done.is_set() or ticket.cancelled:
                cancelled = False
            else:
                ticket.cancelled = True
                self._counters["cancelled_tickets"] += 1
                ticket._fire_release()
                cancelled = True
        self._run_release_hooks()
        return cancelled

    def _deliver(self, ticket: ServiceTicket) -> CompileResult:
        job = ticket._job
        with self._lock:
            if ticket.cancelled:
                raise ServiceCancelled(
                    f"ticket for {ticket.app_name!r} was cancelled")
            if job.error is not None:
                raise job.error
            if not job.claimed:
                job.claimed = True
                return job.result
        # subsequent tickets of a deduped job get independent copies
        return copy.deepcopy(job.result)

    def _finish_job(self, job: _Job) -> None:
        """Caller holds the lock: mark done, update counters, fire the
        release hooks of tickets that will never see a result."""
        job.state = _DONE
        if job.key is not None and self._inflight.get(job.key) is job:
            del self._inflight[job.key]
        if job.error is not None:
            for t in job.tickets:
                t._fire_release()
            self._counters["failed"] += 1
        elif not job.skipped:
            self._counters["completed"] += 1
        job.done.set()

    def _run_release_hooks(self) -> None:
        """Run deferred on_release hooks outside the service lock."""
        while True:
            with self._lock:
                if not self._deferred_hooks:
                    return
                hook = self._deferred_hooks.pop(0)
            hook()

    def _dispatch_loop(self) -> None:
        while True:
            try:
                job = self._queue.get(timeout=0.05)
            except queue.Empty:
                if self._stopping:
                    return
                continue
            if job is None:
                return
            batch = [job]
            deadline = time.monotonic() + self.batch_window_s
            stop_after = False
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    stop_after = True
                    break
                batch.append(nxt)
            self._run_batch(batch)
            if stop_after:
                return

    def _run_batch(self, batch: List[_Job]) -> None:
        with self._lock:
            live = []
            for job in batch:
                if job.tickets and all(t.cancelled for t in job.tickets):
                    self._counters["skipped_jobs"] += 1
                    job.skipped = True
                    self._finish_job(job)
                else:
                    job.state = _RUNNING
                    live.append(job)
            if live:
                self._counters["batches"] += 1
                self._counters["batched_jobs"] += len(live)
                self._counters["largest_batch"] = max(
                    self._counters["largest_batch"], len(live))
        self._run_release_hooks()
        if not live:
            return
        plain = [j for j in live if not j.verify]
        if len(plain) > 1:
            try:
                results = self.compiler.compile_batch(
                    [(j.app, j.config, j.unroll) for j in plain],
                    verify=False, use_cache=self.use_cache)
                for j, r in zip(plain, results):
                    j.result = r
                plain = []
            except Exception:
                pass          # fall through: isolate the failing job below
        for job in plain + [j for j in live if j.verify]:
            try:
                job.result = self.compiler.compile(
                    job.app, job.config, unroll=job.unroll,
                    verify=job.verify, use_cache=self.use_cache)
            except Exception as e:          # delivered via ticket.result()
                job.error = e
        with self._lock:
            for job in live:
                self._finish_job(job)
        self._run_release_hooks()
