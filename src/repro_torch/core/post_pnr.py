"""Post-place-and-route pipelining (paper Section V-D, Fig. 5).

After PnR we know exactly where every tile is placed and every net routed.
Iteratively:

1. run application STA, identify the critical path;
2. break it by enabling the switch-box pipelining register at the hop closest
   to the midpoint of the combinational segment;
3. re-run branch delay matching so every piece of data still arrives at every
   functional element on the right cycle (inserting matching registers /
   FIFOs on sibling branches);
4. repeat until no breakable path remains, the register budget is exhausted,
   or the critical path stops improving.

Every switch box holds one pipelining register per track per direction, so a
hop that already carries a register cannot take another — exactly the scarce-
register constraint that motivates the paper (and that makes the software
approach infeasible for the flush broadcast, Section VI).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from .branch_delay import MatchPlan
from .netlist import RoutedDesign
from .sta import STAReport, analyze
from .timing_model import TimingModel


@dataclass
class DesignCheckpoint:
    """Snapshot of everything post-PnR pipelining mutates on a routed design.

    The loop only ever changes two things: which hop sites carry a
    pipelining register (``RoutedBranch.reg_hops``) and how many registers
    each netlist branch is annotated with (``Branch.n_regs``).  Capturing
    those is enough to rewind a design to any earlier pipelining state —
    placement, routing, and node structure are immutable during the loop.
    Used for the in-loop revert here and for the power-cap rollback in
    :mod:`repro_torch.core.power_cap`; future schedule-space-exploration passes
    should reuse it rather than re-listing the mutable fields.
    """

    reg_hops: Dict[Tuple, Set[int]]
    n_regs: Dict[Tuple, int]

    @classmethod
    def capture(cls, design: RoutedDesign) -> "DesignCheckpoint":
        return cls(
            reg_hops={k: set(rb.reg_hops) for k, rb in design.routes.items()},
            n_regs={b.key: b.n_regs for b in design.netlist.branches})

    def fork(self) -> "DesignCheckpoint":
        """An independent copy: mutating one fork's sets/counts (or
        restoring it onto a design that then keeps pipelining) can never
        leak into its siblings.  Exploration passes fork one post-route
        checkpoint per sweep point instead of re-capturing the design."""
        return DesignCheckpoint(
            reg_hops={k: set(v) for k, v in self.reg_hops.items()},
            n_regs=dict(self.n_regs))

    def restore(self, design: RoutedDesign) -> None:
        for k, rb in design.routes.items():
            rb.reg_hops = set(self.reg_hops[k])
        for b in design.netlist.branches:
            b.n_regs = self.n_regs[b.key]


@dataclass
class PostPnRParams:
    max_iters: int = 400
    register_budget: Optional[int] = None   # max regs added by this pass
    target_ns: float = 0.0                  # stop early if cp <= target
    min_improvement: float = 1e-4
    patience: int = 3


@dataclass
class PostPnRResult:
    initial_ns: float
    final_ns: float
    iterations: int
    registers_added: int
    history: List[float] = field(default_factory=list)
    stop_reason: str = ""


def _segment_candidates(design: RoutedDesign, tm: TimingModel,
                        rep: STAReport) -> List[Tuple[Tuple, int, float]]:
    """Unregistered hop sites along the critical segment with their cumulative
    delay from the segment launch: [(branch_key, hop_idx, cum_delay_ns)]."""
    path = rep.critical_path
    if len(path) < 2:
        return []
    out: List[Tuple[Tuple, int, float]] = []
    cum = tm.reg_clk_q
    for a, b in zip(path, path[1:]):
        # identify the branch and hop range between consecutive path elements
        if a[0] == "node" and b[0] == "node":
            bkey, lo, hi = design.branch_key_between(a[1], b[1]), None, None
            if bkey is None:
                cum += tm.core_delay(_kind(design, a[1]))
                continue
            rb = design.routes[bkey]
            lo, hi = 0, len(rb.hops)
            cum += tm.core_delay(_kind(design, a[1]))
        elif a[0] == "node" and b[0] == "hop":
            bkey = b[1]
            rb = design.routes[bkey]
            lo, hi = 0, b[2] + 1
            cum += tm.core_delay(_kind(design, a[1]))
        elif a[0] == "hop" and b[0] == "node":
            bkey = a[1]
            rb = design.routes[bkey]
            lo, hi = a[2] + 1, len(rb.hops)
        else:  # hop -> hop on the same branch
            bkey = a[1]
            rb = design.routes[bkey]
            lo, hi = a[2] + 1, b[2] + 1
        for i in range(lo, hi):
            cum += tm.hop_delay(design.fabric, rb.hops[i])
            if i not in rb.reg_hops:
                out.append((bkey, i, cum))
    return out


def _kind(design: RoutedDesign, name: str) -> str:
    node = design.netlist.nodes.get(name)
    if node is None:
        return "pe"
    return "io" if node.kind in ("input", "output") else node.kind


def _find_branch(design: RoutedDesign, driver: str, sink: str):
    """The original O(routes) scan.  Kept as the reference semantics for
    :meth:`RoutedDesign.branch_key_between` (the lazy index that replaced
    it on the hot path); a regression test asserts they agree on every
    pair."""
    for key, rb in design.routes.items():
        if key[0] == driver and key[1] == sink:
            return key
    return None


#: Per-round observer: called with the design and its fresh STA report after
#: every round that actually changed the design (reverted rounds are not
#: reported).  Returning False stops the loop; the hook may first rewind the
#: design to an earlier state (see ``repro_torch.core.power_cap``), which the loop
#: accounts for by re-analyzing before it returns.
RoundHook = Callable[[RoutedDesign, STAReport], bool]


@dataclass
class _RoundDelta:
    """Cheap per-round undo record, replacing the full
    :class:`DesignCheckpoint` the loop used to capture every round.

    A round mutates exactly two things: it *adds* register sites to some
    routes (the chosen site plus whatever ``_add_regs_balanced``
    materializes — recorded in ``added`` as they happen) and rewrites
    ``Branch.n_regs`` counts (matching only ever increments, but
    arbitrarily many branches — captured up front as one int list,
    positionally aligned with ``netlist.branches``, which is frozen
    during the loop).  The old capture copied every route's ``reg_hops``
    set, O(total hops) of set allocation per round; profiling the
    harris x4 pipelining stage put that at roughly a quarter of non-STA
    loop time.  Undoing from the delta restores byte-identical state
    (set membership and counts), pinned by the ``PostPnRResult.history``
    byte-identity tests.
    """

    n_regs: List[int]
    added: List[Tuple[Tuple, int]] = field(default_factory=list)

    @classmethod
    def capture(cls, design: RoutedDesign) -> "_RoundDelta":
        return cls(n_regs=[b.n_regs for b in design.netlist.branches])

    def undo(self, design: RoutedDesign) -> None:
        for key, i in reversed(self.added):
            design.routes[key].reg_hops.discard(i)
        for b, n in zip(design.netlist.branches, self.n_regs):
            b.n_regs = n


class _ScalarEngine:
    """The oracle path behind the engine seam: every analyze re-walks the
    netlist via :func:`repro_torch.core.sta.analyze`; notifications are no-ops."""

    backend = "scalar"

    def __init__(self, design: RoutedDesign, tm: TimingModel):
        self.design, self.tm = design, tm

    def analyze(self) -> STAReport:
        return analyze(self.design, self.tm)

    def segment_candidates(self, rep: STAReport):
        return _segment_candidates(self.design, self.tm, rep)

    def notify_added(self, sites) -> None:
        pass

    def notify_removed(self, sites) -> None:
        pass

    def resync(self) -> None:
        pass


def _make_engine(design: RoutedDesign, tm: TimingModel, sta_backend: str,
                 lowering=None, device=None):
    if sta_backend == "scalar":
        return _ScalarEngine(design, tm)
    from .sta_vec import IncrementalSTA
    return IncrementalSTA(design, tm, backend=sta_backend, lowering=lowering,
                          device=device)


def post_pnr_pipeline(design: RoutedDesign, tm: TimingModel,
                      params: Optional[PostPnRParams] = None,
                      round_hook: Optional[RoundHook] = None,
                      sta_backend: str = "scalar",
                      lowering=None, device=None) -> PostPnRResult:
    """The Section V-D register-insertion loop.

    ``sta_backend`` selects the timing engine: ``"scalar"`` re-walks the
    netlist every round (the oracle); ``"numpy"`` / ``"torch"`` keep a
    :class:`~repro_torch.core.sta_vec.IncrementalSTA` alive across rounds
    (optionally reusing a caller-supplied ``lowering`` of the routed
    structure): numpy re-propagates only the dirty fanout cone of the
    edited hops, torch re-runs the level loop on ``device`` (``None``: the
    card).  All backends produce byte-identical designs, histories, and
    stop reasons — one shared loop drives an engine seam, so the control
    flow cannot drift, and the engines' reports are bit-identical by
    construction.
    """
    p = params or PostPnRParams()
    engine = _make_engine(design, tm, sta_backend, lowering, device)
    # branch topology is frozen during the loop; precompute the match
    # structure once instead of re-toposorting the netlist every round
    match_plan = MatchPlan(design.netlist)
    rep = engine.analyze()
    initial = rep.critical_path_ns
    history = [initial]
    stall = 0
    reason = "max_iters"

    for it in range(p.max_iters):
        if p.target_ns and rep.critical_path_ns <= p.target_ns:
            reason = "target_reached"
            break
        cands = engine.segment_candidates(rep)
        if not cands:
            reason = "core_bound"  # segment has no free register site
            break
        # pick the site closest to the segment's delay midpoint
        total = rep.critical_path_ns - tm.sequential_overhead()
        bkey, hop_idx, _ = min(cands, key=lambda c: abs(c[2] - total / 2.0))

        delta = _RoundDelta.capture(design)        # for in-loop revert

        rb = design.routes[bkey]
        rb.reg_hops.add(hop_idx)
        delta.added.append((bkey, hop_idx))
        rb.branch.n_regs += 1
        added = 1 + match_plan.run()
        # materialize matching registers on routes (keep manually placed sites)
        for key2, rb2 in design.routes.items():
            want = rb2.branch.n_regs
            have = len(rb2.reg_hops)
            if have < want:
                for idx in _add_regs_balanced(rb2, want - have):
                    delta.added.append((key2, idx))
        engine.notify_added(delta.added)

        if p.register_budget is not None and \
                design.netlist.added_registers() > p.register_budget:
            delta.undo(design)
            engine.notify_removed(delta.added)
            reason = "register_budget"
            break

        new_rep = engine.analyze()
        reverted = False
        if new_rep.critical_path_ns > rep.critical_path_ns:
            delta.undo(design)
            engine.notify_removed(delta.added)
            new_rep = rep
            reverted = True
        # budget hook: consulted on every round that changed the design,
        # *before* the convergence check — a no-improvement round still
        # spends a register and must not slip past an external budget
        if round_hook is not None and not reverted \
                and not round_hook(design, new_rep):
            engine.resync()              # the hook may have rewound the design
            rep = engine.analyze()
            history.append(rep.critical_path_ns)
            reason = "round_hook"
            break
        if new_rep.critical_path_ns >= rep.critical_path_ns - p.min_improvement:
            stall += 1
            if stall >= p.patience:
                rep = new_rep
                history.append(rep.critical_path_ns)
                reason = "converged"
                break
        else:
            stall = 0
        rep = new_rep
        history.append(rep.critical_path_ns)

    added_total = design.netlist.added_registers()
    return PostPnRResult(
        initial_ns=initial, final_ns=history[-1] if history else initial,
        iterations=len(history) - 1, registers_added=added_total,
        history=history, stop_reason=reason)


def _add_regs_balanced(rb, k: int) -> List[int]:
    """Add k registers to free hop sites, spreading across the route.
    Returns the hop indices actually added (the loop's undo record)."""
    free = [i for i in range(len(rb.hops)) if i not in rb.reg_hops]
    out: List[int] = []
    if not free:
        return out  # zero-hop or saturated branch: absorbed at tile input
    step = max(1, len(free) // (k + 1))
    for j in range(k):
        if not free:
            break
        idx = free[min(len(free) - 1, (j + 1) * step)] if len(free) > 1 else free[0]
        rb.reg_hops.add(idx)
        out.append(idx)
        free.remove(idx)
    return out
