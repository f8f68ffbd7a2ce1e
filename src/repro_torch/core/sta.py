"""Static timing analysis of a placed-and-routed CGRA application
(paper Section IV-B).

Walks the netlist in topological order computing the worst-case arrival time
at every node output; routes are walked hop-by-hop, with enabled switch-box
registers cutting combinational segments.  The maximum register-to-register
segment (plus sequential overhead) is the critical path; max frequency is its
reciprocal.

Two extras over a textbook STA:

* ``rng`` — per-instance sampled delays (each core/hop instance draws a
  factor in [sigma_lo, 1.0] of worst case).  This is the stand-in for the
  paper's SDF-annotated gate-level simulation (Fig. 6): an independent,
  less-pessimistic timing oracle used to measure STA model error.
* critical-path *reconstruction* — the post-PnR pipelining pass needs the
  concrete hop list of the critical path to pick a register site.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .dfg import FIFO, INPUT, MEM, OUTPUT, PE, RF
from .netlist import RoutedBranch, RoutedDesign
from .timing_model import TimingModel

# path element: ("node", name) | ("hop", branch_key, hop_index)
PathElem = Tuple


@dataclass
class STAReport:
    critical_path_ns: float
    max_freq_mhz: float
    critical_path: List[PathElem]
    arrival_out: Dict[str, float]
    n_segments: int                  # number of timed path segments
    clock_period_ns: float = 0.0     # quantized achievable period

    def __repr__(self):
        return (f"STAReport(cp={self.critical_path_ns:.3f}ns, "
                f"fmax={self.max_freq_mhz:.1f}MHz, "
                f"elems={len(self.critical_path)})")


def _seq_output(node) -> bool:
    """Does this node's output launch a fresh combinational segment?"""
    if node.kind in (INPUT, MEM, RF, FIFO):
        return True
    if node.kind == PE and node.input_reg:
        return True
    return False


def _seq_input(node) -> bool:
    """Does this node's input capture (terminate) a combinational segment?"""
    if node.kind in (OUTPUT, MEM, RF, FIFO):
        return True
    if node.kind == PE and node.input_reg:
        return True
    return False


class _Sampler:
    """Per-instance delay factors for the SDF-like simulation mode."""

    def __init__(self, rng: Optional[np.random.Generator], lo: float):
        self.rng, self.lo, self.cache = rng, lo, {}

    def __call__(self, key) -> float:
        if self.rng is None:
            return 1.0
        if key not in self.cache:
            self.cache[key] = float(self.rng.uniform(self.lo, 1.0))
        return self.cache[key]


def analyze(design: RoutedDesign, tm: TimingModel,
            rng: Optional[np.random.Generator] = None,
            sigma_lo: float = 0.6,
            clock_granularity_ns: float = 0.0,
            backend: str = "scalar", device=None) -> STAReport:
    """Application STA.  ``backend`` selects the engine: ``"scalar"`` is
    this module's node-by-node walk (the oracle); ``"numpy"`` / ``"torch"``
    run the lowered whole-level propagation of
    :mod:`repro_torch.core.sta_vec`, bit-identical to it (``device`` is
    read by ``"torch"`` only; ``None`` is the card).  The sampled-delay
    path (``rng``) draws one factor per component *instance* in visit
    order, so it always runs on the scalar walk regardless of
    ``backend``."""
    if backend != "scalar" and rng is None:
        from .sta_vec import analyze_vec
        return analyze_vec(design, tm, backend=backend,
                           clock_granularity_ns=clock_granularity_ns,
                           device=device)
    nl, fabric = design.netlist, design.fabric
    sample = _Sampler(rng, sigma_lo)
    overhead = tm.sequential_overhead()

    # topo order over the netlist graph
    names = list(nl.nodes)
    idx = {n: i for i, n in enumerate(names)}
    indeg = {n: 0 for n in names}
    adj: Dict[str, List] = {n: [] for n in names}
    by_sink: Dict[str, List[RoutedBranch]] = {n: [] for n in names}
    for rb in design.routes.values():
        b = rb.branch
        indeg[b.sink] += 1
        adj[b.driver].append(rb)
        by_sink[b.sink].append(rb)
    order, stack = [], [n for n in names if indeg[n] == 0]
    while stack:
        n = stack.pop()
        order.append(n)
        for rb in adj[n]:
            indeg[rb.branch.sink] -= 1
            if indeg[rb.branch.sink] == 0:
                stack.append(rb.branch.sink)
    if len(order) != len(names):
        raise ValueError("netlist graph has a cycle")

    arrival_out: Dict[str, float] = {}
    # backpointers for critical path reconstruction
    bp_node: Dict[str, Optional[PathElem]] = {}
    best = (-1.0, None)  # (worst segment ns, (kind, payload))
    seg_count = 0

    # arrival at a sink's input pin along each branch
    def walk_branch(rb: RoutedBranch, a0: float, src_elem) -> Tuple[float, PathElem]:
        """Returns (arrival at sink in-pin, backpointer elem).  Also scores
        register capture points inside the route."""
        nonlocal best, seg_count
        a, last = a0, src_elem
        for i, hop in enumerate(rb.hops):
            a += tm.hop_delay(fabric, hop) * sample(("hop", rb.branch.key, i))
            if i in rb.reg_hops:
                seg_count += 1
                seg = a + overhead
                if seg > best[0]:
                    best = (seg, ("hop", rb.branch.key, i, last))
                a = tm.reg_clk_q
                last = ("hop", rb.branch.key, i)
        a += tm.cb_in * sample(("cb", rb.branch.key))
        return a, last

    for name in order:
        node = nl.nodes[name]
        core = tm.core_delay("io" if node.kind in (INPUT, OUTPUT)
                             else node.kind, node.op)
        core *= sample(("core", name))
        if _seq_output(node):
            a_out = tm.reg_clk_q + core
            bp_node[name] = None
        else:
            # combinational: worst input arrival + core delay
            a_in, src = 0.0, None
            for rb in by_sink[name]:
                a0 = arrival_out[rb.branch.driver]
                elem0 = ("node", rb.branch.driver)
                a, last = walk_branch(rb, a0, elem0)
                if a > a_in:
                    a_in, src = a, last
            a_out = a_in + core
            bp_node[name] = src
        arrival_out[name] = a_out
        # capture at sequential inputs
        if _seq_input(node):
            for rb in by_sink[name]:
                a0 = arrival_out[rb.branch.driver]
                a, last = walk_branch(rb, a0, ("node", rb.branch.driver))
                seg_count += 1
                seg = a + overhead
                if seg > best[0]:
                    best = (seg, ("node", name, last))

    cp, anchor = best
    if cp < 0:
        cp, anchor = overhead + tm.core_delay("pe"), None

    # reconstruct the critical path element list
    path: List[PathElem] = []
    if anchor is not None:
        if anchor[0] == "hop":
            _, bkey, i, last = anchor
            path.append(("hop", bkey, i))
            cur = last
        else:
            _, nname, last = anchor
            path.append(("node", nname))
            cur = last
        guard = 0
        while cur is not None and guard < 100_000:
            path.append(cur)
            cur = bp_node.get(cur[1]) if cur[0] == "node" else None
            guard += 1
        path.reverse()

    period = cp
    if clock_granularity_ns > 0:
        period = math.ceil(cp / clock_granularity_ns) * clock_granularity_ns
    return STAReport(
        critical_path_ns=cp,
        max_freq_mhz=1e3 / period,
        critical_path=path,
        arrival_out=arrival_out,
        n_segments=seg_count,
        clock_period_ns=period,
    )


def sdf_simulate_fmax(design: RoutedDesign, tm: TimingModel, seed: int = 0,
                      n_trials: int = 5, sigma_lo: float = 0.6,
                      granularity_ns: float = 0.1) -> float:
    """SDF-annotated-gate-level-simulation stand-in (paper Section VIII-A).

    Samples per-instance delays below worst case and searches for the fastest
    clock at 0.1 ns granularity; returns the max frequency (MHz) the design
    actually runs at, taken over trials (worst case across trials, as a real
    netlist has one fixed set of parasitics per corner).
    """
    worst_cp = 0.0
    for trial in range(n_trials):
        rng = np.random.default_rng(seed + trial)
        rep = analyze(design, tm, rng=rng, sigma_lo=sigma_lo)
        worst_cp = max(worst_cp, rep.critical_path_ns)
    period = math.ceil(worst_cp / granularity_ns) * granularity_ns
    return 1e3 / period


# ---------------------------------------------------------------------------
# max-plus formulation (backed by the maxplus kernel)
# ---------------------------------------------------------------------------

def timing_matrix(design: RoutedDesign, tm: TimingModel) -> Tuple[np.ndarray, List[str]]:
    """Dense max-plus adjacency of the *combinational segment* graph.

    M[i, j] = delay of the combinational edge j -> i (NEG_INF if none).
    Longest path = max-plus fixpoint of ``arr = M (x) arr``: the input of
    ``repro_torch.kernels.maxplus.longest_path``, held against this numpy
    construction.  Input launches start at the ``"SRC"`` vertex
    (``verts.index("SRC")``), not at their ``in`` vertices.
    """
    NEG = np.float32(-1e9)
    nl, fabric = design.netlist, design.fabric
    verts: List[str] = []

    def vid(key) -> int:
        s = str(key)
        if s not in vindex:
            vindex[s] = len(verts)
            verts.append(s)
        return vindex[s]

    vindex: Dict[str, int] = {}
    edges: List[Tuple[int, int, float]] = []
    for name, node in nl.nodes.items():
        core = tm.core_delay("io" if node.kind in (INPUT, OUTPUT)
                             else node.kind, node.op)
        iv, ov = vid(("in", name)), vid(("out", name))
        if _seq_output(node):
            edges.append((vid("SRC"), ov, tm.reg_clk_q + core))
        else:
            edges.append((iv, ov, core))
    for rb in design.routes.values():
        b = rb.branch
        prev = vid(("out", b.driver))
        acc = 0.0
        for i, hop in enumerate(rb.hops):
            acc += tm.hop_delay(fabric, hop)
            if i in rb.reg_hops:
                hv = vid(("hop", b.key, i))
                edges.append((prev, hv, acc))
                edges.append((vid("SRC"), hv, 0.0))  # also a launch point
                # capture side handled by reading arrival at hv
                prev, acc = hv, tm.reg_clk_q
                # new segment launches from the register
        edges.append((prev, vid(("in", b.sink)), acc + tm.cb_in))
    n = len(verts)
    M = np.full((n, n), NEG, dtype=np.float32)
    for u, v, d in edges:
        M[v, u] = max(M[v, u], np.float32(d))
    return M, verts


def longest_path_maxplus(M: np.ndarray, src: int = 0) -> np.ndarray:
    """Reference max-plus longest-path (numpy); O(V^2 * diameter)."""
    NEG = np.float32(-1e9)
    n = M.shape[0]
    arr = np.full((n,), NEG, dtype=np.float32)
    arr[src] = 0.0
    for _ in range(n):
        nxt = np.maximum(arr, (M + arr[None, :]).max(axis=1))
        if np.allclose(nxt, arr):
            break
        arr = nxt
    return arr
