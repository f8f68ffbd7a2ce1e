"""Branch delay matching (paper Section III-B).

When pipelining registers are added to an application DAG, every multi-input
functional element must see all of its operands arrive on the same cycle.
The matching algorithm is STA run in the *cycle* domain: walk the graph in
topological order computing per-node arrival cycles, and wherever a node has
more than one unique input arrival time, insert registers (FIFOs for sparse
designs) on the early branches.

Two views are supported:

``match_dfg``      operates on a DFG (used by the pre-PnR graph passes:
                   compute pipelining, broadcast pipelining).
``match_netlist``  operates on a Netlist's branch ``n_regs`` counts (used by
                   post-PnR pipelining, where the registers live at concrete
                   switch-box sites along routes).

Edges driven by CONST nodes are time-invariant and never need matching.

Predicated regions need no special casing here by construction:
predicate edges live in the ``[PRED_PORT, CONTROL_PORT)`` band, *below*
the control cutoff, so they are ordinary data to the matcher — both arms
of a predicated region **and** the predicate itself are register-balanced
before the merge point (``phi``/``sel`` PE or predicated MEM accumulator)
exactly like any multi-input operand set.  Only the ``>= CONTROL_PORT``
side-band (flush) is skipped.  :func:`check_predicated_regions` verifies
that invariant per merge point with a targeted diagnostic.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from .dfg import (CONST, CONTROL_PORT, DFG, FIFO, INPUT, MEM, PE, PRED_OPS,
                  PRED_PORT, REG)
from .netlist import Branch, Netlist


def _data_in_edges(g: DFG, name: str):
    return [e for e in g.in_edges(name)
            if e.port < CONTROL_PORT and g.nodes[e.src].kind != CONST]


def arrival_cycles_dfg(g: DFG, domain: str = "pipeline") -> Dict[str, int]:
    arr: Dict[str, int] = {}
    for name in g.topo_order():
        node = g.nodes[name]
        preds = [e.src for e in _data_in_edges(g, name)]
        base = max((arr[p] for p in preds), default=0)
        lat = (node.pipeline_latency() if domain == "pipeline"
               else node.cycle_latency())
        arr[name] = base + lat
    return arr


def match_dfg(g: DFG, use_fifos: Optional[bool] = None) -> int:
    """Insert matching registers in-place; returns #registers inserted.

    Processes nodes in topological order so one pass suffices: by the time a
    node is visited, all upstream arrival times are final.
    """
    use_fifos = g.sparse if use_fifos is None else use_fifos
    kind = FIFO if use_fifos else REG
    inserted = 0
    arr: Dict[str, int] = {}
    for name in g.topo_order():
        node = g.nodes[name]
        in_edges = _data_in_edges(g, name)
        if in_edges:
            arrivals = [arr[e.src] for e in in_edges]
            target = max(arrivals)
            for e, a in zip(list(in_edges), arrivals):
                need = target - a
                for _ in range(need):
                    mid = g.split_edge(e, kind,
                                       depth=2 if use_fifos else 1)
                    g.nodes[mid].meta["pipelining"] = True
                    # the chain grows from src side; next insertion goes on
                    # the edge between the new node and the sink
                    e = [ee for ee in g.in_edges(name) if ee.src == mid][0]
                    arr[mid] = a + 1
                    a += 1
                    inserted += 1
            arr_in = target
        else:
            arr_in = 0
        arr[name] = arr_in + node.pipeline_latency()
    return inserted


def check_matched_dfg(g: DFG) -> bool:
    """True iff every multi-input node sees equal input arrival cycles."""
    arr = arrival_cycles_dfg(g)
    for name in g.nodes:
        arrivals = {arr[e.src] for e in _data_in_edges(g, name)}
        if len(arrivals) > 1:
            return False
    return True


def predicated_merge_nodes(g: DFG) -> List[str]:
    """Nodes where predicated control flow reconverges: ``phi``/``sel``
    merge PEs and MEM accumulators with a predicate edge."""
    out = []
    for name, node in g.nodes.items():
        if node.kind == PE and node.op in PRED_OPS:
            out.append(name)
        elif node.kind == MEM and node.op == "accum" and any(
                PRED_PORT <= e.port < CONTROL_PORT
                for e in g.in_edges(name)):
            out.append(name)
    return out


def check_predicated_regions(g: DFG) -> List[str]:
    """Per-merge-point delay-matching diagnostics for predicated regions.

    Returns one message per merge node (``phi``/``sel``/``steer`` PE or
    predicated accumulator) whose arms or predicate arrive on different
    cycles — empty list means every predicated region is balanced.  This
    is :func:`check_matched_dfg` restricted to the reconvergence points,
    with the offending arm named so a matching bug points at the edge.
    """
    arr = arrival_cycles_dfg(g)
    problems = []
    for name in predicated_merge_nodes(g):
        edges = _data_in_edges(g, name)
        arrivals = {arr[e.src] for e in edges}
        if len(arrivals) > 1:
            detail = ", ".join(
                f"{'pred' if e.port >= PRED_PORT else f'arm p{e.port}'}"
                f"<-{e.src}@{arr[e.src]}" for e in edges)
            problems.append(f"{g.name}: merge {name} unbalanced: {detail}")
    return problems


def match_netlist(nl: Netlist) -> int:
    """Cycle-match by incrementing branch ``n_regs``; returns #regs added.

    Sparse netlists self-synchronize through ready-valid FIFOs, so matching
    is a rate optimization there rather than a correctness requirement — the
    same counts are used either way (paper Section VII).
    """
    into: Dict[str, List[Branch]] = {n: [] for n in nl.nodes}
    for b in nl.branches:
        if not b.control:
            into[b.sink].append(b)
    arr: Dict[str, int] = {}
    added = 0
    # topological order
    indeg = {n: 0 for n in nl.nodes}
    adj: Dict[str, List[str]] = {n: [] for n in nl.nodes}
    for b in nl.branches:
        indeg[b.sink] += 1
        adj[b.driver].append(b.sink)
    stack = sorted(n for n, d in indeg.items() if d == 0)
    order: List[str] = []
    while stack:
        n = stack.pop()
        order.append(n)
        for m in adj[n]:
            indeg[m] -= 1
            if indeg[m] == 0:
                stack.append(m)
    for name in order:
        node = nl.nodes[name]
        ins = into[name]
        if ins:
            arrivals = [arr[b.driver] + b.n_regs for b in ins]
            target = max(arrivals)
            for b, a in zip(ins, arrivals):
                if a < target:
                    b.n_regs += target - a
                    added += target - a
            arr_in = target
        else:
            arr_in = 0
        arr[name] = arr_in + node.pipeline_latency()

    # control broadcasts (flush) must hit every destination on the same
    # cycle: registering one branch forces a register onto *all* branches of
    # the same net (paper Section VI — this is what makes the software
    # approach so register-hungry).
    by_ctrl_driver: Dict[str, List[Branch]] = {}
    for b in nl.branches:
        if b.control:
            by_ctrl_driver.setdefault(b.driver, []).append(b)
    for branches in by_ctrl_driver.values():
        target = max(b.n_regs for b in branches)
        for b in branches:
            added += target - b.n_regs
            b.n_regs = target
    return added


class MatchPlan:
    """:func:`match_netlist` split into invariant structure + arithmetic.

    The post-PnR pipelining loop re-matches the netlist once per round, but
    between rounds only branch ``n_regs`` counts change — the node set,
    branch topology, and per-node pipeline latencies are frozen the moment
    the design is routed.  This plan captures that invariant part once
    (topo order, per-node in-branch lists, latencies, control-broadcast
    groups); :meth:`run` then performs only the count arithmetic, in the
    exact iteration order of :func:`match_netlist`, so the two are
    byte-identical on any netlist the plan was built from.
    """

    def __init__(self, nl: Netlist):
        into: Dict[str, List[Branch]] = {n: [] for n in nl.nodes}
        for b in nl.branches:
            if not b.control:
                into[b.sink].append(b)
        indeg = {n: 0 for n in nl.nodes}
        adj: Dict[str, List[str]] = {n: [] for n in nl.nodes}
        for b in nl.branches:
            indeg[b.sink] += 1
            adj[b.driver].append(b.sink)
        stack = sorted(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while stack:
            n = stack.pop()
            order.append(n)
            for m in adj[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    stack.append(m)
        pos = {name: i for i, name in enumerate(order)}
        #: (node position, [(driver position, branch)], latency), topo order
        self.steps: List[Tuple[int, List[Tuple[int, Branch]], int]] = [
            (pos[name], [(pos[b.driver], b) for b in into[name]],
             nl.nodes[name].pipeline_latency())
            for name in order]
        by_ctrl_driver: Dict[str, List[Branch]] = {}
        for b in nl.branches:
            if b.control:
                by_ctrl_driver.setdefault(b.driver, []).append(b)
        self.ctrl_groups: List[List[Branch]] = list(by_ctrl_driver.values())
        self._arr = [0] * len(order)      # scratch; overwritten every run

    def run(self) -> int:
        """Re-match in place; returns #regs added.  Branch objects are held
        by reference, so current ``n_regs`` counts are always read fresh."""
        arr = self._arr
        added = 0
        for p, ins, lat in self.steps:
            if ins:
                arrivals = [arr[dp] + b.n_regs for dp, b in ins]
                target = max(arrivals)
                if min(arrivals) != target:
                    for (dp, b), a in zip(ins, arrivals):
                        if a < target:
                            b.n_regs += target - a
                            added += target - a
                arr[p] = target + lat
            else:
                arr[p] = lat
        for branches in self.ctrl_groups:
            target = max(b.n_regs for b in branches)
            for b in branches:
                added += target - b.n_regs
                b.n_regs = target
        return added


def check_matched_netlist(nl: Netlist) -> bool:
    arr = nl.arrival_cycles(domain="pipeline")
    into: Dict[str, Set[int]] = {}
    for b in nl.branches:
        if not b.control:
            into.setdefault(b.sink, set()).add(arr[b.driver] + b.n_regs)
    return all(len(s) <= 1 for s in into.values())
