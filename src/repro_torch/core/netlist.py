"""PnR netlist view of a DFG.

Placement and routing operate on *placeable* nodes (PE / MEM / RF / FIFO / IO).
Pipelining REG nodes do not occupy tiles — in hardware they are switch-box
registers along a route — so a chain of k REG nodes between two placeable
nodes collapses to a branch annotated ``n_regs = k``; the router assigns those
registers to concrete hop sites.  CONST nodes fold into the consuming PE's
configuration: they neither place nor route (kept only so the netlist can be
re-materialized as a DFG for functional verification).

After PnR the netlist is the single source of truth: post-PnR pipelining
increments ``n_regs`` on branches, and ``to_dfg()`` rebuilds an equivalent
dataflow graph (REG chains — or FIFOs for sparse designs — re-materialized)
for the cycle-accurate functional equivalence check against the original app.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Set, Tuple

from .dfg import (CONST, CONTROL_PORT, DFG, FIFO, INPUT, MEM, OUTPUT,
                  PE, REG, RF, Node)
from .interconnect import Fabric, Hop, Tile

PLACEABLE = {PE, MEM, RF, FIFO, INPUT, OUTPUT}


@dataclass
class Branch:
    """One driver -> sink connection (a leaf of a routing tree)."""
    driver: str
    sink: str
    port: int
    width: int
    n_regs: int = 0          # pipeline registers (or FIFOs) along this branch
    n_regs_init: int = 0     # as extracted from the DFG (pre-post-PnR)
    control: bool = False    # side-band net (flush): routed & timed, no data

    @property
    def key(self) -> Tuple[str, str, int]:
        return (self.driver, self.sink, self.port)


@dataclass
class Netlist:
    nodes: Dict[str, Node]                       # placeable nodes
    branches: List[Branch]
    consts: List[Tuple[str, str, int]] = field(default_factory=list)  # (const, sink, port)
    const_nodes: Dict[str, Node] = field(default_factory=dict)
    sparse: bool = False
    name: str = "app"

    def branches_into(self, sink: str) -> List[Branch]:
        return [b for b in self.branches if b.sink == sink]

    def added_registers(self) -> int:
        """Registers inserted after extraction (post-PnR pipelining)."""
        return sum(b.n_regs - b.n_regs_init for b in self.branches)

    # -- cycle-domain arrival over branches (see branch_delay.py for matching)
    def arrival_cycles(self, domain: str = "full") -> Dict[str, int]:
        """Per-node arrival cycle.  ``domain='full'`` counts functional +
        pipelining latency (schedule/runtime truth); ``'pipeline'`` counts
        only pipelining-induced delay (the matching domain)."""
        order = _topo(self)
        arr: Dict[str, int] = {}
        into: Dict[str, List[Branch]] = {n: [] for n in self.nodes}
        for b in self.branches:
            if not b.control:
                into[b.sink].append(b)
        for n in order:
            node = self.nodes[n]
            lat = (node.cycle_latency() if domain == "full"
                   else node.pipeline_latency())
            base = max((arr[b.driver] + b.n_regs for b in into[n]), default=0)
            arr[n] = base + lat
        return arr

    def to_dfg(self) -> DFG:
        """Re-materialize as a DFG (REG/FIFO chains expanded per branch)."""
        g = DFG(self.name, sparse=self.sparse)
        for n, nd in {**self.nodes, **self.const_nodes}.items():
            g.nodes[n] = replace(nd, meta=dict(nd.meta))
        for cname, sink, port in self.consts:
            g.connect(cname, sink, port)
        kind = FIFO if self.sparse else REG
        for b in self.branches:
            if b.control:
                g.connect(b.driver, b.sink, b.port, width=b.width)
                continue
            prev = b.driver
            for i in range(b.n_regs):
                r = g.add(kind, name=f"__bd_{b.driver}_{b.sink}_{b.port}_{i}",
                          width=b.width, depth=2 if self.sparse else 1)
                g.connect(prev, r, 0, width=b.width)
                prev = r
            g.connect(prev, b.sink, b.port, width=b.width)
        return g


def _topo(nl: Netlist) -> List[str]:
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
    if len(order) != len(nl.nodes):
        raise ValueError(f"{nl.name}: netlist has a cycle")
    return order


def extract_netlist(g: DFG) -> Netlist:
    """Collapse REG/FIFO chains onto branches; fold CONSTs out of the netlist.

    REG nodes with fanout > 1 (broadcast trees) contribute one cycle to every
    branch traced through them; the physical sharing of the tree trunk is
    recovered by ``RoutedDesign.hop_usage`` and the DFG-level register count.
    """
    nodes = {n: replace(nd, meta=dict(nd.meta))
             for n, nd in g.nodes.items() if nd.kind in PLACEABLE}
    branches: List[Branch] = []
    consts: List[Tuple[str, str, int]] = []
    const_nodes = {n: replace(nd) for n, nd in g.nodes.items() if nd.kind == CONST}
    for name, nd in g.nodes.items():
        if nd.kind not in PLACEABLE:
            continue
        for e in g.in_edges(name):
            n_regs = 0
            src = e.src
            while g.nodes[src].kind in (REG,) or (
                    g.sparse and g.nodes[src].kind == FIFO
                    and g.nodes[src].meta.get("pipelining", False)):
                n_regs += 1
                ins = g.in_edges(src)
                if len(ins) != 1:
                    raise ValueError(f"pipelining node {src} must have 1 input")
                src = ins[0].src
            if g.nodes[src].kind == CONST:
                consts.append((src, name, e.port))
                continue
            if g.nodes[src].kind not in PLACEABLE:
                raise ValueError(f"branch into {name} reaches non-placeable {src}")
            branches.append(Branch(src, name, e.port, e.width, n_regs, n_regs,
                                   control=e.port >= CONTROL_PORT))
    return Netlist(nodes=nodes, branches=branches, consts=consts,
                   const_nodes=const_nodes, sparse=g.sparse, name=g.name)


@dataclass
class RoutedBranch:
    """A concrete driver->sink path: consecutive tile hops + register sites."""
    branch: Branch
    hops: List[Hop]
    reg_hops: Set[int] = field(default_factory=set)   # indices into ``hops``

    @property
    def n_hops(self) -> int:
        return len(self.hops)

    def distribute_registers(self):
        """Spread ``branch.n_regs`` registers evenly along the hops (the
        router's default register-placement policy; post-PnR pipelining then
        moves/adds registers at specific sites)."""
        self.reg_hops.clear()
        k = self.branch.n_regs
        if k <= 0 or not self.hops:
            return
        k = min(k, len(self.hops))
        step = len(self.hops) / (k + 1)
        out: Set[int] = set()
        for i in range(k):
            idx = min(len(self.hops) - 1, int(round(step * (i + 1))))
            while idx in out and idx < len(self.hops) - 1:
                idx += 1
            out.add(idx)
        self.reg_hops = out


@dataclass
class RoutedDesign:
    netlist: Netlist
    placement: Dict[str, Tile]
    routes: Dict[Tuple[str, str, int], RoutedBranch]
    fabric: Fabric
    unroll_copies: int = 1           # low-unrolling duplication factor
    source_dfg: Optional[DFG] = None # pre-extraction DFG (physical reg count)
    #: lazy ``(driver, sink) -> branch key`` index (see
    #: :meth:`branch_key_between`); never part of equality/serialization
    #: semantics — it is derivable from ``routes`` at any time.
    _pair_index: Optional[Dict[Tuple[str, str], Tuple[str, str, int]]] = \
        field(default=None, repr=False, compare=False)

    @property
    def dfg(self) -> DFG:
        return self.netlist.to_dfg()

    def branch_key_between(self, driver: str, sink: str
                           ) -> Optional[Tuple[str, str, int]]:
        """The first route key connecting ``driver`` to ``sink`` (the
        lowest-port branch, matching a linear scan over ``routes``), or
        ``None``.

        Post-PnR pipelining asks this for every consecutive node pair of
        every round's critical path; the O(routes) scan it used to do per
        query is replaced by an index built lazily on first use and never
        invalidated — the route *set* is immutable once the design is
        routed (pipelining only mutates register sites along existing
        routes).  A regression test pins index-vs-scan agreement.
        """
        idx = self._pair_index
        if idx is None:
            idx = {}
            for key in self.routes:
                idx.setdefault((key[0], key[1]), key)
            self._pair_index = idx
        return idx.get((driver, sink))

    def hop_usage(self) -> Dict[Tuple[Tile, Tile, int], int]:
        """Track demand per directed tile boundary, deduplicating the shared
        trunk of each driver's routing tree."""
        usage: Dict[Tuple[Tile, Tile, int], int] = {}
        seen: Dict[str, Set[Tuple[Tile, Tile]]] = {}
        for rb in self.routes.values():
            s = seen.setdefault(rb.branch.driver, set())
            for h in rb.hops:
                key = (h.src, h.dst)
                if key in s:
                    continue
                s.add(key)
                k2 = (h.src, h.dst, 16 if rb.branch.width >= 16 else 1)
                usage[k2] = usage.get(k2, 0) + 1
        return usage

    def total_wirelength(self) -> int:
        return sum(self.hop_usage().values())

    def physical_register_count(self) -> int:
        base = (self.source_dfg.register_count()
                if self.source_dfg is not None else
                sum(b.n_regs_init for b in self.netlist.branches))
        return base + self.netlist.added_registers()


def design_digest(design: RoutedDesign) -> str:
    """SHA-256 of a routed design's placement, routes and branches: equal
    digests mean byte-identical PnR. The same digest as the reference's
    straight-line pins (tests/test_predication.py)."""
    h = hashlib.sha256()
    for name in sorted(design.placement):
        h.update(f"P {name} {design.placement[name]}\n".encode())
    for key in sorted(design.routes, key=repr):
        rb = design.routes[key]
        h.update(f"R {key} {rb.hops} {sorted(rb.reg_hops)}\n".encode())
    for b in sorted(design.netlist.branches, key=lambda b: repr(b.key)):
        h.update(f"B {b.key} {b.n_regs} {b.width} {b.control}\n".encode())
    return h.hexdigest()
