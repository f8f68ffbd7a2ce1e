"""Dataflow-graph IR for CGRA applications.

This is the representation that flows through the whole Cascade pipeline
(Fig. 2 of the paper): application DAGs of primitive operations are mapped to
DAGs of PE / MEM nodes, pipelined (REG / RF / FIFO insertion), placed, routed
and statically scheduled.

Nodes
-----
INPUT / OUTPUT   array-edge IO tiles (streaming interface to the global buffer)
PE               a processing-element op (alu ops, mul, mux, ...)
MEM              a memory-tile op (linebuffer / rom / accumulator / sram)
REG              a pipelining register (interconnect or PE input register)
RF               a register file configured as a variable-length shift register
FIFO             a ready-valid FIFO (sparse applications)
CONST            a compile-time constant

Edges carry a bit ``width`` (16 for data, 1 for control/valid) and land on a
named ``port`` of the destination so non-commutative ops simulate correctly.

Port bands
----------
The destination ``port`` number selects one of three bands, each with its
own contract:

``data``       ports ``< PRED_PORT`` (0..79).  Ordinary 16-bit operands;
               counted against the op's arity, simulated positionally,
               register-balanced by branch-delay matching.
``predicate``  ports in ``[PRED_PORT, CONTROL_PORT)`` (80..89).  A single
               1-bit predicate that gates the consuming node (``steer`` /
               ``sel`` / ``phi`` PEs, predicated MEM accumulators).
               Predicate edges are real dataflow: they are routed, timed
               and delay-matched exactly like data — the simulator just
               resolves them separately from the positional operands.
``control``    ports ``>= CONTROL_PORT`` (90+).  Side-band control such as
               the global flush broadcast: routed and timed like any net
               but carrying no dataflow — the functional simulator and
               branch-delay matching skip them.  ``DFG.validate()``
               rejects data (width > 1) edges landing in this band.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# node / edge definitions
# ---------------------------------------------------------------------------

INPUT, OUTPUT, PE, MEM, REG, RF, FIFO, CONST = (
    "input", "output", "pe", "mem", "reg", "rf", "fifo", "const",
)

KINDS = {INPUT, OUTPUT, PE, MEM, REG, RF, FIFO, CONST}

# edges landing on ports >= CONTROL_PORT are side-band control (e.g. the
# global flush broadcast): they route and are timed like any net, but carry
# no dataflow — the functional simulator and branch-delay matching skip them.
CONTROL_PORT = 90

# edges landing on ports in [PRED_PORT, CONTROL_PORT) carry the consuming
# node's 1-bit predicate.  Unlike the control side-band they ARE dataflow —
# routed, timed and branch-delay-matched like any operand — but the
# simulators resolve them separately from the positional data arguments
# (see the module docstring's port-band table).
PRED_PORT = 80

# kinds that terminate / originate combinational timing paths (sequential).
SEQUENTIAL_KINDS = {REG, RF, FIFO, INPUT, OUTPUT, MEM}

# PE op -> python semantics for the functional simulator.
PE_OPS: Dict[str, Callable[..., int]] = {
    "add": lambda a, b: (a + b) & 0xFFFF,
    "sub": lambda a, b: (a - b) & 0xFFFF,
    "mul": lambda a, b: (a * b) & 0xFFFF,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
    "shr": lambda a, b: (a >> (b & 0xF)) & 0xFFFF,
    "shl": lambda a, b: (a << (b & 0xF)) & 0xFFFF,
    "min": lambda a, b: min(a, b),
    "max": lambda a, b: max(a, b),
    "abs": lambda a: a if a < 0x8000 else ((-a) & 0xFFFF),
    "gt": lambda a, b: int(a > b),
    "lt": lambda a, b: int(a < b),
    "eq": lambda a, b: int(a == b),
    "ne": lambda a, b: int(a != b),
    "ge": lambda a, b: int(a >= b),
    "le": lambda a, b: int(a <= b),
    "mux": lambda s, a, b: a if (s & 1) else b,
    "pass": lambda a: a,
    # predicated ops: the predicate (1-bit, from the PRED_PORT band) is the
    # last positional argument after the data operands.
    "steer": lambda a, p: a if (p & 1) else 0,
    "sel": lambda a, b, p: a if (p & 1) else b,
    "phi": lambda a, b, p: a if (p & 1) else b,
}

# data-operand arity: in-edges on ports < PRED_PORT (predicate edges are
# counted separately — see PRED_OPS / validate()).
PE_ARITY = {"abs": 1, "pass": 1, "mux": 3, "steer": 1, "sel": 2, "phi": 2}

# PE ops that take (and require) exactly one predicate edge.  ``sel``
# chooses between two live values (partial predication); ``phi`` is the
# same hardware op but marks a control-flow merge point where exactly one
# arm is semantically live — branch-delay matching balances both arms plus
# the predicate before the merge.  ``steer`` gates a single value to 0.
PRED_OPS = frozenset({"steer", "sel", "phi"})

#: comparator ops — 1-bit producers over the unsigned 16-bit domain,
#: natural predicate drivers.
CMP_OPS = frozenset({"gt", "lt", "eq", "ne", "ge", "le"})


@dataclass
class Node:
    name: str
    kind: str
    op: str = ""                    # PE op or MEM behaviour ("linebuffer", "rom", ...)
    width: int = 16                 # output bit width
    latency: int = 0                # cycles to produce output (0 = combinational)
    input_reg: bool = False         # PE input registers enabled (compute pipelining)
    depth: int = 1                  # RF shift length / FIFO depth / MEM delay
    value: int = 0                  # CONST value
    meta: dict = field(default_factory=dict)

    def cycle_latency(self) -> int:
        """Full cycles from input arrival to output (functional simulation
        truth: includes both functional delays and pipelining registers)."""
        if self.kind == REG:
            return 1
        if self.kind == RF:
            return self.depth
        if self.kind == FIFO:
            return 1  # minimum transit; actual occupancy is dynamic
        if self.kind == MEM:
            return max(1, self.depth) if self.op == "delay" else max(1, self.latency)
        if self.kind == PE:
            return self.latency + (1 if self.input_reg else 0)
        return self.latency

    def pipeline_latency(self) -> int:
        """Cycles contributed by *pipelining* only (branch-delay matching
        domain).  Functional delays — line buffers, window-tap shift
        registers, ROM/accumulator latency — are part of the application's
        static schedule and already correct; matching must balance only the
        delays that pipelining passes introduce (paper Section III-B)."""
        if self.kind == REG:
            return 1
        if self.kind == FIFO:
            return 1
        if self.kind == RF:
            return self.depth if self.meta.get("pipelining") else 0
        if self.kind == PE:
            return 1 if self.input_reg else 0
        return 0

    def is_sequential(self) -> bool:
        if self.kind == PE:
            return self.input_reg or self.latency > 0
        return self.kind in SEQUENTIAL_KINDS


@dataclass(frozen=True)
class Edge:
    src: str
    dst: str
    port: int = 0
    width: int = 16


class DFG:
    """A directed acyclic dataflow graph."""

    def __init__(self, name: str = "app", sparse: bool = False):
        self.name = name
        self.sparse = sparse
        self.nodes: Dict[str, Node] = {}
        self.edges: List[Edge] = []
        self._uid = itertools.count()

    # -- construction -------------------------------------------------------
    def add(self, kind: str, name: Optional[str] = None, **kw) -> str:
        if kind not in KINDS:
            raise ValueError(f"unknown node kind {kind!r}")
        if name is None:
            name = f"{kind}{next(self._uid)}"
        if name in self.nodes:
            raise ValueError(f"duplicate node {name!r}")
        self.nodes[name] = Node(name=name, kind=kind, **kw)
        return name

    def connect(self, src: str, dst: str, port: int = 0, width: Optional[int] = None):
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError(f"edge {src}->{dst} references unknown node")
        if width is None:
            # predicate/control side-bands are 1-bit by contract
            w = 1 if port >= PRED_PORT else self.nodes[src].width
        else:
            w = width
        self.edges.append(Edge(src, dst, port, w))

    # -- queries -------------------------------------------------------------
    def in_edges(self, name: str) -> List[Edge]:
        return [e for e in self.edges if e.dst == name]

    def out_edges(self, name: str) -> List[Edge]:
        return [e for e in self.edges if e.src == name]

    def fanout(self, name: str) -> int:
        return len(self.out_edges(name))

    def preds(self, name: str) -> List[str]:
        return [e.src for e in self.in_edges(name)]

    def succs(self, name: str) -> List[str]:
        return [e.dst for e in self.out_edges(name)]

    def topo_order(self) -> List[str]:
        indeg = {n: 0 for n in self.nodes}
        adj: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for e in self.edges:
            indeg[e.dst] += 1
            adj[e.src].append(e.dst)
        stack = sorted(n for n, d in indeg.items() if d == 0)
        order: List[str] = []
        while stack:
            n = stack.pop()
            order.append(n)
            for m in adj[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    stack.append(m)
        if len(order) != len(self.nodes):
            raise ValueError(f"{self.name}: graph has a cycle "
                             f"({len(order)}/{len(self.nodes)} ordered)")
        return order

    def validate(self):
        self.topo_order()
        for e in self.edges:
            if e.port >= CONTROL_PORT and e.width > 1:
                raise ValueError(
                    f"{self.name}: edge {e.src}->{e.dst} lands a "
                    f"width-{e.width} data edge on control port {e.port} "
                    f"(ports >= {CONTROL_PORT} are the 1-bit side-band)")
            if PRED_PORT <= e.port < CONTROL_PORT and e.width != 1:
                raise ValueError(
                    f"{self.name}: predicate edge {e.src}->{e.dst} on port "
                    f"{e.port} must be 1 bit wide, got {e.width}")
        for n in self.nodes.values():
            preds = [e for e in self.in_edges(n.name)
                     if PRED_PORT <= e.port < CONTROL_PORT]
            if len(preds) > 1:
                raise ValueError(
                    f"{self.name}: {n.name} has {len(preds)} predicate "
                    f"edges; at most one is allowed")
            if preds and not (
                    (n.kind == PE and n.op in PRED_OPS)
                    or (n.kind == MEM and n.op == "accum")):
                raise ValueError(
                    f"{self.name}: {n.kind} {n.name} (op={n.op!r}) cannot "
                    f"take a predicate edge; only "
                    f"{'/'.join(sorted(PRED_OPS))} PEs and MEM "
                    f"accumulators are predicated")
            if n.kind == PE and n.op:
                arity = PE_ARITY.get(n.op, 2)
                got = len([e for e in self.in_edges(n.name)
                           if e.port < PRED_PORT])
                if got != arity:
                    raise ValueError(
                        f"{self.name}: PE {n.name} op={n.op} wants {arity} "
                        f"inputs, has {got}")
                if n.op in PRED_OPS and not preds:
                    raise ValueError(
                        f"{self.name}: PE {n.name} op={n.op} requires a "
                        f"predicate edge on a port in "
                        f"[{PRED_PORT}, {CONTROL_PORT})")
        return self

    # -- surgery (used by the pipelining passes) ------------------------------
    def split_edge(self, edge: Edge, kind: str = REG, **kw) -> str:
        """Insert a node of ``kind`` on ``edge``; returns the new node name."""
        self.edges.remove(edge)
        mid = self.add(kind, width=edge.width, **kw)
        self.edges.append(Edge(edge.src, mid, 0, edge.width))
        self.edges.append(Edge(mid, edge.dst, edge.port, edge.width))
        return mid

    def remove_node(self, name: str):
        """Remove a single-in single-out node, splicing its edges together."""
        ins, outs = self.in_edges(name), self.out_edges(name)
        if len(ins) != 1:
            raise ValueError(f"cannot splice {name}: {len(ins)} inputs")
        for e in ins + outs:
            self.edges.remove(e)
        for o in outs:
            self.edges.append(Edge(ins[0].src, o.dst, o.port, o.width))
        del self.nodes[name]

    def copy(self) -> "DFG":
        g = DFG(self.name, self.sparse)
        g.nodes = {k: replace(v, meta=dict(v.meta)) for k, v in self.nodes.items()}
        g.edges = list(self.edges)
        g._uid = itertools.count(max(
            (int("".join(filter(str.isdigit, n)) or 0) for n in self.nodes), default=0) + 1)
        return g

    # -- statistics -----------------------------------------------------------
    def count(self, kind: str) -> int:
        return sum(1 for n in self.nodes.values() if n.kind == kind)

    def register_count(self) -> int:
        """Total pipelining registers, counting RF shift length and PE input regs."""
        total = 0
        for n in self.nodes.values():
            if n.kind == REG:
                total += 1
            elif n.kind == RF:
                total += n.depth
            elif n.kind == PE and n.input_reg:
                total += len(self.in_edges(n.name))
        return total

    def stats(self) -> dict:
        return {
            "nodes": len(self.nodes),
            "edges": len(self.edges),
            "pe": self.count(PE),
            "mem": self.count(MEM),
            "reg": self.count(REG),
            "rf": self.count(RF),
            "fifo": self.count(FIFO),
            "registers_total": self.register_count(),
        }

    def __repr__(self):
        s = self.stats()
        return (f"DFG({self.name!r}, nodes={s['nodes']}, pe={s['pe']}, "
                f"mem={s['mem']}, regs={s['registers_total']}, sparse={self.sparse})")
