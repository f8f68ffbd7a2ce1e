"""Flush-signal handling (paper Section VI — hardware pipelining technique).

Statically-scheduled CGRAs synchronize every memory controller with a global
``flush`` broadcast at application start.  That signal has one source and as
many destinations as the application has stateful tiles; routed through the
configurable interconnect it becomes an unbreakable critical path (pipelining
it in software would need one matching register per destination — far beyond
the interconnect register budget).

``add_soft_flush``  models the baseline: a 1-bit broadcast net from a flush IO
                    to every stateful placeable node, routed on the
                    interconnect and visible to STA.
``harden_flush``    models the paper's hardware fix: the net is removed from
                    the interconnect and carried by a dedicated, per-column
                    registered distribution network that is never timing
                    critical (its pipeline depth is absorbed into the start-up
                    schedule, not the steady state).

Multi-app fabric sharing (:mod:`repro.core.multi`) extends Section VI's
observation: precisely *because* the flush has one source and fabric-wide
destinations, it is the natural shared resource when several applications
co-reside on one fabric.  :func:`shared_flush` models that sharing — one
``__flush__`` source fanning out to every resident's stateful sinks, with
the hardened distribution network amortized across residents (N separate
fabrics would each carry their own copy of the same fixed overlay).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

from .dfg import CONTROL_PORT, DFG, FIFO, INPUT, MEM, PE, RF
from .interconnect import Fabric, Tile, manhattan
from .timing_model import TimingModel

FLUSH = "__flush__"


def stateful_nodes(g) -> List[str]:
    """Stateful placeable nodes of a :class:`~repro.core.dfg.DFG` *or* a
    :class:`~repro.core.netlist.Netlist` (both expose ``.nodes`` as a
    name -> Node mapping): the flush broadcast's destinations."""
    out = []
    for n, nd in g.nodes.items():
        if nd.kind in (MEM, RF, FIFO):
            out.append(n)
        elif nd.kind == PE and (nd.input_reg or nd.latency > 0):
            out.append(n)
    return out


def _control_port(g: DFG, sink: str) -> int:
    """A side-band port for ``sink`` that can never collide with a data port.

    Ports at or above :data:`~repro.core.dfg.CONTROL_PORT` are control-only,
    so the allocation starts there; taking ``max(existing ports) + 1`` (not
    ``CONTROL_PORT + fan-in``) keeps it collision-free on nodes that already
    carry many inputs or other side-band nets, and stable no matter how many
    connects ran before this one.
    """
    ports = [e.port for e in g.in_edges(sink)]
    return max(ports + [CONTROL_PORT - 1]) + 1


def add_soft_flush(g: DFG) -> int:
    """Attach the software-routed flush broadcast; returns fanout."""
    if FLUSH in g.nodes:
        return g.fanout(FLUSH)
    targets = stateful_nodes(g)
    if not targets:
        return 0
    g.add(INPUT, name=FLUSH, width=1)
    for t in targets:
        g.connect(FLUSH, t, port=_control_port(g, t), width=1)
    return len(targets)


def remove_flush(g: DFG):
    """Hardened flush: drop the net from the interconnect model entirely."""
    if FLUSH not in g.nodes:
        return
    for e in list(g.edges):
        if e.src == FLUSH or e.dst == FLUSH:
            g.edges.remove(e)
    del g.nodes[FLUSH]


# ---------------------------------------------------------------------------
# shared flush across co-resident applications (multi-app fabric sharing)
# ---------------------------------------------------------------------------


def flush_network_registers(fabric: Fabric) -> int:
    """Register cost of the hardened flush distribution network.

    The hardened network is fixed hardware, sized for the worst case at
    fabric design time (any application may have a stateful tile anywhere):
    a root register at the global controller, a north-edge spine register
    per column, and a registered riser stage per tile row in every column.
    Its cost therefore depends only on fabric geometry — which is exactly
    what makes it amortizable: co-resident applications share one overlay,
    while N separate fabrics each pay for their own.
    """
    return 1 + fabric.cols + fabric.rows * fabric.cols


@dataclass
class SharedFlushReport:
    """One shared ``__flush__`` network spanning every resident app.

    ``registers`` / ``registers_separate`` quantify the hardened variant's
    amortization (shared overlay vs one overlay per resident on N separate
    fabrics); ``critical_ns`` is set only for the *soft* variant, where the
    flush is routed on the interconnect and its worst source-to-sink path —
    unbreakable, per Section VI — caps the whole fabric's frequency.
    """

    residents: int
    per_app: Dict[str, int]            # app name -> stateful sink count
    fanout: int                        # sum of per-app stateful sinks
    hardened: bool
    registers: int                     # shared hardened network (0 if soft)
    registers_separate: int            # N separate fabrics, one network each
    register_savings: int
    source: Tile
    critical_ns: Optional[float] = None
    sink_tiles: Dict[str, List[Tile]] = field(default_factory=dict)

    def summary(self) -> dict:
        return {
            "residents": self.residents,
            "flush_fanout": self.fanout,
            "hardened": self.hardened,
            "flush_registers": self.registers,
            "flush_registers_separate": self.registers_separate,
            "flush_register_savings": self.register_savings,
            "flush_critical_ns": (round(self.critical_ns, 3)
                                  if self.critical_ns is not None else None),
        }


def _soft_flush_critical_ns(sinks: Sequence[Tile], tm: TimingModel,
                            source: Tile) -> float:
    """Worst source -> sink path of an interconnect-routed shared flush.

    The soft broadcast cannot be pipelined (one matching register per
    destination, Section VI), so its delay is the full unregistered route:
    sequential overhead + connection box + one worst-case switch-box hop
    per Manhattan step.  A model, not a route — the point is the scaling
    (the path grows with fabric span and therefore with resident count).
    """
    hop_ns = max(v for k, v in tm.entries.items() if k.startswith("sb_"))
    worst = max(manhattan(source, t) for t in sinks)
    return tm.sequential_overhead() + tm.cb_in + worst * hop_ns


def shared_flush(sinks_by_app: Mapping[str, Sequence[Tile]], fabric: Fabric,
                 tm: Optional[TimingModel] = None, harden: bool = True,
                 source: Optional[Tile] = None) -> SharedFlushReport:
    """Build the shared-flush report for a pack of co-resident apps.

    ``sinks_by_app`` maps each resident to the tiles of its stateful
    placeable nodes (the flush destinations).  One ``__flush__`` source —
    by default the north-edge IO tile nearest the centroid of all sinks —
    serves every resident.  ``harden`` selects the paper's hardened
    distribution network (register cost amortized across residents, never
    timing critical) vs the soft interconnect-routed broadcast (zero
    dedicated registers, but ``critical_ns`` caps the fabric frequency).
    """
    per_app = {name: len(tiles) for name, tiles in sinks_by_app.items()}
    all_sinks = [t for tiles in sinks_by_app.values() for t in tiles]
    if source is None:
        if all_sinks:
            mean_col = sum(c for _, c in all_sinks) / len(all_sinks)
            col = min(range(fabric.cols), key=lambda c: abs(c - mean_col))
        else:
            col = 0
        source = (-1, col)
    n = len(sinks_by_app)
    if harden:
        regs = flush_network_registers(fabric)
        separate = n * regs
        critical = None
    else:
        regs, separate = 0, 0
        critical = (_soft_flush_critical_ns(all_sinks, tm, source)
                    if tm is not None and all_sinks else None)
    return SharedFlushReport(
        residents=n, per_app=per_app, fanout=sum(per_app.values()),
        hardened=harden, registers=regs, registers_separate=separate,
        register_savings=separate - regs, source=source,
        critical_ns=critical,
        sink_tiles={k: list(v) for k, v in sinks_by_app.items()})
