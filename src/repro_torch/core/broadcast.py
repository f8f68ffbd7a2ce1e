"""Broadcast signal pipelining (paper Section V-B).

Nets with one source and many destinations route inefficiently on the CGRA
and dominate the post-compute-pipelining critical path.  This pass pipelines
high-fanout nets with a balanced register *tree*, bounding the wirelength any
single combinational segment has to cover.  The trade-off between register
count and critical path (tree arity / number of levels) is exposed as pass
parameters.
"""

from __future__ import annotations

import math
from typing import Dict, List

from .branch_delay import match_dfg
from .dfg import CONST, DFG, FIFO, INPUT, OUTPUT, REG


def broadcast_pipelining(g: DFG, fanout_threshold: int = 4,
                         arity: int = 4, max_levels: int = 4) -> Dict[str, int]:
    """Insert register trees under every node with fanout > threshold.

    Returns stats; re-runs branch delay matching afterwards so sibling paths
    stay aligned.  Sparse graphs use FIFOs (Section VII).
    """
    kind = FIFO if g.sparse else REG
    trees = 0
    regs = 0
    # snapshot: we mutate fanout as we go
    drivers = [n for n, nd in g.nodes.items()
               if nd.kind not in (CONST, OUTPUT)
               and g.fanout(n) > fanout_threshold]
    for drv in drivers:
        outs = list(g.out_edges(drv))
        if len(outs) <= fanout_threshold:
            continue
        level = 0
        edges = outs
        while len(edges) > fanout_threshold and level < max_levels:
            groups = [edges[i:i + arity] for i in range(0, len(edges), arity)]
            new_edges = []
            for grp in groups:
                r = g.add(kind, width=grp[0].width,
                          depth=2 if g.sparse else 1)
                g.nodes[r].meta["pipelining"] = True
                g.nodes[r].meta["broadcast_tree"] = True
                regs += 1
                for e in grp:
                    g.edges.remove(e)
                    g.connect(r, e.dst, e.port, width=e.width)
                g.connect(drv, r, 0, width=grp[0].width)
                # the drv->r edge becomes a candidate for the next level
                new_edges.append(g.out_edges(drv)[-1])
            edges = new_edges
            level += 1
        if level:
            trees += 1
    matched = match_dfg(g) if trees else 0
    return {"trees": trees, "tree_regs": regs, "matching_regs": matched}
