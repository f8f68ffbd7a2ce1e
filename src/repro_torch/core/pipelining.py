"""Compute pipelining (paper Section V-A).

1. Enable the configurable registers at the inputs of every PE, then run
   branch delay matching so compute kernels keep their functionality (Fig. 4
   left).
2. Collapse long chains of matching registers into a register file configured
   as a variable-length shift register (Fig. 4 right) — register files live in
   PE tiles, freeing scarce interconnect registers.  Applied to every chain of
   >= ``rf_threshold`` registers (the paper's hyperparameter N).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .branch_delay import match_dfg
from .dfg import DFG, PE, REG, RF


def enable_pe_input_registers(g: DFG) -> int:
    n = 0
    for node in g.nodes.values():
        if node.kind == PE and not node.input_reg:
            node.input_reg = True
            n += 1
    return n


def find_reg_chains(g: DFG) -> List[List[str]]:
    """Maximal linear chains of REG nodes (every interior node fanout 1)."""
    chains: List[List[str]] = []
    visited = set()
    for name, node in g.nodes.items():
        if node.kind != REG or name in visited:
            continue
        preds = g.preds(name)
        pred_is_chain = (len(preds) == 1 and g.nodes[preds[0]].kind == REG
                         and g.fanout(preds[0]) == 1)
        if pred_is_chain:
            continue  # not a chain head
        chain = [name]
        cur = name
        while True:
            succs = g.succs(cur)
            if (g.fanout(cur) == 1 and len(succs) == 1
                    and g.nodes[succs[0]].kind == REG):
                cur = succs[0]
                chain.append(cur)
            else:
                break
        visited.update(chain)
        chains.append(chain)
    return chains


def collapse_reg_chains(g: DFG, rf_threshold: int = 4) -> int:
    """Replace every REG chain of length >= threshold with one RF node.

    Returns the number of register files created.
    """
    created = 0
    for chain in find_reg_chains(g):
        if len(chain) < rf_threshold:
            continue
        head, tail = chain[0], chain[-1]
        in_e = g.in_edges(head)
        out_e = g.out_edges(tail)
        if len(in_e) != 1 or len(out_e) != 1:
            continue  # broadcast point inside — leave to the tree pass
        src, dst = in_e[0], out_e[0]
        for e in list(g.edges):
            if e.src in chain or e.dst in chain:
                g.edges.remove(e)
        for n in chain:
            del g.nodes[n]
        rf = g.add(RF, width=src.width, depth=len(chain))
        g.nodes[rf].meta["pipelining"] = True
        g.connect(src.src, rf, 0, width=src.width)
        g.connect(rf, dst.dst, dst.port, width=dst.width)
        created += 1
    return created


def compute_pipelining(g: DFG, rf_threshold: int = 4) -> Dict[str, int]:
    """The full compute-pipelining pass; mutates ``g`` in place."""
    n_pe = enable_pe_input_registers(g)
    n_match = match_dfg(g)
    n_rf = collapse_reg_chains(g, rf_threshold) if not g.sparse else 0
    return {"pe_input_regs": n_pe, "matching_regs": n_match, "reg_files": n_rf}
