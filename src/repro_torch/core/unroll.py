"""Low unrolling duplication (paper Section V-E).

Unrolling produces more than one output per cycle and is critical to runtime,
but PnR-ing the fully unrolled application across a 512-tile array yields
long routes.  Cascade instead compiles the *un-unrolled* kernel, place-and-
routes it on a small sub-fabric window, and stamps the resulting
configuration across the array — the PnR problem shrinks by the unroll
factor while keeping all of its benefits.

We model the stamp by compiling one copy on ``subfabric_for`` and recording
``unroll_copies`` on the RoutedDesign: runtime divides by the copy count and
resource/energy accounting multiplies by it (power.py).  Timing is per-copy —
identical configurations have identical critical paths.
"""

from __future__ import annotations

import math
from typing import Tuple

from .dfg import FIFO, INPUT, MEM, OUTPUT, PE, RF
from .interconnect import Fabric
from .netlist import Netlist


def required_tiles(nl: Netlist) -> dict:
    need = {"pe": 0, "mem": 0, "io": 0}
    for nd in nl.nodes.values():
        if nd.kind in (PE, RF, FIFO):
            need["pe"] += 1
        elif nd.kind == MEM:
            need["mem"] += 1
        elif nd.kind in (INPUT, OUTPUT):
            need["io"] += 1
    return need


def subfabric_for(nl: Netlist, fabric: Fabric,
                  slack: float = 1.6) -> Fabric:
    """Smallest fabric window (same column pattern) that fits one copy."""
    need = required_tiles(nl)
    stride = fabric.mem_col_stride
    pe_per_group, mem_per_group = stride - 1, 1
    for cols in range(stride, fabric.cols + 1, stride):
        groups = cols // stride
        for rows in range(2, fabric.rows + 1):
            pe = rows * groups * pe_per_group
            mem = rows * groups * mem_per_group
            io = cols
            if (pe >= need["pe"] * slack and mem >= max(1, need["mem"]) and
                    io >= need["io"] and mem >= need["mem"]):
                return fabric.subfabric(rows, cols)
    return fabric


def max_copies(nl: Netlist, fabric: Fabric, sub: Fabric) -> int:
    """How many stamped copies of ``sub`` fit in ``fabric``."""
    return max(1, (fabric.rows // sub.rows) * (fabric.cols // sub.cols))
