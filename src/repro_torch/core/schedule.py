"""Static scheduling of CGRA applications (paper Sections III-C and V-F).

Dense image-processing / ML applications on this CGRA class are statically
scheduled: the compiler assigns every load/store a one-dimensional timestamp
and the memory-tile controllers replay it.  With an initiation interval of 1,
total runtime is

    cycles = pipeline_latency + (iterations - 1) * II

so pipelining barely changes the cycle count (latency << iterations) while
multiplying the clock frequency — which is the whole point of Cascade.

Two-round flow (Section V-F): round 1 schedules with all compute latencies 0
(the mapped-graph topology does not depend on latencies); after PnR and
pipelining, the real latencies are known and the schedule is recomputed.
``Schedule.round`` records which round produced the numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from .netlist import Netlist, RoutedDesign


@dataclass
class Schedule:
    latency_cycles: int        # pipeline fill latency (max arrival at outputs)
    ii: int                    # initiation interval
    iterations: int            # steady-state iterations (outputs / unroll)
    round: int = 1             # 1 = pre-pipelining latencies, 2 = post-PnR

    @property
    def total_cycles(self) -> int:
        return self.latency_cycles + (self.iterations - 1) * self.ii

    def runtime_s(self, freq_mhz: float) -> float:
        return self.total_cycles / (freq_mhz * 1e6)


def schedule_round1(iterations: int, ii: int = 1) -> Schedule:
    """Round-1 schedule: compute latencies all zero (paper V-F)."""
    return Schedule(latency_cycles=0, ii=ii, iterations=iterations, round=1)


def schedule_round2(design: RoutedDesign, iterations: int,
                    ii: int = 1, stall_factor: float = 0.0) -> Schedule:
    """Re-schedule with concrete post-PnR latencies.

    ``stall_factor`` models ready-valid backpressure stalls for sparse
    applications (II_effective = 1 + stall_factor).
    """
    arr = design.netlist.arrival_cycles()
    outs = [n for n, nd in design.netlist.nodes.items() if nd.kind == "output"]
    latency = max((arr[o] for o in outs), default=0)
    ii_eff = ii if stall_factor <= 0 else ii * (1.0 + stall_factor)
    total_iter_cycles = int(round((iterations - 1) * ii_eff))
    return Schedule(latency_cycles=latency, ii=1, iterations=total_iter_cycles + 1,
                    round=2)
