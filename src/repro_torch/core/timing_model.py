"""Timing-model generation for a CGRA (paper Section IV-A, Fig. 3).

The paper's methodology: from an interconnect specification (Canal), enumerate
every tile-level data/clock path with significant delay, run commercial STA on
the post-PnR tile netlists, and tabulate the worst-case delays for use in
application-level STA.

This container has no EDA tools, so the *enumeration* step is reproduced
faithfully — ``generate_timing_model`` walks the fabric spec and emits one
entry per (tile type x path type x direction) — while the *numbers* come from
a technology table calibrated to the delays the paper reports for its GF 12 nm
implementation (PE tile core 0.7 ns, switch-box hop 0.14 ns, MEM tiles slower
than PE tiles, direction-dependent wire lengths, and a clock-skew term).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

from .interconnect import DIRS, Fabric, Hop, Tile

# ---------------------------------------------------------------------------
# technology table (GF 12 nm-class, calibrated to the paper's reported values)
# ---------------------------------------------------------------------------

TECH_NS = {
    # tile core compute paths (CB input -> core -> SB output boundary)
    "core_pe": 0.70,        # ALU/mul datapath through a PE tile (paper: 0.7 ns)
    "core_mem": 0.95,       # SRAM + address-gen datapath through a MEM tile
    "core_rf": 0.45,        # register-file read (shift-register mode)
    "core_fifo": 0.50,      # FIFO push/pop datapath
    "core_io": 0.25,        # IO tile boundary
    # switch-box hop, horizontal, through a PE tile (paper: ~0.14 ns)
    "sb_pe_h": 0.14,
    "sb_pe_v": 0.115,       # PE tiles are wider than tall
    "sb_mem_h": 0.24,       # MEM tile has a much larger footprint
    "sb_mem_v": 0.16,
    "cb_in": 0.06,          # connection box, track -> tile input
    "reg_clk_q": 0.07,      # pipeline register clock-to-q
    "reg_setup": 0.05,      # pipeline register setup
    "clk_skew": 0.05,       # worst-case skew between adjacent tiles
}


#: Delay class for every PE op: which ``TECH_NS`` core entry times it.
#: The paper's tile STA reports one worst-case core path per tile type, so
#: every op — ALU, comparator, mux/sel/phi/steer — shares the ``core_pe``
#: figure today; the mapping exists so per-op classes can diverge later
#: and so the audit test can assert every ``PE_OPS`` entry is timed.
PE_OP_DELAY_CLASS: Dict[str, str] = {
    op: "core_pe" for op in (
        "add", "sub", "mul", "and", "or", "xor", "shr", "shl", "min",
        "max", "abs", "gt", "lt", "eq", "ne", "ge", "le", "mux", "pass",
        "steer", "sel", "phi",
    )
}


@dataclass
class TimingModel:
    """Worst-case component delays, keyed the way application STA consumes them."""
    entries: Dict[str, float] = field(default_factory=dict)
    fabric_name: str = ""

    def hop_delay(self, fabric: Fabric, hop: Hop) -> float:
        """Delay of one interconnect hop: through ``hop.src``'s switch box and
        the wire crossing into ``hop.dst``."""
        kind = fabric.tile_kind(hop.dst) if hop.dst[0] >= 0 else "io"
        horiz = hop.direction in ("E", "W")
        if kind == "io":
            return self.entries["sb_pe_v"]
        key = f"sb_{'mem' if kind == 'mem' else 'pe'}_{'h' if horiz else 'v'}"
        return self.entries[key]

    def core_delay(self, kind: str, op: str = "") -> float:
        if kind == "pe" and op:
            key = PE_OP_DELAY_CLASS.get(op)
            if key is None:
                raise KeyError(f"PE op {op!r} has no delay class")
            return self.entries[key]
        key = {
            "pe": "core_pe", "mem": "core_mem", "rf": "core_rf",
            "fifo": "core_fifo", "io": "core_io",
            "input": "core_io", "output": "core_io",
        }.get(kind)
        if key is None:
            raise KeyError(f"no core delay for tile kind {kind!r}")
        return self.entries[key]

    @property
    def cb_in(self) -> float:
        return self.entries["cb_in"]

    @property
    def reg_clk_q(self) -> float:
        return self.entries["reg_clk_q"]

    @property
    def reg_setup(self) -> float:
        return self.entries["reg_setup"]

    @property
    def clk_skew(self) -> float:
        return self.entries["clk_skew"]

    def sequential_overhead(self) -> float:
        """Fixed per-path overhead: launch clk-q + capture setup + skew."""
        return self.reg_clk_q + self.reg_setup + self.clk_skew


def generate_timing_model(fabric: Fabric, tech: Dict[str, float] = TECH_NS) -> TimingModel:
    """Enumerate all significant tile-level paths of ``fabric`` and tabulate
    worst-case delays (the automated flow of paper Fig. 3).

    Emits one entry per path type actually present in the fabric; an STA run
    that asks for a path the fabric does not contain raises KeyError, which
    mirrors the generated-collateral behaviour of Canal.
    """
    entries: Dict[str, float] = {}
    kinds = {"pe", "mem", "io"}
    present = {fabric.tile_kind(t) for t in fabric.tiles()}
    assert present <= kinds
    # core paths for every tile kind present + the soft structures mapped onto
    # PE/MEM tiles (register files, FIFOs).
    for k in sorted(present):
        entries[f"core_{k}"] = tech[f"core_{k}"]
    entries["core_rf"] = tech["core_rf"]
    entries["core_fifo"] = tech["core_fifo"]
    # switch-box paths: (tile kind) x (direction class)
    for k in sorted(present - {"io"}):
        for d in ("h", "v"):
            entries[f"sb_{k}_{d}"] = tech[f"sb_{k}_{d}"]
    for k in ("cb_in", "reg_clk_q", "reg_setup", "clk_skew"):
        entries[k] = tech[k]
    return TimingModel(entries=entries, fabric_name=fabric.name)
