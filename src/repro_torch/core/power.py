"""Energy / power / EDP model of the CGRA (calibrated to GF 12 nm, paper
Section VIII).

P = P_static + f * E_cycle, with E_cycle the sum of per-element switching
energies times an activity factor.  The constants are calibrated once so the
*unpipelined* baselines land near the paper's Table I; every improvement the
toolkit reports then emerges from the actual register/frequency/schedule
changes the passes make, not from re-tuning.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from .dfg import FIFO, INPUT, MEM, OUTPUT, PE, RF
from .netlist import RoutedDesign
from .schedule import Schedule


@dataclass
class EnergyParams:
    # pJ per active element per cycle (GF 12 nm class, calibrated)
    e_pe: float = 6.0
    e_mem: float = 12.0
    e_rf: float = 3.0
    e_fifo: float = 4.0
    e_io: float = 4.0
    e_reg: float = 0.15          # one interconnect pipeline register
    e_sb_hop: float = 0.40       # one switch-box traversal + track wire
    rv_overhead: float = 1.35    # sparse: valid+ready companion wires
    activity: float = 0.5
    p_static_mw: float = 25.0


@dataclass
class PowerReport:
    freq_mhz: float
    runtime_s: float
    power_mw: float
    energy_j: float
    edp_js: float
    e_cycle_pj: float
    breakdown: Dict[str, float] = field(default_factory=dict)

    def scaled(self) -> dict:
        return {
            "freq_mhz": round(self.freq_mhz, 1),
            "runtime_ms": self.runtime_s * 1e3,
            "power_mw": round(self.power_mw, 1),
            "energy_mj": self.energy_j * 1e3,
            "edp_ujs": self.edp_js * 1e6,
        }


def cycle_energy(design: RoutedDesign, params: EnergyParams) -> Dict[str, float]:
    """Per-cycle switching energy breakdown (pJ) of a routed design.

    Counts active elements (PEs, MEMs, RFs, FIFOs, IOs), physical pipeline
    registers (interconnect sites + PE input registers), and switch-box
    hop traversals; each class is weighted by its calibrated per-cycle
    energy, the activity factor, and — for sparse designs — the
    ready-valid companion-wire overhead.  Low-unrolling duplication scales
    everything by the stamp count (the energy of ``unroll_copies``
    identical copies).  Keys: ``pe, mem, rf, fifo, io, registers,
    interconnect``.
    """
    nl = design.netlist
    k = design.unroll_copies
    counts = {"pe": 0, "mem": 0, "rf": 0, "fifo": 0, "io": 0}
    pe_input_regs = 0
    for nd in nl.nodes.values():
        if nd.kind == PE:
            counts["pe"] += 1
            if nd.input_reg:
                pe_input_regs += 2
        elif nd.kind == MEM:
            counts["mem"] += 1
        elif nd.kind == RF:
            counts["rf"] += 1
        elif nd.kind == FIFO:
            counts["fifo"] += 1
        elif nd.kind in (INPUT, OUTPUT):
            counts["io"] += 1
    regs = design.physical_register_count() + pe_input_regs
    hops = design.total_wirelength()
    rv = params.rv_overhead if nl.sparse else 1.0
    br = {
        "pe": counts["pe"] * params.e_pe,
        "mem": counts["mem"] * params.e_mem,
        "rf": counts["rf"] * params.e_rf,
        "fifo": counts["fifo"] * params.e_fifo,
        "io": counts["io"] * params.e_io,
        "registers": regs * params.e_reg * rv,
        "interconnect": hops * params.e_sb_hop * rv,
    }
    return {kk: v * params.activity * k for kk, v in br.items()}


def power_report(design: RoutedDesign, freq_mhz: float, sched: Schedule,
                 params: EnergyParams = EnergyParams()) -> PowerReport:
    """Power / energy / EDP at ``freq_mhz`` for one scheduled design.

    ``P = P_static + f * E_cycle`` (mW); energy is power times the
    schedule's runtime at that frequency, and EDP is energy times runtime
    — the metric the paper's Table I/II comparisons (and the power-capped
    pipelining controller, :mod:`repro_torch.core.power_cap`) are built on.
    Deterministic and side-effect free: the cap controller may call it
    every round without perturbing the design.
    """
    br = cycle_energy(design, params)
    e_cycle = sum(br.values())                      # pJ
    p_dyn_mw = freq_mhz * e_cycle * 1e-3            # MHz * pJ = uW
    power_mw = params.p_static_mw + p_dyn_mw
    runtime = sched.runtime_s(freq_mhz)
    energy = power_mw * 1e-3 * runtime
    return PowerReport(
        freq_mhz=freq_mhz, runtime_s=runtime, power_mw=power_mw,
        energy_j=energy, edp_js=energy * runtime,
        e_cycle_pj=e_cycle, breakdown=br)
