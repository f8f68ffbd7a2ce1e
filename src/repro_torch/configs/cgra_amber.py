"""The paper's own hardware target: a 32x16 Amber-class CGRA
(384 PE + 128 MEM tiles, GF 12 nm-calibrated delays) — Section VIII."""

from repro_torch.core.interconnect import Fabric
from repro_torch.core.power import EnergyParams
from repro_torch.core.timing_model import generate_timing_model


def make_fabric() -> Fabric:
    return Fabric()           # defaults are the paper's 32x16 array


def make_timing_model():
    return generate_timing_model(make_fabric())


def make_energy_params() -> EnergyParams:
    return EnergyParams()
