"""The port's Cascade compile against the JAX package's, on the CPU.

The default schedule on the default host backends (numpy place and route,
scalar STA, the interpreter simulator) is deterministic, so the port's
designs must be byte-identical to the reference's: the same summary, the
same critical path and registers, the same pass sequence, the same design
digest and the same timing matrix.
"""

import dataclasses
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

from repro.core import ALL_APPS as REF_APPS  # noqa: E402
from repro.core import CascadeCompiler as RefCompiler  # noqa: E402
from repro.core import PassConfig as RefPassConfig  # noqa: E402
from repro.core.sta import timing_matrix as ref_timing_matrix  # noqa: E402
from repro_torch.core import (ALL_APPS, CONTROL_APPS, DENSE_APPS,  # noqa: E402
                              CascadeCompiler, PassConfig, config)
from repro_torch.core.netlist import design_digest  # noqa: E402
from repro_torch.core.sta import timing_matrix  # noqa: E402

# the package exports a function named like this module
sim_mod = importlib.import_module("repro_torch.core.sim")

REPO = Path(__file__).resolve().parent.parent

# tests/test_predication.py's pins of the straight-line apps under
# PassConfig.full(place_moves=40): (design digest, critical path ns,
# physical registers)
STRAIGHT_LINE_PINS = {
    "gaussian": ("a3a27512474fe9396edeb6f63f642286873820b92ee2701b95b0b98dae1f81f3",
                 1.375, 62),
    "unsharp": ("f51ce187b41722194946e24ed3fc93e9ab044bb59a2bb0eaee081e4ba152eaef",
                1.47, 91),
    "harris": ("1bd4154ffbd6ad87d2b51b31c4b8831d96ac0883aa7aecd0eeec371981153b01",
               2.005, 228),
}

_COMPILES = ([(app, "full") for app in sorted(ALL_APPS)]
             + [(app, "unpipelined") for app in sorted(DENSE_APPS)])


@pytest.mark.parametrize("app,flow", _COMPILES)
def test_compile_matches_reference(app, flow):
    verify = app in DENSE_APPS or app in CONTROL_APPS
    port_c, ref_c = CascadeCompiler(), RefCompiler()
    got = port_c.compile(ALL_APPS[app],
                         getattr(PassConfig, flow)(place_moves=40),
                         verify=verify)
    want = ref_c.compile(REF_APPS[app],
                         getattr(RefPassConfig, flow)(place_moves=40),
                         verify=verify, use_cache=False)
    assert got.summary() == want.summary()
    assert got.sta.critical_path_ns == want.sta.critical_path_ns
    assert (got.design.physical_register_count()
            == want.design.physical_register_count())
    assert got.pass_stats["pipeline"] == want.pass_stats["pipeline"]
    assert ("verify" in got.pass_stats["pipeline"]) == (
        verify and not ALL_APPS[app].sparse)
    assert design_digest(got.design) == design_digest(want.design)
    m, verts = timing_matrix(got.design, port_c.timing)
    rm, rverts = ref_timing_matrix(want.design, ref_c.timing)
    assert verts == rverts
    assert np.array_equal(m, rm)


@pytest.mark.parametrize("app", sorted(STRAIGHT_LINE_PINS))
def test_straight_line_pins_hold(app):
    digest, cp, regs = STRAIGHT_LINE_PINS[app]
    r = CascadeCompiler().compile(DENSE_APPS[app],
                                  PassConfig.full(place_moves=40))
    assert round(r.sta.critical_path_ns, 6) == cp
    assert r.design.physical_register_count() == regs
    assert design_digest(r.design) == digest


_FIELDS = [f.name for f in dataclasses.fields(PassConfig)]


@pytest.mark.parametrize("factory", ["__call__", "unpipelined", "full"])
@pytest.mark.parametrize("field", _FIELDS)
def test_pass_config_defaults_match_reference(field, factory):
    make = (PassConfig if factory == "__call__"
            else getattr(PassConfig, factory))
    ref_make = (RefPassConfig if factory == "__call__"
                else getattr(RefPassConfig, factory))
    assert getattr(make(), field) == getattr(ref_make(), field)


def test_pass_config_keeps_only_reference_fields():
    ref_fields = {f.name for f in dataclasses.fields(RefPassConfig)}
    assert set(_FIELDS) <= ref_fields
    assert {"power_cap_mw", "explore", "region"}.isdisjoint(_FIELDS)


def _compile_with(**kw):
    CascadeCompiler().compile(DENSE_APPS["gaussian"],
                              PassConfig.full(place_moves=2, **kw))


def _simulate(backend):
    g = DENSE_APPS["gaussian"].build(1)
    return sim_mod.simulate(g, {n: [1, 2, 3] for n, nd in g.nodes.items()
                                if nd.kind == "input"}, 4, backend=backend,
                            device="cpu")


@pytest.mark.parametrize("what,backend", [("sim", "numpy"), ("sim", "torch")])
def test_unported_backends_raise(what, backend):
    """The vectorized sim backends run (``torch`` on the CPU, its kernels'
    plain versions) and give the interpreter's streams."""
    got = _simulate(backend)
    assert got == _simulate("interpreter") and got


@pytest.mark.parametrize("what", ["pnr", "sta", "sim"])
def test_unknown_backend_names_raise_value_error(what):
    with pytest.raises(ValueError):
        if what == "pnr":
            _compile_with(pnr_backend="jax")
        elif what == "sta":
            _compile_with(sta_backend="jax")
        else:
            _simulate("jax")


@pytest.mark.parametrize("var,fn,value,want", [
    ("CASCADE_PNR_BACKEND", "pnr_backend", "torch", "torch"),
    ("CASCADE_STA_BACKEND", "sta_backend", " Scalar ", "scalar"),
    ("CASCADE_SIM_BACKEND", "sim_backend", "numpy", "numpy"),
    ("CASCADE_PNR_BACKEND", "pnr_backend", "jax", "numpy"),
    ("CASCADE_STA_BACKEND", "sta_backend", "bogus", "scalar"),
    ("CASCADE_SIM_BACKEND", "sim_backend", "", "interpreter")])
def test_backend_env_knobs(monkeypatch, var, fn, value, want):
    monkeypatch.setenv(var, value)
    if value.strip() and value.strip().lower() != want:
        with pytest.warns(UserWarning, match=var):
            assert getattr(config, fn)() == want
    else:
        assert getattr(config, fn)() == want


_LAZY = re.compile(
    r"^\s*from\s+\.(cache)\b|"
    r"^\s*from\s+\.\s+import\s+(cache)\b",
    re.MULTILINE)


def test_core_has_no_lazy_imports_of_unported_modules():
    files = sorted((REPO / "src" / "repro_torch" / "core").glob("*.py"))
    assert len(files) > 15
    hits = [f"{f.name}: {m.group(0).strip()}"
            for f in files for m in _LAZY.finditer(f.read_text())]
    assert hits == []
