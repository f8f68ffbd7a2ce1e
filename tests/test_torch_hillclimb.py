"""The port's hillclimb driver (``repro_torch.launch.hillclimb``) against
the JAX package's: the same plans, letter for letter, and the same report
of a plan's variants, both drivers fed the same cells."""

import os

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

# repro.launch.{dryrun,hillclimb} set XLA_FLAGS at import: lock jax's
# backend first (as tests/test_launch.py does) and put the variable back
jax.devices()
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import hillclimb as RH  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch import hillclimb as H  # noqa: E402


def test_plans_equal_reference():
    assert H.PLANS == RH.PLANS
    assert list(H.PLANS) == list(RH.PLANS)
    for key, (arch, shape, variants) in H.PLANS.items():
        assert arch in ARCHS and shape in SHAPES
        for tag, hypothesis, edits, full in variants:
            ARCHS[arch].replace(**edits)          # every edit is a knob
    assert H.OUT == "experiments/hillclimb_torch" != RH.OUT


def _cells():
    """A plan's worth of cells, the dominant term falling then rising."""
    out = []
    for i, (c, m, x) in enumerate([(1.0, 2.0, 8.0), (1.0, 2.0, 4.0),
                                   (1.0, 3.0, 0.5), (2.0, 1.0, 0.25)]):
        bound = max(("compute", c), ("memory", m), ("collective", x),
                    key=lambda kv: kv[1])
        out.append({"roofline": {"compute_s": c, "memory_s": m,
                                 "collective_s": x, "bound": bound[0],
                                 "step_time_lower_bound_s": bound[1]},
                    "memory": {"peak_memory_in_bytes": 1.5e9 * (i + 1)},
                    "roofline_fraction": 0.1 * (i + 1)})
    return out


@pytest.mark.parametrize("key", sorted(RH.PLANS))
def test_run_plan_reports_as_reference(monkeypatch, capsys, key):
    """``run_plan`` on the same cells: the same lines printed, the same
    results, the same ``run_cell`` calls (multi_pod False, the variant's
    full flag, probes on, its tag and edited config)."""
    arch, shape, variants = H.PLANS[key]

    def fake(calls):
        cells = iter(_cells() * 2)

        def run_cell(a, s, multi_pod, out_dir, full, probes, cfg_override,
                     tag):
            calls.append((a, s, multi_pod, full, probes, tag,
                          {k: getattr(cfg_override, k) for k in
                           ("sequence_parallel", "remat", "fsdp",
                            "sharding_profile", "decode_cache_shard")}))
            return {"arch": a, "shape": s, "tag": tag, **next(cells)}
        return run_cell

    got_calls, want_calls = [], []
    monkeypatch.setattr(H, "run_cell", fake(got_calls))
    got = H.run_plan(key)
    got_out = capsys.readouterr().out
    monkeypatch.setattr(RH, "run_cell", fake(want_calls))
    want = RH.run_plan(key)
    want_out = capsys.readouterr().out
    assert got_out == want_out
    assert got == want
    assert got_calls == want_calls and len(got_calls) == len(variants)
    assert "dominant-term delta vs prev" in got_out


def test_fmt_equals_reference():
    for cell in _cells() + [{}]:
        assert H._fmt(cell) == RH._fmt(cell)
