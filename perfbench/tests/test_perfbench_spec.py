"""The harness finds each cell's files by name, refuses what has none, and
takes a new mix, cell, limits, metric and mix kind as new files alone."""

import json
import shutil

import pytest
import torch

from harness.run import Run, execute, result
from harness.spec import ROOT, SpecError, driver, load_cell, metric_reader

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = load_cell(name)
    assert cell.config["name"] == cell.config_name
    assert cell.mix["name"] == cell.traffic
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m.moves in names
        assert callable(metric_reader(m.name))


def test_unknown_names_are_refused():
    with pytest.raises(SpecError, match="unknown workload"):
        load_cell("no-such.cell")
    with pytest.raises(SpecError, match="no reader"):
        metric_reader("no_such_metric")
    with pytest.raises(SpecError, match="no driver"):
        driver("no_such_kind")


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root, json.loads((ROOT / "BENCHMARK.json").read_text())


def test_new_files_add_a_cell(tmp_path):
    """A later change adds a mix, a cell's limits and a per-layer metric as
    new files and entries; no file that is there changes."""
    root, bench = _checkout(tmp_path)
    mix = json.loads((ROOT / "perfbench/mixes/decode_4k_256.json").read_text())
    mix.update(name="decode_chat", sessions=8, cache_slots=512, history=384,
               round=128)
    (root / "perfbench/mixes/decode_chat.json").write_text(json.dumps(mix))
    (root / "perfbench/limits/granite-moe.decode_chat.json").write_text(
        json.dumps({"limits": {"token_gap_mean": {"limit": 0.5}}}))
    (root / "perfbench/metrics/steps_traced.decode.py").write_text(
        "def read(run):\n    return run.trace.units if run.trace else None\n")
    bench["workloads"].append({"name": "granite-moe.decode_chat",
                               "config": "granite-moe-1b-a400m",
                               "traffic": "decode_chat", "chips": 1,
                               "why": "a host-paced chat batch"})
    bench["end_to_end"].append({
        "name": "decode_tokens_per_s", "unit": "tokens/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["granite-moe.decode_chat"]})
    bench["per_layer"].append({
        "name": "steps_traced.decode", "unit": "steps", "better": "higher",
        "source": "device_trace", "layer": "device",
        "moves": "decode_tokens_per_s",
        "workloads": ["granite-moe.decode_chat"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("granite-moe.decode_chat", root)
    assert cell.mix["sessions"] == 8
    assert cell.limits == {"token_gap_mean": 0.5}
    assert {m.name for m in cell.end_to_end} == {"decode_tokens_per_s",
                                                 "setup_s"}
    assert [m.name for m in cell.per_layer] == ["steps_traced.decode"]
    assert metric_reader("steps_traced.decode", root)(
        type("R", (), {"trace": None})()) is None
    with pytest.raises(SpecError):
        load_cell("granite-moe.decode_chat")  # not in the repo's own file


TOY_DRIVER = """
def setup(run):
    return {"n": 0}


def warm(run, st):
    st["n"] += 1


def window(run, st):
    run.units = run.attempted = 5
    run.window_s = 0.5
    run.end_to_end["toy_items_per_s"] = run.units / run.window_s


def traced(run, st):
    pass


def check(run, st, sides):
    return {s: {"gap": 0.0 if s == "program" else 1.0} for s in sides}
"""


def test_a_new_kind_is_a_driver_file(tmp_path):
    """A mix of a kind the harness has no driver for comes with
    ``drivers/<kind>.py``, found by name and run whole through ``result``,
    its end-to-end metric a new entry."""
    root, bench = _checkout(tmp_path)
    (root / "perfbench/drivers/toy.py").write_text(TOY_DRIVER)
    (root / "perfbench/mixes/toy_mix.json").write_text(
        json.dumps({"name": "toy_mix", "kind": "toy"}))
    (root / "perfbench/limits/granite-moe.toy.json").write_text(
        json.dumps({"limits": {"gap": {"limit": 0.5}}}))
    bench["workloads"].append({"name": "granite-moe.toy",
                               "config": "granite-moe-1b-a400m",
                               "traffic": "toy_mix", "chips": 1,
                               "why": "a kind of its own"})
    bench["end_to_end"].append({
        "name": "toy_items_per_s", "unit": "items/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["granite-moe.toy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("granite-moe.toy", root)
    run = Run(cell, 1, 0.1, False, torch.device("cpu"))
    sides = execute(run, 0.0, sides=("program", "control"))
    out = result(run)
    assert out["correct"] and out["metrics"]["toy_items_per_s"]["value"] == 10
    assert sides["control"] == {"gap": 1.0}
    (root / "perfbench/drivers/toy.py").unlink()
    with pytest.raises(SpecError, match="no driver"):
        load_cell("granite-moe.toy", root)
