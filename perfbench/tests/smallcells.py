"""The benchmark's cells at the program's smoke sizes, for CPU tests: the
arch's ``smoke()`` config, each mix cut to a few tokens, and limits of
their own. Beside the cells of ``BENCHMARK.json``, ``granite-moe.decode``
pairs granite-moe with the decode mix (``mixes/decode_4k_256.json``), the
cell that ``PERF.md`` keeps for later, so that the decode driver is run
whole too.

The cells' limits (``limits/<workload>.json``) were set at the cells' own
sizes on the card. At these sizes bf16 rounds coarser against a narrower
model and the program's readings overlap the control's on some seeds, so
the tests run one seed (``SEED``) against limits set between its two
readings: program 4.0e-4 / 4.6e-3 / 1.3e-3 / 1.8e-3 (train: first loss
gap, worst and mean leaf's gradient gap, change gap) against the
control's 5.2e-4 / 0.032 / 0.011 / 0.010;
decode: mean token gap and first-layer cache gap 0 / 0.0028 against the
control's 0.099 / 0.035.
"""

import dataclasses
import json
from unittest import mock

import torch

from harness import run as hrun
from harness.run import Run, execute, result
from harness.spec import BENCH_DIR, Metric, load_cell
from repro_torch.configs import get_config

SMALL_MIXES = {
    "train": dict(batch=2, seq_len=32),
    "decode": dict(sessions=4, cache_slots=48, history=40, round=8,
                   check_sessions=2),
}
SEED = 2**31 + 11           # larger than 32 signed bits hold

SMALL_LIMITS = {
    "train": {"loss_gap.1": 1e-3, "grad_gap": 0.015, "grad_gap_mean": 0.004,
              "change_gap": 0.005},
    "decode": {"token_gap_mean": 0.03, "state_gap_first": 0.01},
}

# cells the tests run: those of BENCHMARK.json, and the decode mix on
# granite-moe
CELLS = ["granite-moe.train_4k", "granite-moe.decode"]


def _decode_cell():
    train = load_cell("granite-moe.train_4k")
    mix = json.loads((BENCH_DIR / "mixes" / "decode_4k_256.json").read_text())
    return dataclasses.replace(
        train, name="granite-moe.decode", traffic=mix["name"], mix=mix,
        end_to_end=[Metric("decode_tokens_per_s", "tokens/s"),
                    Metric("decode_step_p95_ms", "ms"),
                    Metric("setup_s", "s")],
        per_layer=[Metric(n, "%", "decode_tokens_per_s")
                   for n in ("idle_share.decode", "mfu.decode",
                             "flash_decode_roofline.decode")])


def small_cell(name: str):
    cell = _decode_cell() if name == "granite-moe.decode" else load_cell(name)
    port = get_config(cell.config["arch"]).smoke()
    cell.config = dict(cell.config, config={
        k: getattr(port, k) for k in cell.config["config"]})
    kind = cell.mix["kind"]
    cell.mix = dict(cell.mix, **SMALL_MIXES[kind])
    cell.limits = dict(SMALL_LIMITS[kind])
    return cell, port


def small_run(name: str, seed: int = SEED, plant=None, sides=("program",),
              traced=False):
    """A whole run of the cell on the CPU (the harness's look for a card
    skipped), the program's config being the arch's smoke config; returns
    (the Run, its readings by side, its result line)."""
    cell, port = small_cell(name)
    run = Run(cell, seed, 0.2, traced, torch.device("cpu"))
    with mock.patch.object(hrun, "program_config", lambda arch: port):
        readings = execute(run, 0.0, plant=plant, sides=sides)
    return run, readings, result(run)
