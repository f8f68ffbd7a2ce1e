"""What decides ``correct``, driven through whole runs on the CPU at the
program's smoke sizes (the harness's look for a card skipped): the program
passes its cell's limits; the control (the plain reference in fp8 in the
program's place), judged by the same ``result``, and each planted fault
the cell can have do not."""

import dataclasses

import pytest
import torch

import faults
from harness.run import result
from smallcells import CELLS, small_run


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(name):
    run, readings, out = small_run(name, sides=("program", "control"))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    control = result(dataclasses.replace(run, readings=readings["control"]))
    assert not control["correct"], control["checks"]


@pytest.mark.parametrize("name,fault",
                         [(c, f) for c in CELLS
                          for f in faults.BY_KIND[
                              "train" if "train" in c else "decode"]])
def test_planted_fault_is_caught(name, fault):
    _, _, out = small_run(name, plant=faults.plant(fault))
    assert not out["correct"], out["checks"]


def test_same_seed_same_inputs():
    """Weights, caches and batches are pure functions of the seed (one
    past 32 bits included), and another seed draws others."""
    from harness import traffic, weights
    from harness.spec import reference_class
    from smallcells import SEED, small_cell
    cell, _ = small_cell("granite-moe.decode")
    ref = reference_class(cell.config)(cell.config["config"])

    def draw(seed):
        w = weights.make(ref.param_layout(), seed, traffic.WEIGHTS, "cpu")
        c = weights.make(ref.cache_layout(2, 8), seed, traffic.CACHE, "cpu")
        return ([t for _, t in weights.items(w)]
                + [t for _, t in weights.items(c)]
                + list(traffic.train_batch(seed, 3, 2, 16, 500, "cpu").values())
                + [traffic.first_tokens(seed, 4, 500, "cpu")])

    a, b, c = draw(SEED), draw(SEED), draw(SEED + 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    drawn = [i for i, x in enumerate(a) if x.float().std() > 0]
    assert all(not torch.equal(a[i], c[i]) for i in drawn)
