"""The port's pipeline-stage partitioner against the JAX package's: the
reference's partition tests (tests/test_launch.py) replayed, the port's plans
equal to the reference's on the same costs, and its ``layer_costs`` equal to
the reference's once its H100 constants are patched to the reference's."""

import pytest

from _hypothesis_compat import given, settings, st

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.distributed import pipeline as RP
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.distributed import pipeline as P
from repro_torch.distributed.pipeline import (layer_costs, naive_partition,
                                              partition)


def _fields(plan):
    """A plan's fields, to compare a port plan with a reference one."""
    return (plan.boundaries, plan.beat_s, plan.makespan_s, plan.bubble_frac,
            plan.stage_times, plan.history)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.floats(0.1, 10.0), min_size=8, max_size=64),
       st.integers(2, 6), st.floats(0.0, 0.5))
def test_partition_plans_equal_reference_and_stay_sane(costs, stages, bcost):
    """The reference's ``test_partition_never_much_worse_than_naive``
    without its 1.25 bound (which the algorithm does not keep: next test):
    sane boundaries, a beat no lower than the heaviest layer, and both
    plans equal to the reference's, field for field."""
    cas = partition(costs, stages, bcost)
    nai = naive_partition(costs, stages, bcost)
    assert cas.boundaries[0] == 0 and cas.boundaries[-1] == len(costs)
    assert all(b2 > b1 for b1, b2 in zip(cas.boundaries, cas.boundaries[1:]))
    assert cas.beat_s >= max(costs) - 1e-9
    assert _fields(cas) == _fields(RP.partition(costs, stages, bcost))
    assert _fields(nai) == _fields(RP.naive_partition(costs, stages, bcost))


def test_partition_can_lose_to_naive_by_more_than_the_reference_bound():
    """A fault of the reference's partitioner, carried over as it is: on
    these nine layers and three stages its plan's beat is 9.0 against the
    equal-count split's 7.0, past the 1.25 x its property test asserts
    (that test passes only while hypothesis draws no such stack)."""
    costs = [1.0, 3.0, 3.0, 1.0, 3.0, 2.0, 1.0, 1.0, 5.0]
    for mod in (P, RP):
        cas, nai = mod.partition(costs, 3, 0.0), mod.naive_partition(
            costs, 3, 0.0)
        assert (cas.boundaries, cas.beat_s) == ([0, 2, 5, 9], 9.0)
        assert (nai.boundaries, nai.beat_s) == ([0, 3, 6, 9], 7.0)
        assert cas.beat_s > 1.25 * nai.beat_s


@settings(max_examples=25, deadline=None)
@given(st.integers(2, 5))
def test_partition_competitive_on_spiky_stacks(stages):
    costs = ([1.0, 1.0, 1.0, 8.0] * 8)
    cas = partition(costs, stages, 0.0)
    nai = naive_partition(costs, stages, 0.0)
    assert cas.beat_s <= nai.beat_s * 1.10 + 1e-9


def test_layer_costs_reflect_heterogeneity():
    costs = layer_costs(ARCHS["zamba2-2.7b"], SHAPES["train_4k"],
                        chips_per_stage=64)
    assert len(costs) == 54
    shared = [costs[i] for i in range(5, 54, 6)]
    plain = [costs[i] for i in range(54) if (i + 1) % 6]
    assert min(shared) > max(plain)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_costs_and_plans_equal_reference_with_its_constants(
        monkeypatch, arch, shape):
    """With the reference's TPU constants patched in, ``layer_costs``,
    ``boundary_cost`` and ``plan_for`` give the reference's numbers exactly;
    with the port's H100 constants they scale as the rates do."""
    monkeypatch.setattr(P, "PEAK_FLOPS", RP.PEAK_FLOPS)
    monkeypatch.setattr(P, "HBM_BW", RP.HBM_BW)
    monkeypatch.setattr(P, "NVLINK_BW", RP.ICI_BW)
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    sh, rsh = SHAPES[shape], REF_SHAPES[shape]
    assert layer_costs(cfg, sh, 64) == RP.layer_costs(rcfg, rsh, 64)
    assert P.boundary_cost(cfg, sh, 8, 64) == RP.boundary_cost(rcfg, rsh, 8,
                                                               64)
    got, want = P.plan_for(cfg, sh), RP.plan_for(rcfg, rsh)
    assert {k: _fields(v) for k, v in got.items()} == {
        k: _fields(v) for k, v in want.items()}


def test_h100_constants():
    """The H100 SXM5 data sheet's: 989 TFLOP/s dense bf16, 3.35 TB/s of
    HBM3, 450 GB/s each way over NVLink."""
    assert (P.PEAK_FLOPS, P.HBM_BW, P.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    monkey = P.boundary_cost(ARCHS["llama3-8b"], SHAPES["train_4k"], 8, 1)
    assert monkey == pytest.approx(4096 * 256 / 8 * 4096 * 2 / 450e9)
