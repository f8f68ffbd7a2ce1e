"""The port's online 2D rectangle packer (``repro_torch.core.multi``), on
the CPU.

The reference's property suite (``tests/test_pack2d.py``) replayed against
``repro_torch.core``: packed regions never overlap, stay in bounds, are
MEM-stride aligned, IO apps own a north-edge region, and
``validate_regions`` accepts every pack. Then the same seeded requests
through both packages give equal packs, slots and fragmentation.
"""

import random

import pytest

from repro_torch.core import (PackingError, RectRequest, Region, aligned_cols,
                        find_slot, fragmentation, free_area, pack_rects,
                        repack_rects, validate_regions)
from repro_torch.core.interconnect import Fabric

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st

# ---------------------------------------------------------------------------
# the invariant checker both harnesses drive
# ---------------------------------------------------------------------------


def small_fabric(rng: random.Random) -> Fabric:
    stride = rng.choice((2, 3, 4))
    return Fabric(rows=rng.randint(2, 12),
                  cols=stride * rng.randint(1, 5),
                  mem_col_stride=stride,
                  name="prop")


def random_requests(rng: random.Random, fabric: Fabric, n: int):
    return [RectRequest(f"app{i}",
                        rows=rng.randint(1, fabric.rows + 2),
                        cols=rng.randint(1, fabric.cols + 2),
                        needs_io=rng.random() < 0.7)
            for i in range(n)]


def check_pack_invariants(fabric: Fabric, requests, regions) -> None:
    """The full acceptance list, for any pack the packer returned."""
    assert set(regions) == {r.name for r in requests}
    by_name = {r.name: r for r in requests}
    names = sorted(regions)
    regs = [regions[n] for n in names]
    # validate_regions accepts every pack (in-bounds, stride-aligned,
    # disjoint, north-edge IO ownership)
    validate_regions(fabric, regs, names,
                     needs_io=[by_name[n].needs_io for n in names])
    stride = fabric.mem_col_stride
    for name in names:
        req, reg = by_name[name], regions[name]
        assert reg.rows == max(1, req.rows)          # exactly as requested
        assert reg.cols == aligned_cols(fabric, req.cols)
        assert reg.cols >= req.cols and reg.cols % stride == 0
        assert reg.col0 % stride == 0
        assert 0 <= reg.row0 and reg.row0 + reg.rows <= fabric.rows
        assert reg.col0 + reg.cols <= fabric.cols
        if req.needs_io:
            assert reg.row0 == 0                     # owns north-edge IO
        # stride alignment of both edges => the region contains its own
        # MEM column in every stride group it spans
        mem_cols = [c for c in range(reg.col0, reg.col0 + reg.cols)
                    if c % stride == stride - 1]
        assert len(mem_cols) == reg.cols // stride
    for i in range(len(regs)):
        for j in range(i + 1, len(regs)):
            assert not regs[i].overlaps(regs[j])
    assert free_area(fabric, regs) == (fabric.rows * fabric.cols
                                       - sum(r.area() for r in regs))


def pack_or_none(fabric, requests):
    try:
        return pack_rects(fabric, requests)
    except PackingError:
        return None


# ---------------------------------------------------------------------------
# seeded-random sweep (always runs, hypothesis or not)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(25))
def test_pack_rects_invariants_random(seed):
    rng = random.Random(seed)
    fabric = small_fabric(rng)
    requests = random_requests(rng, fabric, rng.randint(1, 8))
    regions = pack_or_none(fabric, requests)
    if regions is not None:
        check_pack_invariants(fabric, requests, regions)


@pytest.mark.parametrize("seed", range(25))
def test_repack_rects_deterministic_and_valid(seed):
    rng = random.Random(1000 + seed)
    fabric = small_fabric(rng)
    requests = random_requests(rng, fabric, rng.randint(1, 6))
    try:
        a = repack_rects(fabric, requests)
    except PackingError:
        return
    b = repack_rects(fabric, requests)
    assert a == b                                   # same residents in,
    check_pack_invariants(fabric, requests, a)      # same regions out


@pytest.mark.parametrize("seed", range(25))
def test_find_slot_complete_over_aligned_anchor_space(seed):
    """When find_slot says None, brute force agrees: no stride-aligned
    anchor (north-pinned for IO) admits the rectangle."""
    rng = random.Random(2000 + seed)
    fabric = small_fabric(rng)
    occupied = list((pack_or_none(
        fabric, random_requests(rng, fabric, rng.randint(0, 4))) or {}
    ).values())
    rows = rng.randint(1, fabric.rows)
    cols = rng.randint(1, fabric.cols)
    needs_io = rng.random() < 0.5
    slot = find_slot(fabric, occupied, rows, cols, needs_io=needs_io)
    w = aligned_cols(fabric, cols)
    row0s = (0,) if needs_io else range(fabric.rows - rows + 1)
    fits = [
        Region(r0, c0, rows, w)
        for r0 in row0s
        for c0 in range(0, fabric.cols - w + 1, fabric.mem_col_stride)
        if all(not Region(r0, c0, rows, w).overlaps(o) for o in occupied)
    ]
    if slot is None:
        assert not fits
    else:
        assert slot == fits[0]                      # first-fit, NW -> SE


@pytest.mark.parametrize("seed", range(15))
def test_fragmentation_bounded_and_zero_on_empty(seed):
    rng = random.Random(3000 + seed)
    fabric = small_fabric(rng)
    assert fragmentation(fabric, []) == 0.0         # one big free rectangle
    occupied = list((pack_or_none(
        fabric, random_requests(rng, fabric, rng.randint(1, 5))) or {}
    ).values())
    frag = fragmentation(fabric, occupied)
    assert 0.0 <= frag <= 1.0
    if free_area(fabric, occupied) == 0:
        assert frag == 0.0


def test_pack_rects_rejects_duplicates_and_names_failures():
    fabric = Fabric(rows=4, cols=4, mem_col_stride=4, name="tiny")
    with pytest.raises(PackingError, match="duplicate"):
        pack_rects(fabric, [RectRequest("a", 1, 1), RectRequest("a", 2, 2)])
    with pytest.raises(PackingError, match="b"):
        pack_rects(fabric, [RectRequest("a", 4, 4), RectRequest("b", 1, 1)])
    # oversized request fails even on an empty fabric
    assert find_slot(fabric, [], fabric.rows + 1, 1) is None
    assert find_slot(fabric, [], 1, fabric.cols + 1) is None


def test_interior_placement_only_for_non_io_requests():
    """A needs_io=False request may stack below a short north resident;
    an IO request never does."""
    fabric = Fabric(rows=8, cols=4, mem_col_stride=4, name="stack")
    north = Region(0, 0, 3, 4)
    interior = find_slot(fabric, [north], 3, 4, needs_io=False)
    assert interior is not None and interior.row0 >= 3
    assert find_slot(fabric, [north], 3, 4, needs_io=True) is None


# ---------------------------------------------------------------------------
# hypothesis harness (skips gracefully when hypothesis is absent)
# ---------------------------------------------------------------------------


@st.composite
def fabric_and_requests(draw):
    stride = draw(st.sampled_from((2, 3, 4)))
    fabric = Fabric(rows=draw(st.integers(2, 12)),
                    cols=stride * draw(st.integers(1, 5)),
                    mem_col_stride=stride, name="hyp")
    n = draw(st.integers(1, 8))
    reqs = [RectRequest(f"app{i}",
                        rows=draw(st.integers(1, fabric.rows + 2)),
                        cols=draw(st.integers(1, fabric.cols + 2)),
                        needs_io=draw(st.booleans()))
            for i in range(n)]
    return fabric, reqs


@settings(max_examples=60, deadline=None)
@given(fabric_and_requests())
def test_pack_rects_invariants_hypothesis(case):
    fabric, requests = case
    regions = pack_or_none(fabric, requests)
    if regions is not None:
        check_pack_invariants(fabric, requests, regions)


@settings(max_examples=40, deadline=None)
@given(fabric_and_requests())
def test_repack_deterministic_hypothesis(case):
    fabric, requests = case
    try:
        a = repack_rects(fabric, requests)
    except PackingError:
        return
    assert a == repack_rects(fabric, requests)
    check_pack_invariants(fabric, requests, a)


def test_hypothesis_shim_flag_is_boolean():
    assert HAVE_HYPOTHESIS in (True, False)


# ---------------------------------------------------------------------------
# the port against the reference: the same requests, the same packs
# ---------------------------------------------------------------------------

import repro.core as ref  # noqa: E402
from repro.core.interconnect import Fabric as RefFabric  # noqa: E402


def ref_twin(fabric: Fabric, requests):
    """The reference's fabric and requests of the same shape."""
    return (RefFabric(rows=fabric.rows, cols=fabric.cols,
                      mem_col_stride=fabric.mem_col_stride, name=fabric.name),
            [ref.RectRequest(r.name, rows=r.rows, cols=r.cols,
                             needs_io=r.needs_io) for r in requests])


def as_tuples(regions):
    if regions is None:
        return None
    return {n: (r.row0, r.col0, r.rows, r.cols) for n, r in regions.items()}


def attempt(fn, *args):
    try:
        return as_tuples(fn(*args))
    except (PackingError, ref.PackingError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("seed", range(25))
def test_packs_equal_reference(seed):
    rng = random.Random(seed)
    fabric = small_fabric(rng)
    requests = random_requests(rng, fabric, rng.randint(1, 8))
    rfab, rreqs = ref_twin(fabric, requests)
    assert attempt(pack_rects, fabric, requests) == \
        attempt(ref.pack_rects, rfab, rreqs)
    assert attempt(repack_rects, fabric, requests) == \
        attempt(ref.repack_rects, rfab, rreqs)


@pytest.mark.parametrize("seed", range(10))
def test_slots_and_fragmentation_equal_reference(seed):
    rng = random.Random(seed)
    fabric = small_fabric(rng)
    requests = random_requests(rng, fabric, rng.randint(1, 6))
    rfab, rreqs = ref_twin(fabric, requests)
    occupied, ref_occupied = [], []
    for req, rreq in zip(requests, rreqs):
        got = find_slot(fabric, occupied, req.rows, req.cols,
                        needs_io=req.needs_io)
        want = ref.find_slot(rfab, ref_occupied, rreq.rows, rreq.cols,
                             needs_io=rreq.needs_io)
        assert as_tuples({"s": got} if got else None) == \
            as_tuples({"s": want} if want else None)
        if got is not None:
            occupied.append(got)
            ref_occupied.append(want)
        assert fragmentation(fabric, occupied) == \
            ref.fragmentation(rfab, ref_occupied)
        assert free_area(fabric, occupied) == \
            ref.free_area(rfab, ref_occupied)
