"""Multi-app fabric sharing — disjoint sub-fabrics, one shared flush.

CGRA toolchains are evaluated almost exclusively single-app (arXiv:2502.19114)
and the paper's own flow compiles one application per fabric.  This module
opens the co-residency scenario: N applications (dense and sparse mixed)
compile into disjoint rectangular :class:`~repro_torch.core.interconnect.Region`
windows of one :class:`~repro_torch.core.interconnect.Fabric`, sharing exactly one
resource — the hardened flush distribution network of paper Section VI, which
has one source and fabric-wide destinations and is therefore the natural
thing to amortize across residents (:func:`repro_torch.core.flush.shared_flush`).

The pieces:

* :func:`pack_regions` — size each app's window from its mapped netlist
  (:func:`~repro_torch.core.unroll.subfabric_for`) and pack the fabric into
  full-height, MEM-stride-aligned column strips.  Full height because IO
  streams in from the north edge only: a vertically-stacked resident would
  be IO-starved, so column strips are the *correct* rectangular packing for
  this CGRA class, not a simplification.  Leftover column groups are dealt
  round-robin so residents reclaim slack for low-unrolling stamps.
* :func:`validate_regions` — in-bounds, stride-aligned, pairwise disjoint.
* :class:`MultiAppResult` + :func:`fabric_report` — per-app compile results
  (each an ordinary :class:`~repro_torch.core.compiler.CompileResult`, cached
  under its own content-hash key) plus the fabric-level rollup: frequency
  is the minimum over residents (one shared clock), power/energy/EDP sum,
  and tile utilization is accounted per region
  (:func:`repro_torch.core.metrics.combine_metrics`).

The compile driver itself — :class:`~repro_torch.core.compiler.MultiAppSpec` and
``CascadeCompiler.compile_multi`` — lives in :mod:`repro_torch.core.compiler`;
the ``"multi"`` named schedule it runs per app is defined in
:mod:`repro_torch.core.passes` and reuses each app's existing ``mapped`` stage
artifacts (regions key only the placed/routed stages).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .flush import SharedFlushReport, shared_flush, stateful_nodes
from .interconnect import Fabric, Region, Tile
from .metrics import DesignMetrics, combine_metrics
from .netlist import Netlist, RoutedDesign
from .unroll import subfabric_for


class PackingError(ValueError):
    """The requested apps do not fit the fabric as disjoint regions."""


def region_request(nl: Netlist, fabric: Fabric) -> Tuple[int, int]:
    """Minimal (rows, cols) window for one copy of ``nl`` on ``fabric``'s
    column pattern (cols is a multiple of the MEM-column stride)."""
    win = subfabric_for(nl, fabric)
    return win.rows, win.cols


def pack_regions(fabric: Fabric,
                 requests: Sequence[Tuple[str, Netlist]]) -> List[Region]:
    """Pack one full-height column strip per app, in request order.

    Each app gets at least the minimal strip width its netlist needs;
    leftover stride-aligned column groups are dealt round-robin so the
    slack becomes low-unrolling stamp room instead of dead tiles.  Raises
    :class:`PackingError` with the full demand breakdown when the fabric
    is too narrow for the pack.
    """
    if not requests:
        raise PackingError("pack_regions: no apps to pack")
    stride = fabric.mem_col_stride
    widths: List[int] = []
    for name, nl in requests:
        _, cols = region_request(nl, fabric)
        widths.append(cols)
    total = sum(widths)
    if total > fabric.cols:
        demand = ", ".join(f"{name}: {w} cols"
                           for (name, _), w in zip(requests, widths))
        raise PackingError(
            f"apps need {total} columns, fabric {fabric.name} has "
            f"{fabric.cols} ({demand})")
    leftover = (fabric.cols - total) // stride
    i = 0
    while leftover > 0:
        widths[i % len(widths)] += stride
        leftover -= 1
        i += 1
    regions, col0 = [], 0
    for w in widths:
        regions.append(Region(0, col0, fabric.rows, w))
        col0 += w
    return regions


def validate_regions(fabric: Fabric, regions: Sequence[Region],
                     names: Sequence[str],
                     needs_io: Optional[Sequence[bool]] = None) -> None:
    """In-bounds, MEM-stride-aligned, pairwise-disjoint region check.

    ``needs_io`` (parallel to ``regions``, default: every app needs IO)
    additionally enforces north-edge IO ownership: a region whose app
    streams through the global buffer must touch the north row, because an
    interior region owns no row ``-1`` IO tiles on this CGRA class.
    """
    if len(regions) != len(names):
        raise PackingError(
            f"{len(regions)} regions for {len(names)} apps")
    if needs_io is not None and len(needs_io) != len(regions):
        raise PackingError(
            f"{len(needs_io)} needs_io flags for {len(regions)} regions")
    stride = fabric.mem_col_stride
    for i, (name, r) in enumerate(zip(names, regions)):
        fabric.subregion(r)              # raises when out of bounds
        if r.col0 % stride:
            raise PackingError(
                f"region of {name!r} starts at column {r.col0}, which is "
                f"not aligned to the MEM-column stride {stride}")
        if needs_io is not None and needs_io[i] and r.row0 != 0:
            raise PackingError(
                f"region of {name!r} starts at row {r.row0}: an app with "
                f"IO streams must own north-edge IO tiles, so its region "
                f"must touch row 0")
    for i in range(len(regions)):
        for j in range(i + 1, len(regions)):
            if regions[i].overlaps(regions[j]):
                raise PackingError(
                    f"regions of {names[i]!r} and {names[j]!r} overlap: "
                    f"{regions[i]} vs {regions[j]}")


# ---------------------------------------------------------------------------
# 2D rectangle packing (online multi-tenant scheduling)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RectRequest:
    """One admission request for the 2D rectangle packer.

    ``rows``/``cols`` come from :func:`region_request` (the minimal window
    the app's mapped netlist needs); ``needs_io`` records whether the app
    streams through the global buffer — on this CGRA class IO enters from
    the north edge only, so an IO app's rectangle must be anchored at row
    0 (:class:`~repro_torch.core.interconnect.Region` gives row ``-1`` IO tiles
    only to the region owning the column *and* touching the north row).
    Every real Cascade app has IO; ``needs_io=False`` exists so the packer
    stays a general 2D packer (and is property-tested as one).
    """

    name: str
    rows: int
    cols: int
    needs_io: bool = True


def aligned_cols(fabric: Fabric, cols: int) -> int:
    """Round a width request up to a whole number of MEM-stride column
    groups (every region must contain its own MEM column(s))."""
    stride = fabric.mem_col_stride
    return -(-max(1, cols) // stride) * stride


def find_slot(fabric: Fabric, occupied: Sequence[Region], rows: int,
              cols: int, needs_io: bool = True) -> Optional[Region]:
    """First-fit free rectangle for a ``rows x cols`` request.

    The incremental half of the online packer: given the regions current
    residents already own, return a disjoint, in-bounds, stride-aligned
    window for the newcomer — or ``None`` when no position fits (the
    scheduler then re-packs or evicts).  Candidate anchors scan north-west
    to south-east (top-anchored first, then leftmost), so placement is
    deterministic; ``needs_io`` pins the anchor row to the north edge.
    """
    w = aligned_cols(fabric, cols)
    rows = max(1, rows)
    if rows > fabric.rows or w > fabric.cols:
        return None
    row0s = (0,) if needs_io else tuple(range(fabric.rows - rows + 1))
    stride = fabric.mem_col_stride
    for r0 in row0s:
        for c0 in range(0, fabric.cols - w + 1, stride):
            cand = Region(r0, c0, rows, w)
            if all(not cand.overlaps(r) for r in occupied):
                return cand
    return None


def pack_rects(fabric: Fabric, requests: Sequence[RectRequest],
               occupied: Sequence[Region] = ()) -> Dict[str, Region]:
    """Greedy first-fit 2D rectangle pack of ``requests``, in order.

    Unlike :func:`pack_regions` — which deals *full-height column strips*
    and therefore cannot express the fragmented free space an online
    scheduler faces after departures — this packs true rectangles
    (variable heights, stride-aligned columns, north-edge anchoring for
    IO apps) around whatever ``occupied`` regions already exist.  Raises
    :class:`PackingError` naming the first request that does not fit.
    """
    seen = set()
    for req in requests:
        if req.name in seen:
            raise PackingError(f"duplicate pack request {req.name!r}")
        seen.add(req.name)
    placed: List[Region] = list(occupied)
    out: Dict[str, Region] = {}
    for req in requests:
        slot = find_slot(fabric, placed, req.rows, req.cols,
                         needs_io=req.needs_io)
        if slot is None:
            raise PackingError(
                f"no free {req.rows}x{aligned_cols(fabric, req.cols)} "
                f"rectangle for {req.name!r} (occupied: "
                f"{len(placed)} regions, free area "
                f"{free_area(fabric, placed)} tiles)")
        out[req.name] = slot
        placed.append(slot)
    return out


def repack_rects(fabric: Fabric,
                 requests: Sequence[RectRequest]) -> Dict[str, Region]:
    """Compacting re-pack: place all residents afresh on an empty fabric.

    Requests are packed widest-first (ties broken by height, then name) so
    the hard-to-place rectangles claim contiguous space before the small
    ones shred it — the defragmentation move the online scheduler runs
    when an arrival fails to fit but total free area says it should.
    Deterministic: same residents in, same regions out.
    """
    order = sorted(requests,
                   key=lambda r: (-aligned_cols(fabric, r.cols), -r.rows,
                                  r.name))
    return pack_rects(fabric, order)


def free_area(fabric: Fabric, occupied: Sequence[Region]) -> int:
    """Tiles not owned by any resident (regions assumed disjoint)."""
    return fabric.rows * fabric.cols - sum(r.area() for r in occupied)


def fragmentation(fabric: Fabric, occupied: Sequence[Region],
                  needs_io: bool = True) -> float:
    """How shredded the free space is, in [0, 1].

    0 = the largest admissible rectangle covers all free tiles (no
    fragmentation); 1 = free tiles exist but no stride-aligned rectangle
    is admissible at all.  The scheduler uses this to decide when a
    failed admission is worth a re-pack rather than a rejection.
    """
    free = free_area(fabric, occupied)
    if free <= 0:
        return 0.0
    best = 0
    stride = fabric.mem_col_stride
    for w in range(stride, fabric.cols + 1, stride):
        lo, hi = 1, fabric.rows
        while lo <= hi:                 # tallest fit at this width
            mid = (lo + hi) // 2
            if find_slot(fabric, occupied, mid, w,
                         needs_io=needs_io) is not None:
                best = max(best, mid * w)
                lo = mid + 1
            else:
                hi = mid - 1
    return 1.0 - best / free if free else 0.0


def sink_tiles_by_app(designs: Dict[str, RoutedDesign]
                      ) -> Dict[str, List[Tile]]:
    """Each resident's flush destinations: the tiles of its stateful
    placeable nodes (one placed stamp copy per app)."""
    return {name: [d.placement[n] for n in stateful_nodes(d.netlist)]
            for name, d in designs.items()}


@dataclass
class MultiAppResult:
    """One fabric-sharing compile: N resident apps, one shared flush."""

    name: str
    fabric: Fabric
    regions: Dict[str, Region]               # app name -> owned region
    results: List                            # per-app CompileResult, in order
    flush: SharedFlushReport
    summary: Dict[str, object] = field(default_factory=dict)

    def result_for(self, app_name: str):
        for r in self.results:
            if r.app.name == app_name:
                return r
        raise KeyError(f"no resident named {app_name!r}")

    def per_app_rows(self) -> List[dict]:
        """One summary row per resident (benchmark table shape)."""
        rows = []
        for r in self.results:
            region = self.regions[r.app.name]
            rows.append({
                "app": r.app.name,
                "region": f"{region.rows}x{region.cols}@c{region.col0}",
                **r.summary(),
            })
        return rows


def assemble_pack(name: str, fabric: Fabric, results: Sequence,
                  regions: Dict[str, Region], timing=None, energy=None,
                  harden: bool = True) -> MultiAppResult:
    """Build a :class:`MultiAppResult` from already-compiled residents.

    The shared tail of ``compile_multi`` and the online scheduler
    (:mod:`repro_torch.core.sched`), which re-assembles the pack after every
    admit/evict/re-pack event: one shared flush over every resident's
    stateful sinks, then the fabric-level rollup at the shared clock.
    ``timing=None`` skips the flush model's frequency cap (the
    single-app passthrough case, whose own compile already timed its
    flush).
    """
    designs = {r.app.name: r.design for r in results}
    flush = shared_flush(sink_tiles_by_app(designs), fabric, tm=timing,
                         harden=harden)
    summary = fabric_report(results, regions, fabric, flush, energy=energy)
    return MultiAppResult(name=name, fabric=fabric, regions=dict(regions),
                          results=list(results), flush=flush,
                          summary=summary)


def fabric_report(results: Sequence, regions: Dict[str, Region],
                  fabric: Fabric, flush: SharedFlushReport,
                  energy=None) -> dict:
    """The fabric-level rollup of a pack (freq = min, power/EDP summed).

    Frequency/power/EDP flow through the per-app report chains (each a
    :func:`repro_torch.core.metrics.evaluate_design` product) and are combined
    by :func:`repro_torch.core.metrics.combine_metrics` — with ``energy`` given,
    every resident's power is re-evaluated at the shared fabric clock
    before summing (one fabric, one clock); utilization counts the tiles
    each resident's placed copy occupies, scaled by its stamp count.
    """
    per_app = {r.app.name: DesignMetrics(sta=r.sta, schedule=r.schedule,
                                         power=r.power)
               for r in results}
    combined = combine_metrics(per_app, flush_critical_ns=flush.critical_ns,
                               designs={r.app.name: r.design
                                        for r in results},
                               energy=energy)
    occupied = 0
    region_util: Dict[str, float] = {}
    for r in results:
        tiles = {t for t in r.design.placement.values() if t[0] >= 0}
        used = len(tiles) * max(1, r.design.unroll_copies)
        occupied += used
        area = regions[r.app.name].area()
        region_util[r.app.name] = round(used / area, 4) if area else 0.0
    combined.update({
        "utilization": round(occupied / (fabric.rows * fabric.cols), 4),
        "region_utilization": region_util,
        "registers": sum(r.design.physical_register_count()
                         for r in results),
        **flush.summary(),
    })
    return combined
