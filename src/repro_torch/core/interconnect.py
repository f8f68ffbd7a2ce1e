"""CGRA fabric model — a Canal-style interconnect graph.

Models the target CGRA class of the paper (Amber/AHA-like): a ``rows x cols``
grid of PE and MEM tiles (every ``mem_col_stride``-th column is a MEM column;
default 32x16 = 384 PE + 128 MEM tiles), IO tiles on the north edge,
``tracks16``/``tracks1`` routing tracks per tile boundary per direction, a
switch box in every tile with an optional pipelining register on every
outgoing track in every direction, and single-cycle multi-hop routing.

Routing resources are modelled at tile-boundary granularity: a directed hop
(tile -> adjacent tile) consumes one track of the matching width and passes
through the source tile's switch box.  This keeps everything the paper's
results depend on — hop counts, per-tile-type delays, congestion, register
sites per hop — while staying graph-level (no RTL).

Multi-app fabric sharing (:mod:`repro.core.multi`) adds *regions*: a
:class:`Region` is a rectangular window in global fabric coordinates that
one co-resident application owns, and ``Fabric.subregion(region)`` returns
a masked view of the same fabric whose ``tiles()`` / ``neighbors()`` never
leave the window.  Coordinates stay global so tile kinds (the MEM-column
pattern) and timing lookups are identical to the full fabric's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

Tile = Tuple[int, int]          # (row, col); row -1 = IO row on the north edge

N, S, E, W = "N", "S", "E", "W"
DIRS: Dict[str, Tile] = {N: (-1, 0), S: (1, 0), E: (0, 1), W: (0, -1)}


@dataclass(frozen=True)
class Region:
    """A rectangular sub-fabric window, in *global* fabric coordinates.

    ``(row0, col0)`` is the north-west corner; ``rows``/``cols`` the extent.
    North-edge IO tiles (row -1) belong to the region owning their column,
    but only when the region touches the north row — an interior region has
    no IO access on this CGRA class (the global buffer streams in from the
    north edge only), which is why the multi-app packer allocates full-
    height column strips.
    """

    row0: int
    col0: int
    rows: int
    cols: int

    @property
    def row1(self) -> int:          # exclusive
        return self.row0 + self.rows

    @property
    def col1(self) -> int:          # exclusive
        return self.col0 + self.cols

    @classmethod
    def full(cls, fabric: "Fabric") -> "Region":
        return cls(0, 0, fabric.rows, fabric.cols)

    def contains(self, t: Tile) -> bool:
        r, c = t
        if r == -1:
            return self.row0 == 0 and self.col0 <= c < self.col1
        return self.row0 <= r < self.row1 and self.col0 <= c < self.col1

    def overlaps(self, other: "Region") -> bool:
        return not (self.col1 <= other.col0 or other.col1 <= self.col0 or
                    self.row1 <= other.row0 or other.row1 <= self.row0)

    def area(self) -> int:
        return self.rows * self.cols

    def covers(self, fabric: "Fabric") -> bool:
        return (self.row0 == 0 and self.col0 == 0 and
                self.rows == fabric.rows and self.cols == fabric.cols)


@dataclass(frozen=True)
class Hop:
    """One directed tile-boundary crossing (through ``src``'s switch box)."""
    src: Tile
    dst: Tile

    @property
    def direction(self) -> str:
        dr, dc = self.dst[0] - self.src[0], self.dst[1] - self.src[1]
        return {(-1, 0): N, (1, 0): S, (0, 1): E, (0, -1): W}[(dr, dc)]


@dataclass
class Fabric:
    rows: int = 32
    cols: int = 16
    mem_col_stride: int = 4          # every 4th column is a MEM column
    tracks16: int = 5                # 16-bit tracks per boundary per direction
    tracks1: int = 5                 # 1-bit tracks per boundary per direction
    name: str = "amber32x16"

    def tile_kind(self, t: Tile) -> str:
        r, c = t
        if r == -1:
            return "io"
        if not (0 <= r < self.rows and 0 <= c < self.cols):
            raise ValueError(f"tile {t} outside fabric")
        return "mem" if (c % self.mem_col_stride) == (self.mem_col_stride - 1) else "pe"

    def tiles(self, kind: Optional[str] = None) -> List[Tile]:
        out = []
        if kind in (None, "io"):
            out += [(-1, c) for c in range(self.cols)]
        for r in range(self.rows):
            for c in range(self.cols):
                if kind is None or self.tile_kind((r, c)) == kind:
                    out.append((r, c))
        return out

    def pe_tiles(self) -> List[Tile]:
        return self.tiles("pe")

    def mem_tiles(self) -> List[Tile]:
        return self.tiles("mem")

    def io_tiles(self) -> List[Tile]:
        return [(-1, c) for c in range(self.cols)]

    def in_bounds(self, t: Tile) -> bool:
        r, c = t
        return (r == -1 or 0 <= r < self.rows) and 0 <= c < self.cols

    def neighbors(self, t: Tile) -> List[Tile]:
        r, c = t
        if r == -1:  # IO tiles connect only downward into their column
            return [(0, c)]
        out = []
        for dr, dc in DIRS.values():
            nt = (r + dr, c + dc)
            if nt[0] == -1:
                out.append(nt)
            elif 0 <= nt[0] < self.rows and 0 <= nt[1] < self.cols:
                out.append(nt)
        return out

    def track_capacity(self, width: int) -> int:
        return self.tracks16 if width >= 16 else self.tracks1

    def counts(self) -> dict:
        return {
            "pe": len(self.pe_tiles()),
            "mem": len(self.mem_tiles()),
            "io": len(self.io_tiles()),
            "total": self.rows * self.cols,
        }

    def subfabric(self, rows: int, cols: int) -> "Fabric":
        """A smaller window with the same column pattern (for low unrolling)."""
        return Fabric(rows=rows, cols=cols, mem_col_stride=self.mem_col_stride,
                      tracks16=self.tracks16, tracks1=self.tracks1,
                      name=f"{self.name}_sub{rows}x{cols}")

    def subregion(self, region: Region) -> "SubFabric":
        """A region-masked view of this fabric (multi-app fabric sharing).

        Unlike :meth:`subfabric` — which re-origins a smaller fabric for the
        low-unrolling stamp — the returned view keeps *global* coordinates:
        ``tile_kind``/``track_capacity`` behave exactly as on the parent,
        while ``tiles()`` and ``neighbors()`` are masked to ``region`` so a
        placement or route computed against the view can never leave the
        window an application owns.
        """
        if not (0 <= region.row0 and region.rows > 0 and
                region.row1 <= self.rows and
                0 <= region.col0 and region.cols > 0 and
                region.col1 <= self.cols):
            raise ValueError(f"region {region} outside fabric "
                             f"{self.rows}x{self.cols}")
        return SubFabric(
            rows=self.rows, cols=self.cols,
            mem_col_stride=self.mem_col_stride,
            tracks16=self.tracks16, tracks1=self.tracks1,
            name=(f"{self.name}_r{region.row0}.{region.col0}"
                  f"+{region.rows}x{region.cols}"),
            region=region)


@dataclass
class SubFabric(Fabric):
    """A :class:`Region`-masked view of a parent fabric (global coordinates).

    Construct via :meth:`Fabric.subregion`.  Tile enumeration and adjacency
    are restricted to the region (IO tiles only when the region touches the
    north edge); everything coordinate-keyed — ``tile_kind``, timing-model
    lookups, routing-track capacities — is inherited unchanged, so designs
    placed on the view compose disjointly on the shared parent fabric.
    """

    region: Optional[Region] = None

    def tiles(self, kind: Optional[str] = None) -> List[Tile]:
        return [t for t in super().tiles(kind) if self.region.contains(t)]

    def io_tiles(self) -> List[Tile]:
        if self.region.row0 != 0:
            return []
        return [(-1, c) for c in range(self.region.col0, self.region.col1)]

    def neighbors(self, t: Tile) -> List[Tile]:
        return [n for n in super().neighbors(t) if self.region.contains(n)]

    def counts(self) -> dict:
        return {
            "pe": len(self.pe_tiles()),
            "mem": len(self.mem_tiles()),
            "io": len(self.io_tiles()),
            "total": self.region.area(),
        }


def manhattan(a: Tile, b: Tile) -> int:
    return abs(a[0] - b[0]) + abs(a[1] - b[1])
