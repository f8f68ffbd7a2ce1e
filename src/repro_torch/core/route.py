"""Iteration-based (PathFinder-style) routing on the CGRA interconnect
(paper Section V-C: "an iteration-based routing algorithm").

Each driver's fanout is routed as a tree: the first sink gets an A* path from
the driver, later sinks join the nearest point of the existing tree.  Track
overuse is negotiated across iterations — every boundary edge has
``fabric.track_capacity(width)`` tracks per direction; overused edges get a
growing history cost and the nets crossing them are ripped up and rerouted.

``RouteParams.backend`` selects the inner-loop kernel: ``"scalar"`` and
``"numpy"`` are both this module's Python A* (the router never had a
separate vectorized path — the names exist so ``PassConfig.pnr_backend``
means the same thing at both PnR stages), while ``"torch"`` swaps in the
batched wavefront relaxation of :mod:`repro_torch.core.route_torch`, which
routes every dirty driver of a width class in one batched device program.
Both backends produce the same ``driver -> branch -> tile path`` map and
share the finalization below (region containment check, hop construction,
register distribution), so post-route legality is checked identically.

After routing, each branch distributes its ``n_regs`` pipelining registers
evenly along its hops (post-PnR pipelining later adds registers at chosen
sites).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .config import PNR_BACKENDS
from .interconnect import Fabric, Hop, Region, Tile, manhattan
from .netlist import Branch, Netlist, RoutedBranch, RoutedDesign


@dataclass
class RouteParams:
    max_iters: int = 12
    present_fac: float = 2.0
    history_fac: float = 0.7
    backend: Optional[str] = None    # None -> "numpy" (the Python A* path)

    def resolved_backend(self) -> str:
        b = self.backend or "numpy"
        if b not in PNR_BACKENDS:
            raise ValueError(
                f"unknown route backend {b!r}; expected one of "
                f"{PNR_BACKENDS}")
        return b


def _astar(fabric: Fabric, srcs: Dict[Tile, float], dst: Tile,
           edge_cost) -> Optional[List[Tile]]:
    """Multi-source A* over tiles; returns tile path from a source to dst."""
    pq = [(manhattan(s, dst) + c0, c0, s) for s, c0 in srcs.items()]
    heapq.heapify(pq)
    came: Dict[Tile, Optional[Tile]] = {s: None for s in srcs}
    gscore: Dict[Tile, float] = {s: c0 for s, c0 in srcs.items()}
    while pq:
        _, g, cur = heapq.heappop(pq)
        if cur == dst:
            path = [cur]
            while came[cur] is not None:
                cur = came[cur]
                path.append(cur)
            return path[::-1]
        if g > gscore.get(cur, float("inf")):
            continue
        for nxt in fabric.neighbors(cur):
            ng = g + edge_cost(cur, nxt)
            if ng < gscore.get(nxt, float("inf")):
                gscore[nxt] = ng
                came[nxt] = cur
                heapq.heappush(pq, (ng + manhattan(nxt, dst), ng, nxt))
    return None


def route(nl: Netlist, placement: Dict[str, Tile], fabric: Fabric,
          params: Optional[RouteParams] = None,
          region: Optional[Region] = None,
          device=None) -> RoutedDesign:
    """Route every branch; with ``region`` (multi-app fabric sharing) the
    routes are *fenced*: any edge that would cross the region boundary into
    a foreign sub-fabric costs ``inf``, so the search never relaxes through
    it and no hop of a resident's net can consume a neighbour's routing
    tracks.  A post-route containment check backstops the fence.

    ``device`` is read by the ``"torch"`` backend only: ``None`` is the
    card, and without CUDA that raises unless the CPU is asked for."""
    p = params or RouteParams()
    backend = p.resolved_backend()
    width_class = lambda w: 16 if w >= 16 else 1

    # group branches by driver (routing trees)
    by_driver: Dict[str, List[Branch]] = {}
    for b in nl.branches:
        by_driver.setdefault(b.driver, []).append(b)

    if backend == "torch":
        from .route_torch import route_trees_torch
        tree_paths = route_trees_torch(nl, placement, fabric, by_driver, p,
                                       region, device=device)
        return _finalize(nl, placement, fabric, by_driver, tree_paths,
                         region)

    history: Dict[Tuple[Tile, Tile, int], float] = {}
    usage: Dict[Tuple[Tile, Tile, int], int] = {}
    tree_paths: Dict[str, Dict[Tuple[str, str, int], List[Tile]]] = {}

    # static per-width-class tables, hoisted out of the per-driver loop:
    # the closures used to be rebuilt per routed driver and called
    # ``fabric.track_capacity`` once per relaxed edge
    cap = {wc: fabric.track_capacity(wc) for wc in (1, 16)}

    def edge_cost_fn(wc: int):
        wc_cap = cap[wc]

        def cost(a: Tile, b: Tile) -> float:
            if region is not None and not (region.contains(a)
                                           and region.contains(b)):
                return math.inf          # region fence: foreign boundary
            key = (a, b, wc)
            over = max(0, usage.get(key, 0) + 1 - wc_cap)
            return 1.0 + p.present_fac * over + history.get(key, 0.0)
        return cost

    cost_fns = {wc: edge_cost_fn(wc) for wc in (1, 16)}

    def add_usage(drv: str, path_edges: Set[Tuple[Tile, Tile]], wc: int, sign: int):
        for a, b in path_edges:
            key = (a, b, wc)
            usage[key] = usage.get(key, 0) + sign

    def route_driver(drv: str) -> Dict[Tuple[str, str, int], List[Tile]]:
        """Route all branches of one driver as a tree; returns per-branch tile
        paths (driver tile ... sink tile)."""
        branches = sorted(by_driver[drv],
                          key=lambda b: manhattan(placement[drv], placement[b.sink]))
        wc = width_class(branches[0].width)
        src_tile = placement[drv]
        # tree: tile -> tile path from driver to that tile
        tree: Dict[Tile, List[Tile]] = {src_tile: [src_tile]}
        out: Dict[Tuple[str, str, int], List[Tile]] = {}
        cost = cost_fns[wc]
        for b in branches:
            dst = placement[b.sink]
            if dst in tree:
                out[b.key] = list(tree[dst])
                continue
            srcs = {t: 0.0 for t in tree}
            path = _astar(fabric, srcs, dst, cost)
            if path is None:
                raise RuntimeError(f"unroutable: {drv} -> {b.sink}")
            join = path[0]
            full = tree[join][:-1] + path
            out[b.key] = full
            for i in range(len(path) - 1):
                t = path[i + 1]
                if t not in tree:
                    tree[t] = tree[path[i]] + [t]
        return out

    drivers = list(by_driver)
    dirty = set(drivers)
    for it in range(p.max_iters):
        for drv in drivers:
            if drv not in dirty:
                continue
            wc = width_class(by_driver[drv][0].width)
            if drv in tree_paths:  # rip up
                edges = {(pth[i], pth[i + 1])
                         for pth in tree_paths[drv].values()
                         for i in range(len(pth) - 1)}
                add_usage(drv, edges, wc, -1)
            tree_paths[drv] = route_driver(drv)
            edges = {(pth[i], pth[i + 1])
                     for pth in tree_paths[drv].values()
                     for i in range(len(pth) - 1)}
            add_usage(drv, edges, wc, +1)
        # find overuse
        over = {k for k, u in usage.items() if u > cap[k[2]]}
        if not over:
            break
        for k in over:
            history[k] = history.get(k, 0.0) + p.history_fac
        dirty = set()
        for drv in drivers:
            wc = width_class(by_driver[drv][0].width)
            for pth in tree_paths[drv].values():
                if any((pth[i], pth[i + 1], wc) in over
                       for i in range(len(pth) - 1)):
                    dirty.add(drv)
                    break
    else:
        over = {k for k, u in usage.items() if u > cap[k[2]]}
        if over:
            raise RuntimeError(
                f"{nl.name}: routing did not converge, {len(over)} overused "
                f"boundaries after {p.max_iters} iterations")

    return _finalize(nl, placement, fabric, by_driver, tree_paths, region)


def _finalize(nl: Netlist, placement: Dict[str, Tile], fabric: Fabric,
              by_driver: Dict[str, List[Branch]],
              tree_paths: Dict[str, Dict[Tuple[str, str, int], List[Tile]]],
              region: Optional[Region]) -> RoutedDesign:
    """Shared post-route step for every backend: region containment check,
    hop construction, register distribution."""
    routes: Dict[Tuple[str, str, int], RoutedBranch] = {}
    for drv, paths in tree_paths.items():
        for b in by_driver[drv]:
            pth = paths[b.key]
            if region is not None:
                stray = [t for t in pth if not region.contains(t)]
                if stray:
                    raise RuntimeError(
                        f"{nl.name}: route {drv} -> {b.sink} left region "
                        f"{region} at {stray[:3]}")
            hops = [Hop(pth[i], pth[i + 1]) for i in range(len(pth) - 1)]
            rb = RoutedBranch(branch=b, hops=hops)
            rb.distribute_registers()
            routes[b.key] = rb
    return RoutedDesign(netlist=nl, placement=placement, routes=routes,
                        fabric=fabric)


def check_legal(nl: Netlist, placement: Dict[str, Tile], fabric: Fabric,
                design: Optional[RoutedDesign] = None,
                region: Optional[Region] = None) -> None:
    """Raise ``RuntimeError`` unless the placement (and, given, the routed
    design) is legal for any backend: class-correct tiles, no PE/MEM site
    shared, IO tiles at most ``IO_CAPACITY`` deep; routes connected from
    the driver's tile to the sink's over fabric edges, within track
    capacity; with a ``region``, every tile and hop inside it."""
    from .place import IO_CAPACITY, TILE_CLASS

    def fail(msg):
        raise RuntimeError(f"{nl.name}: {msg}")

    if set(placement) != set(nl.nodes):
        fail("placement does not cover the netlist's nodes")
    seen, io_load = set(), {}
    for name, tile in placement.items():
        kind = TILE_CLASS[nl.nodes[name].kind]
        if fabric.tile_kind(tile) != kind:
            fail(f"{name} on {tile}, not a {kind} tile")
        if region is not None and not region.contains(tile):
            fail(f"{name} on {tile}, outside {region}")
        if kind == "io":
            io_load[tile] = io_load.get(tile, 0) + 1
        elif tile in seen:
            fail(f"site conflict at {tile}")
        else:
            seen.add(tile)
    if any(v > IO_CAPACITY for v in io_load.values()):
        fail("IO tile over capacity")
    if design is None:
        return
    usage: Dict[Tuple[Tile, Tile, int], Set[str]] = {}
    for (drv, sink, _), rb in design.routes.items():
        tiles = ([rb.hops[0].src] + [h.dst for h in rb.hops]
                 if rb.hops else [placement[drv]])
        if (tiles[0], tiles[-1]) != (placement[drv], placement[sink]):
            fail(f"route {drv} -> {sink} misses its ends")
        if any(a.dst != b.src for a, b in zip(rb.hops, rb.hops[1:])) or any(
                h.dst not in fabric.neighbors(h.src) for h in rb.hops):
            fail(f"route {drv} -> {sink} is not connected")
        if region is not None and not all(region.contains(t) for t in tiles):
            fail(f"route {drv} -> {sink} leaves {region}")
        wc = 16 if rb.branch.width >= 16 else 1
        for e in {(h.src, h.dst, wc) for h in rb.hops}:
            usage.setdefault(e, set()).add(drv)
    over = [e for e, d in usage.items() if len(d) > fabric.track_capacity(e[2])]
    if over:
        fail(f"{len(over)} overused boundaries: {over[:3]}")
