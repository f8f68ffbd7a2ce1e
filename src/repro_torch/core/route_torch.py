"""Batched wavefront routing on a torch device — the ``"torch"`` PnR
backend of :func:`repro_torch.core.route.route`.

The port of the reference's batched router (``repro.core.route_jax``).
The Python router (:mod:`repro_torch.core.route`) grows each driver's
fanout tree with one A* search per sink, one driver at a time.  This module
keeps the outer PathFinder negotiation loop on the host but routes every
*dirty* driver of a width class in one batched device program.  Per driver
it takes the sinks in the same nearest-first order as the A* path and, per
sink, runs a multi-source Bellman–Ford *wavefront* relaxation over the
dense ``(T, 4)`` in-edge cost array (T = every tile including the north IO
row), all drivers at once as a ``(D, T, 4)`` batch: distances start at 0
on the current tree and every tile relaxes its four in-edges per sweep
until no distance improves.  The new branch is then recovered from the
parent pointers: the tiles from the sink back to the tree are marked by
pointer doubling, and ordered by distance (which falls strictly towards
the tree, every edge costing at least 1).

Congestion pricing matches the Python path: an edge costs
``1 + present_fac * max(0, usage + 1 - cap) + history``, region-fenced
edges cost ``inf`` (the relaxation can never cross them), and overused
boundaries accrue history cost between iterations.  As in the reference,
all dirty drivers of an iteration price against one frozen usage snapshot
(classic parallel PathFinder), so tree shapes are not A*'s where
equal-cost paths tie, but the same legality holds (connected trees, region
fence, capacity negotiation with the same non-convergence error) and the
router has no RNG at all: ties break by the fixed direction order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .interconnect import Fabric, Region, Tile, manhattan
from .netlist import Branch, Netlist

# direction order of the dense edge axes: matches interconnect.DIRS
_DIRS = ((-1, 0), (1, 0), (0, 1), (0, -1))          # N, S, E, W

#: relaxation sweeps between two reads of the convergence flag (each read
#: waits for the device).  A sweep at the fixpoint improves nothing and so
#: changes neither distances nor parents: running up to this many sweeps
#: past the fixpoint gives the same result as stopping at the first sweep
#: that improves nothing, as the reference's ``while_loop`` does.
SWEEPS_PER_CHECK = 4


def _tile_tables(fabric: Fabric, region: Optional[Region]):
    """Dense adjacency for the (rows+1) x cols tile grid (IO row included).

    Returns ``(T, out_nbr, in_src, in_dir)``: ``out_nbr[t, d]`` is the tile
    id reached from ``t`` in direction ``d`` (-1 when absent or when the
    edge would cross the region fence), and ``in_src/in_dir`` invert it —
    edge ``in_src[t, k] --in_dir[t, k]--> t`` exists for ``in_src >= 0``.
    """
    rows, cols = fabric.rows, fabric.cols
    T = (rows + 1) * cols

    def tid(t: Tile) -> int:
        return (t[0] + 1) * cols + t[1]

    out_nbr = np.full((T, 4), -1, dtype=np.int32)
    for t in fabric.tiles():
        allowed = set(fabric.neighbors(t))
        for d, (dr, dc) in enumerate(_DIRS):
            nt = (t[0] + dr, t[1] + dc)
            if nt not in allowed:
                continue
            if region is not None and not (region.contains(t)
                                           and region.contains(nt)):
                continue                      # region fence
            out_nbr[tid(t), d] = tid(nt)

    in_src = np.full((T, 4), -1, dtype=np.int32)
    in_dir = np.zeros((T, 4), dtype=np.int32)
    fill = np.zeros(T, dtype=np.int32)
    for u in range(T):
        for d in range(4):
            v = out_nbr[u, d]
            if v < 0:
                continue
            k = fill[v]
            in_src[v, k] = u
            in_dir[v, k] = d
            fill[v] += 1
    return T, out_nbr, in_src, in_dir


def _route_batch(in_src: np.ndarray, in_dir: np.ndarray,
                 cost_out: np.ndarray, drv_tile: np.ndarray,
                 sink_tiles: np.ndarray, device: torch.device
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Grow ``D`` driver trees over ``T`` tiles on ``device``, sink by sink.

    The reference's ``_jitted_router`` with its ``vmap`` over drivers as the
    leading axis.  A pad sink (``-1``) routes nothing.  Returns
    ``(paths, dcosts)``: ``paths[d, s]`` lists the new branch's tiles from
    the sink back to its join tile on the tree, then ``-1`` padding;
    ``dcosts[d, s]`` is the sink's distance from the tree (``inf`` when
    unreachable).
    """
    dev = device
    T = in_src.shape[0]
    D, S = sink_tiles.shape
    inf = float("inf")
    src_t = torch.as_tensor(in_src, dtype=torch.int64, device=dev)
    has = src_t >= 0
    src = src_t.clamp_min(0)
    cost = torch.as_tensor(cost_out, device=dev)
    dir_t = torch.as_tensor(in_dir, dtype=torch.int64, device=dev)
    # in_cost[t, k]: cost of in-edge in_src[t, k] -> t (inf when absent)
    in_cost = torch.where(has, cost[src, dir_t], inf)
    iota = torch.arange(T, device=dev)
    rows = torch.arange(D, device=dev)
    # in_tree and the parent pointers carry a sentinel tile T
    in_tree = torch.zeros(D, T + 1, dtype=torch.bool, device=dev)
    in_tree[rows, torch.as_tensor(drv_tile, dtype=torch.int64,
                                  device=dev)] = True
    sinks = torch.as_tensor(sink_tiles, dtype=torch.int64, device=dev)
    sentinel = torch.full((D, 1), T, dtype=torch.int64, device=dev)
    doublings = max(1, math.ceil(math.log2(T + 1)))
    paths = torch.full((D, S, T), -1, dtype=torch.int64, device=dev)
    dcosts = torch.full((D, S), inf, dtype=torch.float32, device=dev)
    # sinks are nearest-first and padded at the end of each row, so past
    # the longest row every column is padding and routes nothing
    n_real = int((sink_tiles >= 0).sum(1).max()) if D else 0
    for s in range(n_real):
        dst = sinks[:, s]
        dist = torch.where(in_tree[:, :T], 0.0, inf)     # (D, T) f32
        parent = torch.full((D, T), -1, dtype=torch.int64, device=dev)
        while True:
            for _ in range(SWEEPS_PER_CHECK):
                cand = torch.where(has, dist[:, src] + in_cost, inf)
                k = cand.argmin(-1)                      # first minimum
                best = cand.gather(-1, k[..., None]).squeeze(-1)
                improved = best < dist
                dist = torch.where(improved, best, dist)
                parent = torch.where(improved, src_t[iota, k], parent)
            if not bool(improved.any()):
                break
        # the tiles from the sink back to the join: tree tiles keep parent
        # -1 (distance 0 never improves), so the walk stops there, as the
        # reference's back-walk does.  Mark them by pointer doubling over
        # ptr (parent, or the sentinel), which reaches 2^k steps up after
        # k rounds.
        ptr = torch.cat([torch.where(parent >= 0, parent, T), sentinel], 1)
        on = torch.zeros(D, T + 1, dtype=torch.uint8, device=dev)
        on[rows, torch.where(dst >= 0, dst, T)] = 1
        for _ in range(doublings):
            on = on.scatter_reduce(1, ptr, on, reduce="amax")
            ptr = ptr.gather(1, ptr)
        on_path = on[:, :T].bool()
        in_tree[:, :T] |= on_path
        # emit sink first, join last: distance falls strictly to the tree
        order = torch.where(on_path, dist, -1.0).argsort(1, descending=True)
        paths[:, s] = torch.where(iota < on_path.sum(1, keepdim=True),
                                  order, -1)
        dcosts[:, s] = dist.gather(1, dst.clamp_min(0)[:, None])[:, 0]
    return paths.cpu().numpy(), dcosts.cpu().numpy()


def _edge_costs(usage: np.ndarray, history: np.ndarray, valid: np.ndarray,
                cap: int, present_fac: float) -> np.ndarray:
    """Dense congestion-priced out-edge costs (the Python ``cost()``,
    vectorized): ``1 + present_fac * max(0, usage + 1 - cap) + history``."""
    over = np.maximum(0, usage + 1 - cap).astype(np.float32)
    cost = 1.0 + present_fac * over + history
    return np.where(valid, cost, np.inf).astype(np.float32)


def _pad_pow2(k: int, lo: int = 1) -> int:
    return max(lo, 1 << (max(k, 1) - 1).bit_length())


def route_trees_torch(nl: Netlist, placement: Dict[str, Tile],
                      fabric: Fabric, by_driver: Dict[str, List[Branch]], p,
                      region: Optional[Region], device=None) -> Dict[
                          str, Dict[Tuple[str, str, int], List[Tile]]]:
    """Run the full negotiation loop with the batched router on ``device``
    (the card unless the caller asks for the CPU); returns the same
    ``driver -> branch-key -> tile path`` map the Python router builds
    (``route()`` finalizes both identically)."""
    dev = resolve_device(device)
    T, out_nbr, in_src, in_dir = _tile_tables(fabric, region)
    cols = fabric.cols
    tid = lambda t: (t[0] + 1) * cols + t[1]
    untid = lambda i: (i // cols - 1, i % cols)
    width_class = lambda w: 16 if w >= 16 else 1

    valid = out_nbr >= 0
    cap = {wc: fabric.track_capacity(wc) for wc in (1, 16)}
    usage = {wc: np.zeros((T, 4), dtype=np.int32) for wc in (1, 16)}
    history = {wc: np.zeros((T, 4), dtype=np.float32) for wc in (1, 16)}

    # nearest-first sink order per driver — same growth order as the A* tree
    order: Dict[str, List[Branch]] = {
        drv: sorted(bs, key=lambda b: manhattan(placement[drv],
                                                placement[b.sink]))
        for drv, bs in by_driver.items()}
    drv_wc = {drv: width_class(bs[0].width) for drv, bs in by_driver.items()}

    tree_paths: Dict[str, Dict[Tuple[str, str, int], List[Tile]]] = {}
    tree_edges: Dict[str, set] = {}

    def _dir_of(a: Tile, b: Tile) -> int:
        return _DIRS.index((b[0] - a[0], b[1] - a[1]))

    def edges_of(paths: Dict[Tuple[str, str, int], List[Tile]]) -> set:
        return {(tid(pth[i]), _dir_of(pth[i], pth[i + 1]))
                for pth in paths.values()
                for i in range(len(pth) - 1)}

    drivers = list(by_driver)
    dirty = set(drivers)
    for it in range(p.max_iters):
        # rip up every dirty driver first: the whole batch prices against
        # one frozen usage snapshot (parallel PathFinder)
        for drv in dirty:
            if drv in tree_edges:
                wc = drv_wc[drv]
                for t, d in tree_edges[drv]:
                    usage[wc][t, d] -= 1
        for wc in (1, 16):
            batch = [d for d in drivers if d in dirty and drv_wc[d] == wc]
            if not batch:
                continue
            # padded to powers of two, so that a batch takes one of a few
            # shapes (as the reference's jit cache, and a later CUDA-graph
            # capture, want)
            S = _pad_pow2(max(len(order[d]) for d in batch))
            D = _pad_pow2(len(batch))
            drv_tile = np.zeros(D, dtype=np.int32)
            sink_tiles = np.full((D, S), -1, dtype=np.int32)
            for i, drv in enumerate(batch):
                drv_tile[i] = tid(placement[drv])
                for s, b in enumerate(order[drv]):
                    sink_tiles[i, s] = tid(placement[b.sink])
            cost_out = _edge_costs(usage[wc], history[wc], valid,
                                   cap[wc], p.present_fac)
            paths, dcosts = _route_batch(in_src, in_dir, cost_out,
                                         drv_tile, sink_tiles, dev)
            for i, drv in enumerate(batch):
                tree: Dict[Tile, List[Tile]] = {
                    placement[drv]: [placement[drv]]}
                out: Dict[Tuple[str, str, int], List[Tile]] = {}
                for s, b in enumerate(order[drv]):
                    if not math.isfinite(dcosts[i, s]):
                        raise RuntimeError(f"unroutable: {drv} -> {b.sink}")
                    raw = paths[i, s]
                    part = [untid(int(x)) for x in raw[raw >= 0]][::-1]
                    join = part[0]
                    out[b.key] = tree[join][:-1] + part
                    for j in range(len(part) - 1):
                        t = part[j + 1]
                        if t not in tree:
                            tree[t] = tree[part[j]] + [t]
                tree_paths[drv] = out
                tree_edges[drv] = edges_of(out)
                for t, d in tree_edges[drv]:
                    usage[wc][t, d] += 1

        over = {wc: usage[wc] > cap[wc] for wc in (1, 16)}
        if not any(o.any() for o in over.values()):
            break
        dirty = set()
        for wc in (1, 16):
            if not over[wc].any():
                continue
            history[wc] += np.where(over[wc], p.history_fac, 0.0)
            hot = {(t, d) for t, d in zip(*np.nonzero(over[wc]))}
            for drv in drivers:
                if drv_wc[drv] == wc and tree_edges[drv] & hot:
                    dirty.add(drv)
    else:
        n_over = int(sum(o.sum() for o in over.values()))
        if n_over:
            raise RuntimeError(
                f"{nl.name}: routing did not converge, {n_over} overused "
                f"boundaries after {p.max_iters} iterations")
    return tree_paths
