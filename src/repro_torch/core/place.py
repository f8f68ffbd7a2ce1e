"""Simulated-annealing placement (paper Section V-C).

Detailed-placement cost per net:

    Cost_net = (HPWL_net + gamma * Area_passthrough)^alpha          (Eq. 1)

``gamma`` penalizes pass-through tiles (tiles used only for routing,
approximated pre-route by the net bounding-box interior) and ``alpha`` is the
*criticality exponent* Cascade adds: with alpha > 1 long routes cost
super-linearly more, trading total wirelength for shorter maximum net length
(similar to timing-driven FPGA placement [Marquardt et al.]).

Costs are maintained incrementally — a move only re-scores nets incident to
the touched sites — in a flat ``net_costs`` array, and the incremental
running cost is resynced against ``net_costs.sum()`` at every temperature
step so float drift cannot accumulate silently (``PlaceParams.debug`` /
``CASCADE_PLACE_DEBUG`` additionally re-derives every net cost from scratch
and asserts agreement).

The inner loop is vectorized: net terminals live in a padded
``(n_nets, max_degree)`` index matrix (rows padded with the net's first
terminal, which leaves the bounding-box extremes unchanged), so one move
re-scores all its touched nets with a handful of numpy reductions instead
of per-net Python dict churn.  Move proposals and acceptance draws are
pre-drawn in per-temperature blocks; the scalar fallback
(``vectorized=False``) consumes the identical RNG stream and computes
bit-identical per-net costs, so both modes produce byte-identical
placements for the same seed.

IO tiles host up to ``IO_CAPACITY`` streams each (the global buffer exposes
several banks per array column).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import PNR_BACKENDS, place_debug
from .dfg import FIFO, INPUT, MEM, OUTPUT, PE, RF
from .interconnect import Fabric, Region, Tile
from .netlist import Netlist

# node kinds -> tile class they occupy
TILE_CLASS = {PE: "pe", RF: "pe", FIFO: "pe", MEM: "mem",
              INPUT: "io", OUTPUT: "io"}
IO_CAPACITY = 4


@dataclass
class PlaceParams:
    alpha: float = 1.0        # criticality exponent (1.0 = paper's baseline)
    gamma: float = 0.3        # pass-through penalty
    seed: int = 0
    moves_per_node: int = 400 # total move budget = moves_per_node * n
    t_factor: float = 0.92
    restarts: int = 1
    vectorized: bool = True   # batched net-cost evaluation (same results)
    debug: Optional[bool] = None   # None -> CASCADE_PLACE_DEBUG env flag
    resync_tol: float = 1e-6  # drift tolerance for the debug assertions
    # kernel backend: None resolves to "numpy"/"scalar" from ``vectorized``
    # (back-compat); "torch" runs the parallel-tempering annealer of
    # :mod:`repro_torch.core.place_torch` on a torch device (``replicas``
    # chains on a geometric temperature ladder, spread ``replica_spread``
    # apart, exchanging states after every temperature step; ``restarts``
    # is subsumed by the replica ensemble there).  ``replicas``/
    # ``replica_spread`` default to a netlist-size-adaptive policy (small
    # netlists get more, colder replicas plus a doubled ensemble budget —
    # they are cheap and their single-chain cost has high variance to beat).
    backend: Optional[str] = None
    replicas: Optional[int] = None
    replica_spread: Optional[float] = None
    proposal_block: int = 32  # torch: move proposals evaluated per step

    def resolved_backend(self) -> str:
        b = self.backend or ("numpy" if self.vectorized else "scalar")
        if b not in PNR_BACKENDS:
            raise ValueError(
                f"unknown place backend {b!r}; expected one of "
                f"{PNR_BACKENDS}")
        return b


class _Nets:
    """Net terminals as padded index matrices for vectorized HPWL eval."""

    def __init__(self, nl: Netlist):
        by_driver: Dict[str, List[str]] = {}
        for b in nl.branches:
            by_driver.setdefault(b.driver, []).append(b.sink)
        self.names = list(nl.nodes)
        self.idx = {n: i for i, n in enumerate(self.names)}
        self.nets: List[np.ndarray] = []
        self.net_of_node: Dict[int, List[int]] = {i: [] for i in range(len(self.names))}
        for drv, sinks in by_driver.items():
            term = np.array([self.idx[drv]] + sorted({self.idx[s] for s in sinks}))
            ni = len(self.nets)
            self.nets.append(term)
            for t in set(term.tolist()):
                self.net_of_node[t].append(ni)
        # padded (n_nets, max_degree) terminal matrix: short rows repeat the
        # net's first terminal, which leaves min/max extremes untouched;
        # term_count keeps the true terminal count for the area term.
        n_nets = len(self.nets)
        max_deg = max((len(t) for t in self.nets), default=1)
        self.term_mat = np.zeros((n_nets, max_deg), dtype=np.int64)
        self.term_count = np.zeros(n_nets, dtype=np.int64)
        for ni, t in enumerate(self.nets):
            self.term_mat[ni, :len(t)] = t
            self.term_mat[ni, len(t):] = t[0]
            self.term_count[ni] = len(t)
        # per-node sorted incident-net index arrays (move -> touched nets),
        # with the matching term_mat/term_count slices pre-gathered: the
        # common (non-swap) move re-scores exactly these rows
        self.node_nets = [np.array(sorted(self.net_of_node[i]), dtype=np.int64)
                          for i in range(len(self.names))]
        self.node_term_mat = [self.term_mat[t] for t in self.node_nets]
        self.node_term_count = [self.term_count[t] for t in self.node_nets]


def _net_cost(pos: np.ndarray, term: np.ndarray, gamma: float, alpha: float) -> float:
    """Scalar Eq. 1 reference — the vectorized kernel must match it bitwise.

    The exponent goes through ``np.power`` (not Python ``**``): the two can
    disagree in the last ulp, and bit-identity between the scalar and
    batched kernels is what makes the two annealer modes take identical
    accept/reject decisions.
    """
    rows = pos[term, 0]
    cols = pos[term, 1]
    w = int(cols.max() - cols.min())
    h = int(rows.max() - rows.min())
    hpwl = w + h
    area_pass = max(0, (w + 1) * (h + 1) - len(term))
    return float(np.power(np.float64(hpwl + gamma * area_pass), alpha))


def _net_cost_batch(pos: np.ndarray, term_mat: np.ndarray,
                    term_count: np.ndarray, gamma: float,
                    alpha: float) -> np.ndarray:
    """Eq. 1 for a batch of nets: one row of ``term_mat`` per net."""
    pts = pos[term_mat]                       # (nets, max_degree, 2)
    rows = pts[..., 0]
    cols = pts[..., 1]
    w = cols.max(axis=1) - cols.min(axis=1)
    h = rows.max(axis=1) - rows.min(axis=1)
    hpwl = w + h
    area_pass = np.maximum(0, (w + 1) * (h + 1) - term_count)
    return np.power(hpwl + gamma * area_pass, alpha)


def place(nl: Netlist, fabric: Fabric,
          params: Optional[PlaceParams] = None,
          stats: Optional[dict] = None,
          region: Optional[Region] = None,
          device=None) -> Dict[str, Tile]:
    """Anneal a placement; returns node -> tile.

    ``stats`` (optional dict) is filled with kernel counters: mode, move /
    acceptance counts, resyncs, and wall-clock seconds.

    ``region`` (multi-app fabric sharing) restricts the placement to a
    rectangular window the application owns: the site pools — and therefore
    every SA move proposal, on both the vectorized and the scalar kernel
    path, which share them — are filtered to in-region tiles, so a move
    outside the region is structurally rejected before it is ever scored.
    A final containment assertion backstops the invariant.

    ``device`` is read by the ``"torch"`` backend only: ``None`` is the
    card, and without CUDA that raises unless the CPU is asked for.
    """
    p = params or PlaceParams()
    backend = p.resolved_backend()
    vectorized = backend != "scalar"
    debug = place_debug() if p.debug is None else p.debug
    t_start = time.perf_counter()
    rng = np.random.default_rng(p.seed)
    nets = _Nets(nl)
    n = len(nets.names)
    cls = [TILE_CLASS[nl.nodes[name].kind] for name in nets.names]

    sites: Dict[str, List[Tile]] = {
        "pe": fabric.pe_tiles(),
        "mem": fabric.mem_tiles(),
        "io": fabric.io_tiles() * IO_CAPACITY,
    }
    if region is not None:
        sites = {c: [t for t in ts if region.contains(t)]
                 for c, ts in sites.items()}
    for c in ("pe", "mem", "io"):
        need = cls.count(c)
        if need > len(sites[c]):
            where = (f"fabric {fabric.name}" if region is None
                     else f"region {region} of fabric {fabric.name}")
            raise ValueError(
                f"{nl.name}: needs {need} {c} sites, {where} "
                f"has {len(sites[c])}")
    n_sites = np.array([len(sites[cls[i]]) for i in range(n)], dtype=np.int64)

    moves_evaluated = 0
    moves_accepted = 0
    resyncs = 0

    best_pos, best_cost = None, math.inf
    extra: dict = {}
    if backend == "torch":
        from .place_torch import anneal_torch

        best_pos, best_cost, tstats = anneal_torch(nets, cls, sites, p,
                                                   device=device)
        moves_evaluated = tstats["moves_evaluated"]
        moves_accepted = tstats["moves_accepted"]
        resyncs = tstats["resyncs"]
        extra = {k: tstats[k] for k in
                 ("replicas", "devices", "best_replica", "replica_costs")}
        restarts = 0          # the replica ensemble subsumes restarts
    else:
        restarts = max(1, p.restarts)
    for restart in range(restarts):
        pos = np.zeros((n, 2), dtype=np.int64)
        site_of: Dict[int, int] = {}
        occupant: Dict[Tuple[str, int], int] = {}
        for c in ("pe", "mem", "io"):
            members = [i for i in range(n) if cls[i] == c]
            chosen = rng.choice(len(sites[c]), size=len(members), replace=False)
            for i, si in zip(members, chosen):
                si = int(si)
                pos[i] = sites[c][si]
                site_of[i] = si
                occupant[(c, si)] = i

        net_costs = _net_cost_batch(pos, nets.term_mat, nets.term_count,
                                    p.gamma, p.alpha)
        cost = float(net_costs.sum())

        def eval_move(i: int, si_new: int):
            """Delta of moving node i to site si_new (swap if occupied)."""
            c = cls[i]
            j = occupant.get((c, si_new))
            if j == i:
                return None
            if j is None:
                touched = nets.node_nets[i]
                term_mat = nets.node_term_mat[i]
                term_count = nets.node_term_count[i]
            else:
                touched = np.union1d(nets.node_nets[i], nets.node_nets[j])
                term_mat = nets.term_mat[touched]
                term_count = nets.term_count[touched]
            old_pos_i = pos[i].copy()
            pos[i] = sites[c][si_new]
            if j is not None:
                pos[j] = old_pos_i
            if vectorized:
                new = _net_cost_batch(pos, term_mat, term_count,
                                      p.gamma, p.alpha)
            else:
                new = np.array([_net_cost(pos, nets.nets[ni], p.gamma, p.alpha)
                                for ni in touched])
            pos[i] = old_pos_i
            if j is not None:
                pos[j] = sites[c][si_new]
            delta = float(new.sum() - net_costs[touched].sum())
            return delta, j, touched, new

        def apply_move(i: int, si_new: int, j, touched, new):
            c = cls[i]
            si_old = site_of[i]
            pos[i] = sites[c][si_new]
            site_of[i] = si_new
            occupant[(c, si_new)] = i
            if j is not None:
                pos[j] = sites[c][si_old]
                site_of[j] = si_old
                occupant[(c, si_old)] = j
            else:
                occupant.pop((c, si_old), None)
            net_costs[touched] = new

        # initial temperature from the spread of random-move deltas
        n_probe = min(200, 20 * n)
        probe_nodes = rng.integers(n, size=n_probe)
        probe_sites = rng.random(n_probe)
        deltas = []
        for k in range(n_probe):
            i = int(probe_nodes[k])
            res = eval_move(i, int(probe_sites[k] * n_sites[i]))
            if res is not None:
                deltas.append(abs(res[0]))
        temp = max(1e-3, float(np.std(deltas) if deltas else 1.0) * 10.0)
        total_moves = p.moves_per_node * max(n, 16)
        n_temps = max(1, int(math.log(5e-4) / math.log(p.t_factor)))
        moves_per_temp = max(16, total_moves // n_temps)

        for _ in range(n_temps):
            # pre-drawn proposal block: node, site fraction, acceptance draw
            move_nodes = rng.integers(n, size=moves_per_temp)
            site_u = rng.random(moves_per_temp)
            accept_u = rng.random(moves_per_temp)
            for k in range(moves_per_temp):
                i = int(move_nodes[k])
                si_new = int(site_u[k] * n_sites[i])
                res = eval_move(i, si_new)
                if res is None:
                    continue
                moves_evaluated += 1
                delta, j, touched, new = res
                if delta <= 0 or accept_u[k] < math.exp(-delta / temp):
                    apply_move(i, si_new, j, touched, new)
                    cost += delta
                    moves_accepted += 1
            # resync the incrementally-maintained cost so per-move float
            # drift cannot survive a temperature step
            resync = float(net_costs.sum())
            if debug:
                fresh = _net_cost_batch(pos, nets.term_mat, nets.term_count,
                                        p.gamma, p.alpha)
                if not np.allclose(fresh, net_costs, rtol=p.resync_tol,
                                   atol=p.resync_tol):
                    raise AssertionError(
                        f"{nl.name}: incremental net costs diverged from "
                        f"recomputed costs (max err "
                        f"{np.abs(fresh - net_costs).max():.3e})")
                if abs(cost - resync) > p.resync_tol * max(1.0, abs(resync)):
                    raise AssertionError(
                        f"{nl.name}: incremental cost {cost!r} drifted from "
                        f"net_costs.sum() {resync!r}")
            cost = resync
            resyncs += 1
            temp *= p.t_factor
        if cost < best_cost:
            best_cost, best_pos = cost, pos.copy()

    if stats is not None:
        stats.update({
            "backend": backend,
            "vectorized": vectorized,
            "nodes": n, "nets": len(nets.nets),
            "moves_evaluated": moves_evaluated,
            "moves_accepted": moves_accepted,
            "resyncs": resyncs,
            "best_cost": float(best_cost),
            "place_seconds": time.perf_counter() - t_start,
            **extra,
        })
        if region is not None:
            stats["region"] = (region.row0, region.col0,
                               region.rows, region.cols)
    out = {nets.names[i]: (int(best_pos[i, 0]), int(best_pos[i, 1]))
           for i in range(n)}
    if region is not None:
        stray = sorted(nm for nm, t in out.items() if not region.contains(t))
        if stray:
            raise AssertionError(
                f"{nl.name}: placement left region {region}: {stray[:5]}")
    return out


def placement_stats(nl: Netlist, placement: Dict[str, Tile],
                    gamma: float = 0.3, alpha: float = 1.0) -> dict:
    nets = _Nets(nl)
    pos = np.array([placement[nm] for nm in nets.names])
    costs = _net_cost_batch(pos, nets.term_mat, nets.term_count, gamma, alpha)
    rows = pos[nets.term_mat, 0]
    cols = pos[nets.term_mat, 1]
    hpwl = ((rows.max(axis=1) - rows.min(axis=1)) +
            (cols.max(axis=1) - cols.min(axis=1)))
    return {
        "cost": float(np.sum(costs)),
        "total_hpwl": int(np.sum(hpwl)),
        "max_hpwl": int(np.max(hpwl)) if len(hpwl) else 0,
        "mean_hpwl": float(np.mean(hpwl)) if len(hpwl) else 0.0,
    }
