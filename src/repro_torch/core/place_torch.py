"""Parallel-tempering SA placement on a torch device — the ``"torch"`` PnR
backend of :func:`repro_torch.core.place.place`.

The port of the reference's jitted annealer (``repro.core.place_jax``).
``PlaceParams.replicas`` chains run at once, as the leading batch axis of
every tensor; within each chain a *block* of ``PlaceParams.proposal_block``
move proposals is scored per step against the frozen state — the per-move
Eq. 1 delta is the same padded net-terminal gather as the NumPy kernel,
batched over ``(replicas, block)``.  Accepted proposals in a block are
applied together under an order-deterministic conflict rule (a proposal is
dropped if an earlier-in-block accepted proposal touches any of its nodes
or sites — so the site<->node bijection can never be corrupted; two kept
moves *may* share a net, which is safe because per-net costs carry no
incremental state).  Per-net costs are re-derived from the site assignment
at every step with one dense gather plus a host-precomputed
``(hpwl, area)`` power-lookup table, and the kept moves land through two
scatters into buffers with one sentinel column, which absorbs the dropped
proposals and is never read.

The reference's ``lax.scan`` over temperature steps and proposal blocks
becomes a Python loop over ``n_temps x blocks_per_temp`` steps, its
``vmap`` over replicas the batch axis, and ``jax.random`` a
``torch.Generator`` on the device seeded with ``PlaceParams.seed``.  After
every temperature step adjacent replicas of the geometric temperature
ladder attempt a Metropolis state exchange.  The loop reads nothing back
from the device; the best assignment seen by any replica is copied to the
host once, at the end.

Contract with the other backends (as the reference's):

* legality is structural — proposals draw from the same region-filtered
  site pools as the NumPy/scalar kernels, and site occupancy is an
  explicit bijection updated only by conflict-free moves;
* bit-identity across backends is *not* promised (float32 costs, another
  RNG, block-parallel acceptance), but a fixed ``seed`` on one device gives
  identical results run to run, and the best-replica cost is expected to
  be at or below the single-chain NumPy cost;
* the host-side set-up (:func:`_anneal_setup`) is the reference's, bit for
  bit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import resolve_device

# class order defines the flattened site-slot space: [pe | mem | io]
_CLASS_ORDER = ("pe", "mem", "io")


def _flatten_sites(sites: Dict[str, List[Tuple[int, int]]]):
    """Concatenate the per-class site pools into one slot space.

    Returns ``(site_rc, class_off, class_pool)`` — slot ``class_off[c] + k``
    is the k-th site of class ``c``.  IO tiles appear ``IO_CAPACITY`` times
    in the pool (distinct slots, same tile), exactly as in the NumPy path,
    so multi-stream IO capacity is respected by slot bijection alone.
    """
    rc, off, pool = [], {}, {}
    for c in _CLASS_ORDER:
        off[c] = len(rc)
        pool[c] = len(sites[c])
        rc.extend(sites[c])
    return np.asarray(rc, dtype=np.int32), off, pool


def _padded_node_nets(nets, n: int) -> np.ndarray:
    """Per-node incident-net matrix, padded with -1 (sorted rows, like the
    NumPy kernel's ``node_nets``)."""
    max_inc = max((len(nets.node_nets[i]) for i in range(n)), default=1)
    mat = np.full((n, max(1, max_inc)), -1, dtype=np.int32)
    for i in range(n):
        row = nets.node_nets[i]
        mat[i, :len(row)] = row
    return mat


def _probe_temperature(nets, pos0: np.ndarray, node_off: np.ndarray,
                       node_pool: np.ndarray, site_rc: np.ndarray,
                       gamma: float, alpha: float,
                       rng: np.random.Generator) -> float:
    """Initial temperature from the spread of random-move deltas (the same
    heuristic as the NumPy kernel, evaluated on replica 0's start)."""
    from .place import _net_cost_batch

    n = len(pos0)
    n_probe = min(200, 20 * n)
    deltas = []
    for _ in range(n_probe):
        i = int(rng.integers(n))
        s = int(node_off[i] + rng.integers(node_pool[i]))
        touched = nets.node_nets[i]
        if not len(touched):
            continue
        old = _net_cost_batch(pos0, nets.term_mat[touched],
                              nets.term_count[touched], gamma, alpha)
        trial = pos0.copy()
        trial[i] = site_rc[s]
        new = _net_cost_batch(trial, nets.term_mat[touched],
                              nets.term_count[touched], gamma, alpha)
        deltas.append(abs(float(new.sum() - old.sum())))
    return max(1e-3, float(np.std(deltas) if deltas else 1.0) * 10.0)


def _anneal_setup(nets, cls: List[str], sites: Dict[str, list], p) -> dict:
    """The host-side set-up of the reference's ``anneal_jax`` on one
    device, bit for bit: slot tables, per-replica initial states drawn from
    ``np.random.default_rng([seed, r])``, the probed base temperature and
    its geometric ladder, the move budget and the Eq. 1 lookup table."""
    from .place import _net_cost_batch

    n = len(cls)
    site_rc, class_off, class_pool = _flatten_sites(sites)
    node_off = np.asarray([class_off[c] for c in cls], dtype=np.int32)
    node_pool = np.asarray([class_pool[c] for c in cls], dtype=np.int32)
    n_slots = len(site_rc)

    # size-adaptive ensemble policy: small netlists are cheap to anneal
    # but their single-chain cost is high-variance, so they get more,
    # colder replicas and a doubled ensemble budget; large netlists keep
    # a lean ensemble
    small = n <= 150
    replicas = max(1, int(p.replicas if p.replicas is not None
                          else (8 if small else 4)))
    spread = (p.replica_spread if p.replica_spread is not None
              else (0.85 if small else 0.65))
    budget_boost = 2 if small else 1
    K = max(1, int(p.proposal_block))

    # --- per-replica initial states (seed-derived, replica-salted) -------
    site0 = np.zeros((replicas, n), dtype=np.int32)
    occ0 = np.full((replicas, n_slots), -1, dtype=np.int32)
    for r in range(replicas):
        rs = np.random.default_rng([int(p.seed), r])
        for c in _CLASS_ORDER:
            members = [i for i in range(n) if cls[i] == c]
            if not members:
                continue
            chosen = rs.choice(class_pool[c], size=len(members),
                               replace=False)
            for i, k in zip(members, chosen):
                s = class_off[c] + int(k)
                site0[r, i] = s
                occ0[r, s] = i

    pos0 = site_rc[site0[0]].astype(np.int64)
    cost0 = np.asarray([
        _net_cost_batch(site_rc[site0[r]].astype(np.int64), nets.term_mat,
                        nets.term_count, p.gamma, p.alpha).sum()
        for r in range(replicas)], dtype=np.float32)

    base_temp = _probe_temperature(
        nets, pos0, node_off, node_pool, site_rc,
        p.gamma, p.alpha, np.random.default_rng(p.seed))
    # geometric ladder: slot 0 anneals the NumPy schedule, higher slots
    # run hotter so exchanges can tunnel out of local minima
    temps0 = base_temp * (spread ** np.arange(replicas))

    # every replica evaluates the full NumPy move budget; the speedup
    # comes from evaluating K proposals per sequential step, not from
    # shortening the anneal
    total_moves = budget_boost * p.moves_per_node * max(n, 16)
    n_temps = max(1, int(math.log(5e-4) / math.log(p.t_factor)))
    blocks_per_temp = max(1, total_moves // n_temps // K)

    hmax = int(site_rc[:, 0].max() - site_rc[:, 0].min())
    wmax = int(site_rc[:, 1].max() - site_rc[:, 1].min())
    pow_tab = np.power(
        np.arange(hmax + wmax + 1, dtype=np.float64)[:, None]
        + p.gamma * np.arange((hmax + 1) * (wmax + 1) + 1,
                              dtype=np.float64)[None, :],
        p.alpha).astype(np.float32)
    return {
        "site_rc": site_rc, "node_off": node_off, "node_pool": node_pool,
        "node_nets": _padded_node_nets(nets, n),
        "term_mat": nets.term_mat.astype(np.int32),
        "term_count": nets.term_count.astype(np.int32),
        "pow_tab": pow_tab, "site0": site0, "occ0": occ0, "cost0": cost0,
        "temps0": temps0.astype(np.float32), "replicas": replicas, "K": K,
        "n_temps": n_temps, "blocks_per_temp": blocks_per_temp,
    }


def _anneal(su: dict, seed: int, t_factor: float, dev: torch.device,
            draw=None):
    """The reference's ``_jitted_anneal`` as one torch program on ``dev``.
    Returns the device tensors ``(best_cost, best_site, evaluated,
    accepted)``, one row per replica; nothing is read back.

    ``draw(shape)`` supplies the uniforms, in the order the anneal takes
    them: per temperature step one ``(blocks_per_temp, R, K, 3)`` block of
    proposals, then ``(R,)`` for the exchange.  By default they come from
    a ``torch.Generator`` on ``dev`` seeded with ``seed``; a caller can
    pass another stream (the tests replay the reference's)."""
    i64 = torch.int64

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    site_rc = t(su["site_rc"], i64)
    node_off, node_pool = t(su["node_off"], i64), t(su["node_pool"], i64)
    node_nets = t(su["node_nets"], i64)
    term_mat, term_count = t(su["term_mat"], i64), t(su["term_count"], i64)
    pow_tab = t(su["pow_tab"])
    R, K = su["replicas"], su["K"]
    n = su["site0"].shape[1]
    n_slots = su["occ0"].shape[1]
    n_nets = term_mat.shape[0]

    # state, replicas on the leading axis; site and occ carry one sentinel
    # column (n, n_slots) that takes the dropped proposals' writes
    site_buf = torch.full((R, n + 1), n_slots, dtype=i64, device=dev)
    site_buf[:, :n] = t(su["site0"], i64)
    occ_buf = torch.full((R, n_slots + 1), -1, dtype=i64, device=dev)
    occ_buf[:, :n_slots] = t(su["occ0"], i64)
    cost = t(su["cost0"])
    best_cost = cost.clone()
    best_site = site_buf[:, :n].clone()
    ev = torch.zeros(R, dtype=i64, device=dev)
    acc = torch.zeros(R, dtype=i64, device=dev)
    temps = t(su["temps0"])

    rows = torch.arange(R, device=dev)
    rows4 = rows.view(R, 1, 1, 1)
    earlier = torch.ones(K, K, dtype=torch.bool, device=dev).tril(-1)
    if draw is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))

        def draw(shape):
            return torch.rand(shape, generator=gen, device=dev)

    def all_net_costs(pos):
        """Eq. 1 over every net of every replica from scratch — one dense
        gather, no incremental state to drift.  ``pos``: (R, n, 2)."""
        pts = pos[:, term_mat]                           # (R, n_nets, D, 2)
        w = pts[..., 1].amax(-1) - pts[..., 1].amin(-1)
        h = pts[..., 0].amax(-1) - pts[..., 0].amin(-1)
        area = ((w + 1) * (h + 1) - term_count).clamp_min(0)
        return pow_tab[w + h, area]                      # (R, n_nets)

    def block_step(u, temp):
        nonlocal best_cost, best_site, ev, acc
        site = site_buf[:, :n]
        occ = occ_buf[:, :n_slots]
        pos = site_rc[site]                              # (R, n, 2)
        costs_all = all_net_costs(pos)
        cost_now = costs_all.sum(-1)
        # exact best tracking from the freshly re-derived cost, taken at
        # step start (the post-apply cost is only approximate when kept
        # moves share a net)
        improved = cost_now < best_cost
        best_cost = torch.where(improved, cost_now, best_cost)
        best_site = torch.where(improved[:, None], site, best_site)
        costs_pad = torch.nn.functional.pad(costs_all, (0, 1))
        i = (u[..., 0] * n).long().clamp_max(n - 1)       # (R, K)
        pool = node_pool[i]
        s = node_off[i] + torch.minimum((u[..., 1] * pool).long(), pool - 1)
        j = occ.gather(1, s)
        old_si = site.gather(1, i)
        self_move = s == old_si
        j_valid = (j >= 0) & ~self_move
        j_safe = torch.where(j_valid, j, i)
        # touched nets of the (i, j) pair, j's deduped against i's
        nets_i = node_nets[i]                            # (R, K, M)
        nets_j = node_nets[j_safe]
        dup_j = (nets_j[..., :, None] == nets_i[..., None, :]).any(-1)
        valid = torch.cat(
            [nets_i >= 0, (nets_j >= 0) & j_valid[..., None] & ~dup_j],
            dim=-1)                                      # (R, K, 2M)
        nets_cat = torch.cat([nets_i, nets_j], dim=-1)
        gather_idx = torch.where(valid, nets_cat, 0)
        old_costs = costs_pad.gather(
            1, torch.where(valid, nets_cat, n_nets).view(R, -1)
        ).view(valid.shape)
        # Eq. 1 on the gathered terminals with i -> s and j -> i's old
        # tile patched in place
        terms = term_mat[gather_idx]                     # (R, K, 2M, D)
        old_pos_i = pos[rows[:, None], i]                # (R, K, 2)
        new_rc = site_rc[s]
        pts = pos[rows4, terms]                          # (R, K, 2M, D, 2)
        is_i = (terms == i[..., None, None])[..., None]
        is_j = ((terms == j_safe[..., None, None])
                & j_valid[..., None, None])[..., None]
        pts = torch.where(is_j, old_pos_i[:, :, None, None, :], pts)
        pts = torch.where(is_i, new_rc[:, :, None, None, :], pts)
        w = pts[..., 1].amax(-1) - pts[..., 1].amin(-1)
        h = pts[..., 0].amax(-1) - pts[..., 0].amin(-1)
        area = ((w + 1) * (h + 1) - term_count[gather_idx]).clamp_min(0)
        new_costs = pow_tab[w + h, area]
        delta = torch.where(valid, new_costs - old_costs, 0.0).sum(-1)
        accept = ~self_move & ((delta <= 0)
                               | (u[..., 2] < torch.exp(-delta / temp[:, None])))
        # conflict rule: keep an accepted proposal only if no earlier-in-
        # block accepted proposal moves a common node or targets a common
        # site (strictly triangular, so the block is order-deterministic)
        ends = torch.stack([i, j_safe], dim=-1)          # (R, K, 2)
        node_conf = (ends[:, :, None, :, None]
                     == ends[:, None, :, None, :]).flatten(-2).any(-1)
        conf = node_conf | (s[:, :, None] == s[:, None, :])
        kept = accept & ~(conf & earlier & accept[:, None, :]).any(-1)
        # apply the kept set at once; dropped proposals write the
        # sentinel column.  Kept moves share no node and no slot, so no
        # two writes outside the sentinel land on one index
        im = torch.where(kept, i, n)
        jm = torch.where(kept & j_valid, j_safe, n)
        site_buf.scatter_(1, torch.cat([jm, im], 1), torch.cat([old_si, s], 1))
        jv = torch.where(j_valid, j, -1)
        occ_buf.scatter_(1, torch.cat([torch.where(kept, old_si, n_slots),
                                       torch.where(kept, s, n_slots)], 1),
                         torch.cat([jv, i], 1))
        ev = ev + (~self_move).sum(-1)
        acc = acc + kept.sum(-1)

    for seg_i in range(su["n_temps"]):
        # one temperature step of every replica: blocks_per_temp proposal
        # blocks, then an exact cost for the post-block state — the
        # exchange decisions and the best tracker only ever see freshly
        # derived costs
        u_blocks = draw((su["blocks_per_temp"], R, K, 3))
        for u in u_blocks:
            block_step(u, temps)
        cost = all_net_costs(site_rc[site_buf[:, :n]]).sum(-1)
        improved = cost < best_cost
        best_cost = torch.where(improved, cost, best_cost)
        best_site = torch.where(improved[:, None], site_buf[:, :n], best_site)
        # Metropolis swap between adjacent ladder slots, even/odd pairs in
        # turn: accepted pairs swap their whole chain state while the
        # ladder temperatures stay with the slots
        phase = seg_i % 2
        lead = (rows % 2 == phase) & (rows + 1 < R)
        nxt = (rows + 1).clamp_max(R - 1)
        log_a = (1.0 / temps - 1.0 / temps[nxt]) * (cost - cost[nxt])
        u_swap = draw((R,))
        swap_up = lead & (torch.log(u_swap) < log_a)
        swap_dn = torch.cat([swap_up.new_zeros(1), swap_up[:-1]])
        perm = torch.where(swap_up, nxt,
                           torch.where(swap_dn, (rows - 1).clamp_min(0), rows))
        site_buf, occ_buf, cost, best_cost, best_site, ev, acc = (
            x[perm] for x in (site_buf, occ_buf, cost, best_cost,
                              best_site, ev, acc))
        temps = temps * t_factor
    return best_cost, best_site, ev, acc


def anneal_torch(nets, cls: List[str], sites: Dict[str, list], p,
                 device=None) -> Tuple[np.ndarray, float, dict]:
    """Anneal ``p.replicas`` parallel-tempering chains on ``device`` (the
    card unless the caller asks for the CPU); return ``(best_pos,
    best_cost, stats)``.

    ``nets`` is the :class:`repro_torch.core.place._Nets` terminal model,
    ``cls`` the per-node tile class, ``sites`` the (already
    region-filtered) site pools, ``p`` the
    :class:`repro_torch.core.place.PlaceParams`.
    """
    from .place import _net_cost_batch

    dev = resolve_device(device)
    su = _anneal_setup(nets, cls, sites, p)
    out = _anneal(su, p.seed, p.t_factor, dev)
    best_costs, best_sites, ev, acc = (x.cpu().numpy() for x in out)
    best_costs = best_costs.astype(np.float64)
    best_r = int(best_costs.argmin())                # first on ties
    best_pos = su["site_rc"][best_sites[best_r]].astype(np.int64)
    # re-derive the winning cost in float64 through the NumPy Eq. 1 kernel
    # so cross-backend cost comparisons are apples to apples
    best_cost = float(_net_cost_batch(best_pos, nets.term_mat,
                                      nets.term_count, p.gamma,
                                      p.alpha).sum())
    stats = {
        "replicas": su["replicas"],
        "devices": 1,
        "proposal_block": su["K"],
        "moves_evaluated": int(ev.sum()),
        "moves_accepted": int(acc.sum()),
        "resyncs": int(su["n_temps"] * su["blocks_per_temp"]),
        "best_replica": best_r,
        "replica_costs": [round(float(c), 3) for c in best_costs],
    }
    return best_pos, best_cost, stats
