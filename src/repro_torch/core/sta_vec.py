"""Vectorized application STA: lower a routed design once, re-time cheaply.

The scalar oracle (:func:`repro_torch.core.sta.analyze`) re-walks the whole
netlist — every route, hop by hop, in Python — on every call.  That is
the inner loop of post-PnR pipelining (paper Section V-D): one analyze
per register-insertion round, hundreds of rounds per power-cap /
Pareto-frontier sweep.  This module removes the per-round Python walk:

* :func:`lower_design` flattens the routed design into a *timing-vertex
  DAG* held in dense numpy arrays: one vertex per node output, per route
  hop, and per branch endpoint, topologically leveled, with per-vertex
  delays and a register-site index.  The lowering depends only on the
  route *structure* — which hop sites actually carry a register lives in
  a boolean mask — so one lowering serves every pipelining state of the
  design (and every deep-copied fork the explorer makes, which is why
  frontier points share one).
* arrival propagation runs level by level as whole-array gathers
  (numpy) or as a loop over padded level tensors on a torch device
  (torch, in float64 so the arithmetic matches the oracle bit for bit).
* :class:`IncrementalSTA` keeps the arrival vector alive across
  pipelining rounds: a register insertion only flips mask bits, so each
  re-analyze re-propagates just the dirty fanout cone of the edited
  hops and stops as soon as arrivals stop changing.

Bit-identity with the scalar oracle is a design invariant, not an
accident: every vertex performs exactly the float64 operations the
scalar walk performs — an exact ``max`` over predecessors followed by a
single add — in the same association, and the critical-segment winner is
chosen by first-maximum over scoring events enumerated in the scalar
visit order (matching its strict-``>`` tie-break).
``tests/test_torch_sta_vec.py`` holds both engines to the JAX package's
scalar and numpy engines (critical path, reconstruction, arrival maps and
segment counts, on routed designs and random register states), and
``chip_smoke.py`` holds the torch engine to the scalar walk on the card.

The torch engine is the port of the reference's jitted ``lax.scan``
(``repro.core.sta_vec._jitted_propagate``): the scan becomes a Python
loop over levels, each level a handful of whole-level tensor operations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .netlist import RoutedDesign
from .sta import PathElem, STAReport, _seq_input, _seq_output
from .timing_model import TimingModel

#: the lowered engines (``backend=`` of :func:`analyze_vec` and
#: :class:`IncrementalSTA`)
VEC_BACKENDS = ("numpy", "torch")

# vertex kinds
_CONST = 0   # no predecessors: value fixed at lowering time
_SP = 1      # single predecessor (hop / branch-endpoint vertices)
_MP = 2      # multi-predecessor max (combinational node outputs)


@dataclass
class LoweredSTA:
    """A routed design flattened into dense timing arrays.

    Structure-only: placement, routes, and hop delays are frozen in;
    *register occupancy* is the caller's boolean site mask, so the same
    lowering re-times every pipelining state of the design.  Pure
    numpy + dicts — picklable (the lazily-built device level tensors are
    dropped on pickle and rebuilt on first use).
    """

    n_verts: int
    n_sites: int
    n_levels: int
    overhead: float
    reg_clk_q: float
    core_pe: float
    default_cp: float                     # overhead + core_delay("pe")

    # per-vertex computation (indexed by vertex id)
    vp_kind: np.ndarray                   # _CONST / _SP / _MP
    vp_pred: np.ndarray                   # SP: predecessor vertex (-1 else)
    vp_site: np.ndarray                   # SP: register site gating the pred
    vp_delay: np.ndarray                  # SP: hop/cb delay; MP: core delay
    vp_const: np.ndarray                  # CONST: fixed arrival value
    vlevel: np.ndarray                    # topological level per vertex

    # MP edge lists (CSR): vertex v reads mp_edges[mp_eoff[v]:mp_eoff[v]+mp_ecnt[v]]
    mp_eoff: np.ndarray
    mp_ecnt: np.ndarray
    mp_edges: np.ndarray

    # per-level propagation groups (index 0 is the constant level)
    lvl_sp: List[Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]]
    lvl_mp: List[Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]]

    # incremental propagation support
    site_consumer: np.ndarray             # site -> the one vertex reading it
    succ_off: np.ndarray                  # CSR vertex -> dependent vertices
    succ_dat: np.ndarray

    # scoring events, enumerated in exact scalar visit order
    ev_vertex: np.ndarray
    ev_site: np.ndarray                   # -1 = capture event (always active)
    ev_payload: List[Tuple]               # ("hop", bkey, i) | ("cap", bkey, sink)

    # reconstruction / candidate-scoring side tables
    order: List[str]                      # scalar topo order over nodes
    out_vid: Dict[str, int]
    end_vid: Dict[Tuple, int]
    site_base: Dict[Tuple, int]           # branch key -> first site id
    branch_hops: Dict[Tuple, int]         # branch key -> hop count
    branch_driver: Dict[Tuple, str]
    in_keys: Dict[str, List[Tuple]]       # sink -> branch keys, route order
    seq_out: Dict[str, bool]
    site_delay: np.ndarray                # hop delay per site (candidates)
    core_of: Dict[str, float]             # node -> core delay (candidates)

    # device -> level tensors of _torch_state, built on first use
    _torch: dict = field(default_factory=dict, repr=False, compare=False)
    _scalar: dict = field(default_factory=dict, repr=False, compare=False)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_torch"] = {}              # device buffers don't pickle
        state["_scalar"] = {}             # cheap to rebuild on first use
        return state

    def _scalar_state(self) -> dict:
        """Python-list mirrors of the vertex arrays, built lazily.

        The incremental path touches a handful of vertices per round;
        element-wise numpy indexing there costs more than the arithmetic,
        so the dirty-cone walk runs on plain lists instead."""
        st = self._scalar
        if not st:
            st["kind"] = self.vp_kind.tolist()
            st["pred"] = self.vp_pred.tolist()
            st["site"] = self.vp_site.tolist()
            st["delay"] = self.vp_delay.tolist()
            st["level"] = self.vlevel.tolist()
            st["succ"] = [
                self.succ_dat[self.succ_off[v]:self.succ_off[v + 1]].tolist()
                for v in range(self.n_verts)]
            st["mp"] = [
                self.mp_edges[self.mp_eoff[v]:
                              self.mp_eoff[v] + self.mp_ecnt[v]].tolist()
                if self.vp_kind[v] == _MP else None
                for v in range(self.n_verts)]
            st["ev"] = (self.ev_site < 0, np.clip(self.ev_site, 0, None))
        return st

    # -- mask <-> design -------------------------------------------------
    def initial_mask(self, design: RoutedDesign) -> np.ndarray:
        # one trailing sentinel slot, always False: padded/absent site
        # reads (index -1 or n_sites) gate nothing
        mask = np.zeros(self.n_sites + 1, dtype=bool)
        for key, rb in design.routes.items():
            base = self.site_base[key]
            for j in rb.reg_hops:
                mask[base + j] = True
        return mask

    def site_id(self, bkey: Tuple, hop_idx: int) -> int:
        return self.site_base[bkey] + hop_idx

    # -- full propagation -------------------------------------------------
    def propagate_numpy(self, mask: np.ndarray) -> np.ndarray:
        arr = np.zeros(self.n_verts, dtype=np.float64)
        const = self.vp_kind == _CONST
        arr[const] = self.vp_const[const]
        rq = self.reg_clk_q
        for lv in range(1, self.n_levels):
            sp = self.lvl_sp[lv]
            if sp is not None:
                v, pred, site, delay = sp
                base = arr[pred]
                gated = (site >= 0) & mask[np.clip(site, 0, None)]
                arr[v] = np.where(gated, rq, base) + delay
            mp = self.lvl_mp[lv]
            if mp is not None:
                v, core, esrc, eoff = mp
                m = np.maximum.reduceat(arr[esrc], eoff)
                arr[v] = np.maximum(m, 0.0) + core
        return arr

    def propagate_torch(self, mask: np.ndarray,
                        device: torch.device) -> np.ndarray:
        """Full propagation on ``device``: the reference's jitted level
        scan as a Python loop over the padded level tensors of
        :func:`_torch_state`, in float64.  Uploads the mask, runs every
        level on the device and copies the arrival vector back once."""
        st = self._torch.get(device)
        if st is None:
            st = self._torch[device] = _torch_state(self, device)
        m = torch.from_numpy(mask).to(device)
        arr = st["init"].clone()        # n_verts + 1: the sentinel last
        rq = self.reg_clk_q
        for lv, (n_sp, n_mp) in enumerate(st["counts"]):
            if n_sp:
                v, p, s, d = (t[lv] for t in st["sp"])
                arr[v] = torch.where(m[s], rq, arr[p]) + d
            if n_mp:
                mv, mc, md, ms = (t[lv] for t in st["mp"])
                # lower_design gives every multi-pred vertex at least one
                # in-edge, so max(0, in-edges) + core is the scalar walk's
                # running max from 0 followed by one add
                arr[mv] = 0.0
                arr.scatter_reduce_(0, md, arr[ms], reduce="amax")
                arr[mv] = arr[mv] + mc
        return arr[:self.n_verts].cpu().numpy()

    # -- incremental propagation ------------------------------------------
    def propagate_incremental(self, arr: np.ndarray, mask: np.ndarray,
                              dirty: Sequence[int]) -> None:
        """Re-propagate only the fanout cone of ``dirty`` vertices, in
        level order, stopping as soon as arrival values stop changing.
        ``arr`` is updated in place and must be consistent with the
        *previous* mask everywhere outside the dirty cone."""
        if not len(dirty):
            return
        st = self._scalar_state()
        kind, pred, site, delay = st["kind"], st["pred"], st["site"], st["delay"]
        level, succ, mp = st["level"], st["succ"], st["mp"]
        rq = self.reg_clk_q
        # per-level pending buckets; successors are always at a strictly
        # higher level, so one ascending sweep settles the cone
        buckets: List[Optional[set]] = [None] * max(self.n_levels, 1)
        lo = self.n_levels
        for v in dirty:
            lv = level[v]
            b = buckets[lv]
            if b is None:
                b = buckets[lv] = set()
            b.add(v)
            if lv < lo:
                lo = lv
        for lv in range(lo, self.n_levels):
            b = buckets[lv]
            if not b:
                continue
            for v in b:
                k = kind[v]
                if k == _SP:
                    s = site[v]
                    base = rq if (s >= 0 and mask[s]) else arr[pred[v]]
                    new = base + delay[v]
                elif k == _MP:
                    m = 0.0
                    for e in mp[v]:
                        ae = arr[e]
                        if ae > m:
                            m = ae
                    new = m + delay[v]
                else:         # _CONST vertices have no inputs to dirty
                    continue
                if new != arr[v]:
                    arr[v] = new
                    for s2 in succ[v]:
                        l2 = level[s2]
                        bb = buckets[l2]
                        if bb is None:
                            bb = buckets[l2] = set()
                        bb.add(s2)

    # -- report assembly ---------------------------------------------------
    def report(self, arr: np.ndarray, mask: np.ndarray,
               clock_granularity_ns: float = 0.0,
               with_arrivals: bool = True) -> STAReport:
        """Assemble an :class:`STAReport` from an arrival vector.

        ``with_arrivals=False`` leaves ``arrival_out`` empty — the
        pipelining loop's per-round reports never read it, and the dict
        build is a measurable share of a warm round."""
        nosite, clip = self._scalar_state()["ev"]
        vals = arr[self.ev_vertex] + self.overhead
        active = nosite | mask[clip]
        seg_count = int(active.sum())
        if seg_count == 0 or not len(vals):
            cp, path = self.default_cp, []
        else:
            vals = np.where(active, vals, -np.inf)
            best = int(np.argmax(vals))   # first max == scalar strict-> winner
            cp = float(vals[best])
            path = self._reconstruct(arr, mask, best)
        period = cp
        if clock_granularity_ns > 0:
            period = math.ceil(cp / clock_granularity_ns) * clock_granularity_ns
        arrival_out = ({n: float(arr[self.out_vid[n]]) for n in self.order}
                       if with_arrivals else {})
        return STAReport(
            critical_path_ns=cp,
            max_freq_mhz=1e3 / period,
            critical_path=path,
            arrival_out=arrival_out,
            n_segments=seg_count,
            clock_period_ns=period,
        )

    def _last_reg_elem(self, mask: np.ndarray, bkey: Tuple,
                       before: Optional[int] = None) -> Optional[PathElem]:
        """The scalar walk's ``last``: the latest registered hop of the
        branch strictly before ``before`` (whole branch when None), else
        the driver node element."""
        base = self.site_base[bkey]
        hi = self.branch_hops[bkey] if before is None else before
        regs = np.nonzero(mask[base:base + hi])[0]
        if len(regs):
            return ("hop", bkey, int(regs[-1]))
        return ("node", self.branch_driver[bkey])

    def _bp_node(self, arr: np.ndarray, mask: np.ndarray,
                 name: str) -> Optional[PathElem]:
        """Backpointer of a node: the ``last`` of its strictly-worst input
        branch, replicating the scalar first-strict-winner scan."""
        if self.seq_out[name]:
            return None
        a_in, src = 0.0, None
        for bkey in self.in_keys[name]:
            a = float(arr[self.end_vid[bkey]])
            if a > a_in:
                a_in, src = a, self._last_reg_elem(mask, bkey)
        return src

    def _reconstruct(self, arr: np.ndarray, mask: np.ndarray,
                     best_ev: int) -> List[PathElem]:
        payload = self.ev_payload[best_ev]
        path: List[PathElem] = []
        if payload[0] == "hop":
            _, bkey, i = payload
            path.append(("hop", bkey, i))
            cur = self._last_reg_elem(mask, bkey, before=i)
        else:
            _, bkey, sink = payload
            path.append(("node", sink))
            cur = self._last_reg_elem(mask, bkey)
        guard = 0
        while cur is not None and guard < 100_000:
            path.append(cur)
            cur = self._bp_node(arr, mask, cur[1]) if cur[0] == "node" else None
            guard += 1
        path.reverse()
        return path


def lower_design(design: RoutedDesign, tm: TimingModel) -> LoweredSTA:
    """Flatten ``design`` into a :class:`LoweredSTA` (structure only —
    the register-site mask is supplied per propagation)."""
    nl, fabric = design.netlist, design.fabric

    # exact replica of the scalar analyze toposort (same stack pop order,
    # so ``order`` — and with it arrival_out's dict order and the event
    # enumeration below — match the oracle element for element)
    names = list(nl.nodes)
    indeg = {n: 0 for n in names}
    adj: Dict[str, list] = {n: [] for n in names}
    by_sink: Dict[str, list] = {n: [] for n in names}
    for rb in design.routes.values():
        b = rb.branch
        indeg[b.sink] += 1
        adj[b.driver].append(rb)
        by_sink[b.sink].append(rb)
    order, stack = [], [n for n in names if indeg[n] == 0]
    while stack:
        n = stack.pop()
        order.append(n)
        for rb in adj[n]:
            indeg[rb.branch.sink] -= 1
            if indeg[rb.branch.sink] == 0:
                stack.append(rb.branch.sink)
    if len(order) != len(names):
        raise ValueError("netlist graph has a cycle")

    # register-site ids: contiguous per branch, route order
    site_base: Dict[Tuple, int] = {}
    branch_hops: Dict[Tuple, int] = {}
    branch_driver: Dict[Tuple, str] = {}
    n_sites = 0
    for key, rb in design.routes.items():
        site_base[key] = n_sites
        branch_hops[key] = len(rb.hops)
        branch_driver[key] = rb.branch.driver
        n_sites += len(rb.hops)
    site_delay = np.zeros(max(1, n_sites), dtype=np.float64)

    # vertex enumeration, in a per-node topological sequence: all inbound
    # hop chains and endpoints of a node, then the node's own output
    vp_kind: List[int] = []
    vp_pred: List[int] = []
    vp_site: List[int] = []
    vp_delay: List[float] = []
    vp_const: List[float] = []
    vlevel: List[int] = []
    mp_edge_lists: Dict[int, List[int]] = {}
    out_vid: Dict[str, int] = {}
    hop_vid0: Dict[Tuple, int] = {}
    end_vid: Dict[Tuple, int] = {}
    seq_out: Dict[str, bool] = {}
    in_keys: Dict[str, List[Tuple]] = {}
    core_of: Dict[str, float] = {}

    def new_vertex(kind, pred=-1, site=-1, delay=0.0, const=0.0, level=0):
        vp_kind.append(kind)
        vp_pred.append(pred)
        vp_site.append(site)
        vp_delay.append(delay)
        vp_const.append(const)
        vlevel.append(level)
        return len(vp_kind) - 1

    from .dfg import INPUT, OUTPUT

    for name in order:
        node = nl.nodes[name]
        in_keys[name] = [rb.branch.key for rb in by_sink[name]]
        for rb in by_sink[name]:
            key = rb.branch.key
            base = site_base[key]
            prev = out_vid[rb.branch.driver]
            for j, hop in enumerate(rb.hops):
                d = tm.hop_delay(fabric, hop)
                site_delay[base + j] = d
                v = new_vertex(_SP, pred=prev,
                               site=(base + j - 1) if j else -1,
                               delay=d, level=vlevel[prev] + 1)
                if j == 0:
                    hop_vid0[key] = v
                prev = v
            end_vid[key] = new_vertex(
                _SP, pred=prev,
                site=(base + len(rb.hops) - 1) if rb.hops else -1,
                delay=tm.cb_in, level=vlevel[prev] + 1)
        core = tm.core_delay("io" if node.kind in (INPUT, OUTPUT)
                             else node.kind, node.op)
        core_of[name] = core
        seq_out[name] = _seq_output(node)
        if seq_out[name]:
            out_vid[name] = new_vertex(_CONST, const=tm.reg_clk_q + core)
        elif not by_sink[name]:
            out_vid[name] = new_vertex(_CONST, const=0.0 + core)
        else:
            edges = [end_vid[rb.branch.key] for rb in by_sink[name]]
            lv = max(vlevel[e] for e in edges) + 1
            v = new_vertex(_MP, delay=core, level=lv)
            mp_edge_lists[v] = edges
            out_vid[name] = v

    n_verts = len(vp_kind)
    vp_kind_a = np.asarray(vp_kind, dtype=np.int8)
    vp_pred_a = np.asarray(vp_pred, dtype=np.int64)
    vp_site_a = np.asarray(vp_site, dtype=np.int64)
    vp_delay_a = np.asarray(vp_delay, dtype=np.float64)
    vp_const_a = np.asarray(vp_const, dtype=np.float64)
    vlevel_a = np.asarray(vlevel, dtype=np.int64)

    # MP edges -> CSR
    mp_eoff = np.zeros(n_verts, dtype=np.int64)
    mp_ecnt = np.zeros(n_verts, dtype=np.int64)
    flat_edges: List[int] = []
    for v, es in mp_edge_lists.items():
        mp_eoff[v] = len(flat_edges)
        mp_ecnt[v] = len(es)
        flat_edges.extend(es)
    mp_edges = np.asarray(flat_edges or [0], dtype=np.int64)
    # np.maximum.reduceat (numpy) and set-0 / amax / add (torch) equal the
    # scalar walk's running max only over non-empty in-edge segments: a
    # multi-pred vertex is made only for a node with inbound routes
    assert (mp_ecnt[vp_kind_a == _MP] > 0).all(), "empty multi-pred segment"

    # per-level propagation groups
    n_levels = int(vlevel_a.max()) + 1 if n_verts else 1
    lvl_sp: List[Optional[tuple]] = [None] * n_levels
    lvl_mp: List[Optional[tuple]] = [None] * n_levels
    for lv in range(1, n_levels):
        at = np.nonzero(vlevel_a == lv)[0]
        sp = at[vp_kind_a[at] == _SP]
        if len(sp):
            lvl_sp[lv] = (sp, vp_pred_a[sp], vp_site_a[sp], vp_delay_a[sp])
        mp = at[vp_kind_a[at] == _MP]
        if len(mp):
            esrc: List[int] = []
            eoff: List[int] = []
            for v in mp:
                eoff.append(len(esrc))
                esrc.extend(mp_edge_lists[int(v)])
            lvl_mp[lv] = (mp, vp_delay_a[mp],
                          np.asarray(esrc, dtype=np.int64),
                          np.asarray(eoff, dtype=np.int64))

    # successors CSR + site -> consumer (for the incremental dirty cone)
    succ_lists: List[List[int]] = [[] for _ in range(n_verts)]
    site_consumer = np.full(max(1, n_sites), -1, dtype=np.int64)
    for v in range(n_verts):
        if vp_kind_a[v] == _SP:
            succ_lists[vp_pred_a[v]].append(v)
            if vp_site_a[v] >= 0:
                site_consumer[vp_site_a[v]] = v
        elif vp_kind_a[v] == _MP:
            for e in mp_edge_lists[v]:
                succ_lists[e].append(v)
    succ_off = np.zeros(n_verts + 1, dtype=np.int64)
    for v in range(n_verts):
        succ_off[v + 1] = succ_off[v] + len(succ_lists[v])
    succ_dat = np.asarray([s for ss in succ_lists for s in ss] or [0],
                          dtype=np.int64)

    # scoring events, in exact scalar visit order: the comb-input walk of
    # every non-seq-output node scores its registered hops; the capture
    # walk of every seq-input node re-scores them (OUTPUT nodes therefore
    # double-count — a quirk of the oracle, replicated deliberately) and
    # adds the endpoint capture event
    ev_vertex: List[int] = []
    ev_site: List[int] = []
    ev_payload: List[Tuple] = []

    def hop_events(key):
        base = site_base[key]
        v0 = hop_vid0.get(key)
        for j in range(branch_hops[key]):
            ev_vertex.append(v0 + j)
            ev_site.append(base + j)
            ev_payload.append(("hop", key, j))

    for name in order:
        node = nl.nodes[name]
        if not seq_out[name]:
            for key in in_keys[name]:
                hop_events(key)
        if _seq_input(node):
            for key in in_keys[name]:
                hop_events(key)
                ev_vertex.append(end_vid[key])
                ev_site.append(-1)
                ev_payload.append(("cap", key, name))

    return LoweredSTA(
        n_verts=n_verts, n_sites=n_sites, n_levels=n_levels,
        overhead=tm.sequential_overhead(), reg_clk_q=tm.reg_clk_q,
        core_pe=tm.core_delay("pe"),
        default_cp=tm.sequential_overhead() + tm.core_delay("pe"),
        vp_kind=vp_kind_a, vp_pred=vp_pred_a, vp_site=vp_site_a,
        vp_delay=vp_delay_a, vp_const=vp_const_a, vlevel=vlevel_a,
        mp_eoff=mp_eoff, mp_ecnt=mp_ecnt, mp_edges=mp_edges,
        lvl_sp=lvl_sp, lvl_mp=lvl_mp,
        site_consumer=site_consumer, succ_off=succ_off, succ_dat=succ_dat,
        ev_vertex=np.asarray(ev_vertex, dtype=np.int64),
        ev_site=np.asarray(ev_site, dtype=np.int64),
        ev_payload=ev_payload,
        order=order, out_vid=out_vid, end_vid=end_vid,
        site_base=site_base, branch_hops=branch_hops,
        branch_driver=branch_driver, in_keys=in_keys, seq_out=seq_out,
        site_delay=site_delay, core_of=core_of,
    )


# ---------------------------------------------------------------------------
# torch backend: a loop over padded level tensors on the device
# ---------------------------------------------------------------------------

def _pad2(rows: List[np.ndarray], width: int, fill: int) -> np.ndarray:
    out = np.full((len(rows), max(1, width)), fill, dtype=np.int64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _pad2f(rows: List[np.ndarray], width: int) -> np.ndarray:
    out = np.zeros((len(rows), max(1, width)), dtype=np.float64)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _torch_state(L: LoweredSTA, device: torch.device) -> dict:
    """The padded level tensors on ``device``, built once per lowering.

    Row ``lv - 1`` of each tensor holds level ``lv``.  The sentinel vertex
    ``n_verts`` absorbs every padded read and write (so padded duplicate
    writes land only there); the sentinel site ``n_sites`` reads the
    mask's always-False trailing slot.  Per-level scatter order is
    irrelevant: every predecessor lives at a strictly smaller level, so
    there are no intra-level dependencies.  ``counts`` holds each level's
    single- and multi-pred vertex counts on the host, so that the loop
    skips an empty group without reading the device.
    """
    sent = L.n_verts
    sp_v, sp_p, sp_s, sp_d = [], [], [], []
    mp_v, mp_c, me_d, me_s = [], [], [], []
    for lv in range(1, L.n_levels):
        sp = L.lvl_sp[lv]
        sp_v.append(sp[0] if sp else np.empty(0, np.int64))
        sp_p.append(sp[1] if sp else np.empty(0, np.int64))
        site = sp[2] if sp else np.empty(0, np.int64)
        sp_s.append(np.where(site < 0, L.n_sites, site))  # -1 -> sentinel
        sp_d.append(sp[3] if sp else np.empty(0, np.float64))
        mp = L.lvl_mp[lv]
        if mp:
            v, core, esrc, eoff = mp
            mp_v.append(v)
            mp_c.append(core)
            dst = np.repeat(v, np.diff(np.append(eoff, len(esrc))))
            me_d.append(dst)
            me_s.append(esrc)
        else:
            mp_v.append(np.empty(0, np.int64))
            mp_c.append(np.empty(0, np.float64))
            me_d.append(np.empty(0, np.int64))
            me_s.append(np.empty(0, np.int64))

    w1 = max((len(r) for r in sp_v), default=0)
    w2 = max((len(r) for r in mp_v), default=0)
    w3 = max((len(r) for r in me_d), default=0)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    return {
        "sp": (dev(_pad2(sp_v, w1, sent)), dev(_pad2(sp_p, w1, sent)),
               dev(_pad2(sp_s, w1, L.n_sites)), dev(_pad2f(sp_d, w1))),
        "mp": (dev(_pad2(mp_v, w2, sent)), dev(_pad2f(mp_c, w2)),
               dev(_pad2(me_d, w3, sent)), dev(_pad2(me_s, w3, sent))),
        "init": dev(np.append(
            np.where(L.vp_kind == _CONST, L.vp_const, 0.0), 0.0)),
        "counts": [(len(v), len(m)) for v, m in zip(sp_v, mp_v)],
    }


# ---------------------------------------------------------------------------
# the incremental engine + one-shot entry point
# ---------------------------------------------------------------------------

class IncrementalSTA:
    """Arrival-time state kept alive across pipelining rounds.

    ``numpy``: the arrival vector is materialized once, then every
    :meth:`analyze` re-propagates only the dirty fanout cone of the
    register sites flipped since the last call.  ``torch``: each analyze
    uploads the mask, re-runs the whole level loop on ``device`` (the card
    unless the caller asks for the CPU) and copies the arrival vector back
    once, as the reference's jax mode re-runs its level scan; reports and
    candidates are assembled on the host.  Reports are bit-identical to
    :func:`repro_torch.core.sta.analyze` in either mode.
    """

    def __init__(self, design: RoutedDesign, tm: TimingModel,
                 backend: str = "numpy",
                 lowering: Optional[LoweredSTA] = None,
                 device=None):
        if backend not in VEC_BACKENDS:
            raise ValueError(f"unknown STA engine backend {backend!r}")
        self.design = design
        self.backend = backend
        self.device = resolve_device(device) if backend == "torch" else None
        self.L = lowering if lowering is not None else lower_design(design, tm)
        self.mask = self.L.initial_mask(design)
        self._dirty: set = set()
        self.arr = (self.L.propagate_numpy(self.mask)
                    if backend == "numpy" else None)

    # -- mask maintenance --------------------------------------------------
    def _flip(self, sites, value: bool) -> None:
        for bkey, j in sites:
            s = self.L.site_id(bkey, j)
            if bool(self.mask[s]) != value:
                self.mask[s] = value
                c = self.L.site_consumer[s]
                if c >= 0:
                    self._dirty.add(int(c))

    def notify_added(self, sites) -> None:
        """Register sites (``(branch_key, hop_idx)``) the loop just set."""
        self._flip(sites, True)

    def notify_removed(self, sites) -> None:
        self._flip(sites, False)

    def resync(self) -> None:
        """Re-read register occupancy from the design (after an external
        rewind, e.g. a power-cap checkpoint restore inside a round hook)."""
        new = self.L.initial_mask(self.design)
        changed = np.nonzero(new != self.mask)[0]
        self.mask = new
        for s in changed:
            c = self.L.site_consumer[s]
            if c >= 0:
                self._dirty.add(int(c))

    # -- analysis ----------------------------------------------------------
    def analyze(self, clock_granularity_ns: float = 0.0,
                with_arrivals: bool = False) -> STAReport:
        """Current-state report.  ``arrival_out`` is omitted by default —
        the pipelining loop never reads it per round; pass
        ``with_arrivals=True`` for a full report."""
        if self.backend == "torch":
            self.arr = self.L.propagate_torch(self.mask, self.device)
            self._dirty.clear()
        elif self._dirty:
            self.L.propagate_incremental(self.arr, self.mask, list(self._dirty))
            self._dirty.clear()
        return self.L.report(self.arr, self.mask, clock_granularity_ns,
                             with_arrivals=with_arrivals)

    def segment_candidates(self, rep: STAReport
                           ) -> List[Tuple[Tuple, int, float]]:
        """Vectorized :func:`repro_torch.core.post_pnr._segment_candidates`:
        one cumsum over the critical segment's per-element delays (same
        left-to-right association as the scalar accumulation), free sites
        filtered by the cached mask.  Byte-identical output list."""
        path = rep.critical_path
        if len(path) < 2:
            return []
        L, design = self.L, self.design
        steps: List[float] = [L.reg_clk_q]
        sites: List[int] = [-1]
        meta: List[Optional[Tuple[Tuple, int]]] = [None]

        def hop_steps(bkey, lo, hi):
            base = L.site_base[bkey]
            for i in range(lo, hi):
                steps.append(float(L.site_delay[base + i]))
                sites.append(base + i)
                meta.append((bkey, i))

        for a, b in zip(path, path[1:]):
            if a[0] == "node" and b[0] == "node":
                bkey = design.branch_key_between(a[1], b[1])
                steps.append(L.core_of.get(a[1], L.core_pe))
                sites.append(-1)
                meta.append(None)
                if bkey is None:
                    continue
                hop_steps(bkey, 0, L.branch_hops[bkey])
            elif a[0] == "node" and b[0] == "hop":
                steps.append(L.core_of.get(a[1], L.core_pe))
                sites.append(-1)
                meta.append(None)
                hop_steps(b[1], 0, b[2] + 1)
            elif a[0] == "hop" and b[0] == "node":
                hop_steps(a[1], a[2] + 1, L.branch_hops[a[1]])
            else:
                hop_steps(a[1], a[2] + 1, b[2] + 1)
        cum = np.cumsum(np.asarray(steps, dtype=np.float64))
        sites_a = np.asarray(sites, dtype=np.int64)
        free = np.nonzero((sites_a >= 0)
                          & ~self.mask[np.clip(sites_a, 0, None)])[0]
        return [(meta[k][0], meta[k][1], float(cum[k])) for k in free]


def analyze_vec(design: RoutedDesign, tm: TimingModel,
                backend: str = "numpy",
                clock_granularity_ns: float = 0.0,
                lowering: Optional[LoweredSTA] = None,
                device=None) -> STAReport:
    """One-shot vectorized STA: lower (or reuse ``lowering``), propagate,
    report.  Bit-identical to the scalar oracle; use
    :class:`IncrementalSTA` when analyzing many pipelining states of the
    same routed structure.  ``device`` is read by the torch backend only
    (``None``: the card)."""
    if backend not in VEC_BACKENDS:
        raise ValueError(f"unknown STA backend {backend!r}; "
                         f"expected one of {VEC_BACKENDS}")
    dev = resolve_device(device) if backend == "torch" else None
    L = lowering if lowering is not None else lower_design(design, tm)
    mask = L.initial_mask(design)
    arr = (L.propagate_numpy(mask) if backend == "numpy"
           else L.propagate_torch(mask, dev))
    return L.report(arr, mask, clock_granularity_ns)
