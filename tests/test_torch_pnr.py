"""The port's torch PnR backend against the JAX package's, on the CPU.

The parallel-tempering placer (``place_torch``) and the batched wavefront
router (``route_torch``) are the reference's jitted ``place_jax`` /
``route_jax`` as torch programs (``device="cpu"`` here).  The placer's
host-side set-up must be bit-identical to ``place_jax``'s, and fed the
reference's uniforms its anneal must take the same moves; with its own
``torch.Generator`` it is held to the reference's own bars: legal, fenced
to its region, deterministic per seed, and within 1.10x of the
single-chain numpy cost.  The router has no RNG: it must be legal,
fenced, deterministic, no longer than A* — and it grows the same trees as
the reference's jax router.
"""

import importlib

import numpy as np
import pytest

from repro.core import ALL_APPS as REF_APPS  # noqa: E402
from repro.core import place_jax as ref_place_jax  # noqa: E402
from repro.core.interconnect import Fabric as RefFabric  # noqa: E402
from repro.core.interconnect import Region as RefRegion  # noqa: E402
from repro.core.netlist import extract_netlist as ref_extract  # noqa: E402
from repro.core.place import PlaceParams as RefPlaceParams  # noqa: E402
from repro.core.place import place as ref_place  # noqa: E402
from repro.core.route import RouteParams as RefRouteParams  # noqa: E402
from repro.core.route import route as ref_route  # noqa: E402
from repro_torch.core import (ALL_APPS, CascadeCompiler, PassConfig,  # noqa: E402
                              Region)
from repro_torch.core.config import PNR_BACKENDS  # noqa: E402
from repro_torch.core.interconnect import Fabric  # noqa: E402
from repro_torch.core.netlist import extract_netlist  # noqa: E402
from repro_torch.core.place import PlaceParams, place  # noqa: E402
from repro_torch.core.route import RouteParams, check_legal, route  # noqa: E402
from repro_torch.core.place_torch import _anneal_setup  # noqa: E402

ref_place_mod = importlib.import_module("repro.core.place")
port_place_mod = importlib.import_module("repro_torch.core.place")

FABRIC = Fabric()
DEV = "cpu"


def _netlist(app="vecadd", mult=1):
    return extract_netlist(ALL_APPS[app].build(mult))


def _hops(design):
    return {k: [(h.src, h.dst) for h in rb.hops]
            for k, rb in design.routes.items()}


# ---------------------------------------------------------------------------
# the placer's host-side set-up: bit for bit the reference's
# ---------------------------------------------------------------------------


def _problem(mod, nl, fabric, region):
    """(nets, cls, sites) as ``place()`` builds them in ``mod``."""
    nets = mod._Nets(nl)
    cls = [mod.TILE_CLASS[nl.nodes[name].kind] for name in nets.names]
    sites = {"pe": fabric.pe_tiles(), "mem": fabric.mem_tiles(),
             "io": fabric.io_tiles() * mod.IO_CAPACITY}
    if region is not None:
        sites = {c: [t for t in ts if region.contains(t)]
                 for c, ts in sites.items()}
    return nets, cls, sites


_SETUPS = {
    "vecadd-default": ("vecadd", 1, None, {}),
    "harris-default": ("harris", 1, None, {}),
    "gaussian-region": ("gaussian", 1, (0, 8, 32, 8), {"seed": 3}),
    "vecadd-knobs": ("vecadd", 1, None,
                     dict(seed=5, replicas=3, replica_spread=0.5,
                          proposal_block=8, moves_per_node=60,
                          alpha=1.6, t_factor=0.9)),
}


@pytest.mark.parametrize("case", sorted(_SETUPS))
def test_anneal_setup_equals_place_jax(case, monkeypatch):
    """The reference's ``anneal_jax`` with its jitted kernel replaced by a
    recorder: the tables, initial states, costs, temperature ladder and
    loop shape it hands the kernel equal the port's ``_anneal_setup``."""
    app, mult, reg, kw = _SETUPS[case]
    seen = {}

    def fake_jitted(n, n_nets, n_slots, replicas, K, n_temps,
                    blocks_per_temp):
        seen["shape"] = (replicas, K, n_temps, blocks_per_temp)

        def run(tables, state, temps, key, t_factor):
            seen.update(tables=tables, state=state, temps=temps)
            return state
        return run

    monkeypatch.setattr(ref_place_jax, "_jitted_anneal", fake_jitted)
    ref_nl = ref_extract(REF_APPS[app].build(mult))
    ref_region = RefRegion(*reg) if reg else None
    ref_place_jax.anneal_jax(*_problem(ref_place_mod, ref_nl, RefFabric(),
                                       ref_region),
                             RefPlaceParams(backend="jax", **kw))
    su = _anneal_setup(*_problem(port_place_mod, _netlist(app, mult), FABRIC,
                                 Region(*reg) if reg else None),
                       PlaceParams(backend="torch", **kw))

    assert seen["shape"] == (su["replicas"], su["K"], su["n_temps"],
                             su["blocks_per_temp"])
    names = ("site_rc", "node_off", "node_pool", "node_nets", "term_mat",
             "term_count", "pow_tab")
    for name, want in zip(names, seen["tables"]):
        want = np.asarray(want)
        assert su[name].dtype == want.dtype, name
        np.testing.assert_array_equal(su[name], want, err_msg=name)
    for name, want in zip(("site0", "occ0", "cost0"), seen["state"]):
        want = np.asarray(want)
        assert su[name].dtype == want.dtype, name
        np.testing.assert_array_equal(su[name], want, err_msg=name)
    np.testing.assert_array_equal(su["temps0"], np.asarray(seen["temps"]))
    assert su["temps0"].dtype == np.float32


def _reference_uniforms(seed, replicas, K, n_temps, blocks_per_temp):
    """The uniforms the reference's ``_jitted_anneal`` draws from
    ``PRNGKey(seed)``, in the order the port's ``_anneal`` takes them: per
    temperature step the ``(blocks, R, K, 3)`` proposals, then ``(R,)``
    for the exchange.  The key tree is the reference's ``segment`` /
    ``chain_segment`` / ``block_step`` split, key by key."""
    from jax import random

    out = []
    key = random.PRNGKey(int(seed))
    for _ in range(n_temps):
        key, k_moves, k_swap = random.split(key, 3)
        rkeys = random.split(k_moves, replicas)
        moves = np.stack([
            np.stack([np.asarray(random.uniform(k, (K, 3)))
                      for k in random.split(rkeys[r], blocks_per_temp)])
            for r in range(replicas)], axis=1)
        out.append(moves)
        out.append(np.asarray(random.uniform(k_swap, (replicas,))))
    assert all(a.dtype == np.float32 for a in out)
    return out


@pytest.mark.parametrize("case", ["vecadd-default", "gaussian-region",
                                  "vecadd-knobs"])
def test_anneal_equals_place_jax_on_same_uniforms(case):
    """The anneal itself — the per-proposal Eq. 1 delta with its patched
    i/j terminals, the triangular conflict rule, the sentinel scatters, the
    best tracker and the Metropolis exchange — against the reference's
    jitted program on the same set-up and the same uniforms, for a few
    temperature steps: the same best sites, best costs, evaluated and
    accepted counts per replica (the best costs up to float32 summation
    order)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro_torch.core.place_torch import _anneal

    app, mult, reg, kw = _SETUPS[case]
    p = PlaceParams(backend="torch", **kw)
    su = _anneal_setup(*_problem(port_place_mod, _netlist(app, mult), FABRIC,
                                 Region(*reg) if reg else None), p)
    su["n_temps"] = 6
    R, K, bpt = su["replicas"], su["K"], su["blocks_per_temp"]
    n, n_slots = su["site0"].shape[1], su["occ0"].shape[1]
    n_nets = su["term_mat"].shape[0]

    ref = ref_place_jax._jitted_anneal(n, n_nets, n_slots, R, K,
                                       su["n_temps"], bpt)
    tables = tuple(jnp.asarray(su[k]) for k in (
        "site_rc", "node_off", "node_pool", "node_nets", "term_mat",
        "term_count", "pow_tab"))
    zeros = jnp.zeros(R, dtype=jnp.int32)
    state = (jnp.asarray(su["site0"]), jnp.asarray(su["occ0"]),
             jnp.asarray(su["cost0"]), jnp.asarray(su["cost0"]),
             jnp.asarray(su["site0"]), zeros, zeros)
    want = ref(tables, state, jnp.asarray(su["temps0"]),
               jax.random.PRNGKey(int(p.seed)),
               jnp.float32(p.t_factor))

    stream = _reference_uniforms(p.seed, R, K, su["n_temps"], bpt)

    def draw(shape):
        u = stream.pop(0)
        assert u.shape == shape
        return torch.from_numpy(u.copy())

    got = _anneal(su, p.seed, p.t_factor, torch.device(DEV), draw=draw)
    assert not stream
    best_cost, best_site, ev, acc = (x.numpy() for x in got)
    assert best_cost.dtype == np.float32
    np.testing.assert_array_equal(best_site, np.asarray(want[4]))
    # the per-net float32 costs are the same table entries; XLA and torch
    # add them up in another order, so the totals may differ in the last
    # bits (a few ulp at these sizes)
    np.testing.assert_allclose(best_cost, np.asarray(want[3]), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(ev, np.asarray(want[5]))
    np.testing.assert_array_equal(acc, np.asarray(want[6]))
    assert acc.sum() > 0   # the replay moved something


# ---------------------------------------------------------------------------
# the torch placer: legality, determinism, region fence, cost bar
# ---------------------------------------------------------------------------


def test_all_place_backends_legal_and_cost_comparable():
    nl = _netlist("vecadd")
    costs = {}
    for backend in PNR_BACKENDS:
        s = {}
        pl = place(nl, FABRIC, PlaceParams(seed=2, moves_per_node=60,
                                           backend=backend,
                                           proposal_block=8), stats=s,
                   device=DEV)
        assert s["backend"] == backend
        check_legal(nl, pl, FABRIC)
        costs[backend] = s["best_cost"]
    # scalar and numpy are the bit-identical pair; torch anneals the same
    # Eq. 1 objective with a replica ensemble and must land within the
    # reference's tolerance of the single-chain result
    assert costs["scalar"] == costs["numpy"]
    assert costs["torch"] <= costs["numpy"] * 1.10


def test_torch_placement_deterministic_per_seed():
    nl = _netlist("vecadd")
    pp = PlaceParams(seed=5, moves_per_node=60, backend="torch",
                     proposal_block=8)
    a = place(nl, FABRIC, pp, device=DEV)
    b = place(nl, FABRIC, pp, device=DEV)
    assert a == b
    c = place(nl, FABRIC, PlaceParams(seed=6, moves_per_node=60,
                                      backend="torch", proposal_block=8),
              device=DEV)
    assert c != a   # the seed actually steers the ensemble


def test_torch_placement_region_fenced():
    nl = _netlist("vecadd")
    region = Region(0, 8, 32, 8)
    pl = place(nl, FABRIC, PlaceParams(seed=1, moves_per_node=60,
                                       backend="torch", proposal_block=8),
               region=region, device=DEV)
    check_legal(nl, pl, FABRIC, region=region)


def test_torch_replica_ensemble_stats_surface():
    nl = _netlist("vecadd")
    s = {}
    place(nl, FABRIC, PlaceParams(seed=0, moves_per_node=60,
                                  backend="torch", replicas=2,
                                  proposal_block=8), stats=s, device=DEV)
    assert s["replicas"] == 2 and s["devices"] == 1
    assert len(s["replica_costs"]) == 2
    assert s["best_replica"] in (0, 1)
    assert s["best_cost"] == pytest.approx(min(s["replica_costs"]), rel=1e-5)
    assert 0 < s["moves_accepted"] <= s["moves_evaluated"]


# ---------------------------------------------------------------------------
# the torch router: legality, wirelength, determinism, region fence
# ---------------------------------------------------------------------------


def test_torch_routes_legal_and_wirelength_at_most_astar():
    nl = _netlist("vecadd")
    pl = place(nl, FABRIC, PlaceParams(seed=2, moves_per_node=60))
    rd_np = route(nl, pl, FABRIC)
    rd_t = route(nl, pl, FABRIC, RouteParams(backend="torch"), device=DEV)
    check_legal(nl, pl, FABRIC, rd_t)
    assert rd_t.total_wirelength() <= rd_np.total_wirelength()


@pytest.mark.parametrize("app,mult", [("vecadd", 1), ("gaussian", 1),
                                      ("harris", 1)])
def test_torch_routes_equal_jax_router(app, mult):
    """Same placement, same frozen-snapshot negotiation, same first-index
    tie-breaks and the same float32 sums: the same trees as the
    reference's batched router."""
    nl = _netlist(app, mult)
    pl = place(nl, FABRIC, PlaceParams(seed=2, moves_per_node=60))
    ref_nl = ref_extract(REF_APPS[app].build(mult))
    ref_pl = ref_place(ref_nl, RefFabric(),
                       RefPlaceParams(seed=2, moves_per_node=60))
    assert ref_pl == pl
    got = route(nl, pl, FABRIC, RouteParams(backend="torch"), device=DEV)
    want = ref_route(ref_nl, ref_pl, RefFabric(),
                     RefRouteParams(backend="jax"))
    assert _hops(got) == _hops(want)
    check_legal(nl, pl, FABRIC, got)


def test_torch_route_deterministic():
    nl = _netlist("vecadd")
    pl = place(nl, FABRIC, PlaceParams(seed=2, moves_per_node=60))
    a = route(nl, pl, FABRIC, RouteParams(backend="torch"), device=DEV)
    b = route(nl, pl, FABRIC, RouteParams(backend="torch"), device=DEV)
    assert _hops(a) == _hops(b)


def test_torch_route_region_fenced():
    nl = _netlist("vecadd")
    region = Region(0, 8, 32, 8)
    pl = place(nl, FABRIC, PlaceParams(seed=1, moves_per_node=60),
               region=region)
    rd = route(nl, pl, FABRIC.subregion(region),
               RouteParams(backend="torch"), region=region, device=DEV)
    check_legal(nl, pl, FABRIC, rd, region=region)


def _break(kind, nl, pl, rd):
    """Corrupt one legal (placement, design) pair in one way."""
    pl = dict(pl)
    pes = [k for k in nl.nodes if FABRIC.tile_kind(pl[k]) == "pe"]
    if kind == "site-conflict":
        pl[pes[1]] = pl[pes[0]]
    elif kind == "wrong-class":
        pl[pes[0]] = FABRIC.mem_tiles()[0]
    elif kind == "outside-region":
        pl[pes[0]] = next(t for t in FABRIC.pe_tiles()
                          if not Region(0, 8, 32, 8).contains(t))
    elif kind == "broken-route":
        key, rb = next((k, rb) for k, rb in rd.routes.items()
                       if len(rb.hops) >= 2)
        rb = type(rb)(branch=rb.branch, hops=rb.hops[:1] + rb.hops[2:])
        rd = type(rd)(netlist=rd.netlist, placement=rd.placement,
                      routes={**rd.routes, key: rb}, fabric=rd.fabric)
    return pl, rd


@pytest.mark.parametrize("kind", ["site-conflict", "wrong-class",
                                  "outside-region", "broken-route"])
def test_check_legal_catches_each_fault(kind):
    """The one legality check that the tests and the card phase share
    passes a legal fenced result and names each kind of fault."""
    nl = _netlist("vecadd")
    region = Region(0, 8, 32, 8)
    pl = place(nl, FABRIC, PlaceParams(seed=1, moves_per_node=60),
               region=region)
    rd = route(nl, pl, FABRIC.subregion(region), region=region)
    check_legal(nl, pl, FABRIC, rd, region=region)
    bad_pl, bad_rd = _break(kind, nl, pl, rd)
    with pytest.raises(RuntimeError, match=nl.name):
        check_legal(nl, bad_pl, FABRIC,
                    bad_rd if kind == "broken-route" else None,
                    region=region)


def test_unknown_pnr_backend_rejected():
    with pytest.raises(ValueError, match="unknown place backend"):
        place(_netlist(), FABRIC, PlaceParams(backend="jax"))
    with pytest.raises(ValueError, match="unknown route backend"):
        route(_netlist(), {}, FABRIC, RouteParams(backend="jax"))


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def test_compile_end_to_end_with_torch_backend():
    c = CascadeCompiler(device=DEV)
    r = c.compile(ALL_APPS["vecadd"],
                  PassConfig(pnr_backend="torch", pnr_replicas=2,
                             place_moves=20))
    st = r.pass_stats["pnr"]["place"]
    assert st["backend"] == "torch" and st["replicas"] == 2
    assert r.design.total_wirelength() > 0
    check_legal(r.design.netlist, r.design.placement, r.design.fabric,
                r.design)
