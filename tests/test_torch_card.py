"""The port's kernels, its smoke trainer and its compiler engines on the card.

Every test marked ``requires_cuda`` needs an NVIDIA card and skips without
one. The module imports torch, numpy and the port only (no jax), so that it
also collects on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_card.py

Each kernel is held to its plain version at the bars of ``chip_smoke.py``:
f32 within 2e-3, bf16 within rtol 1e-2 / atol 1e-3, max-plus bit for bit.
The compiler's torch engines are held to the port's host engines: STA bit
for bit, place and route by legality, determinism and A*'s wirelength.
The simulator kernels are held to their plain versions on the card and to
the numpy backend, bit for bit. Two tests run anywhere: without CUDA,
the torch engines and the torch sim backend raise unless the CPU was asked
for. The last two hold a two-app pack on the torch engines on the card to
its regions and its residents' streams to the interpreter's, and an
evicted-then-readmitted resident's compile on the card to a fresh one.
"""

import copy
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import (flash_decode,  # noqa: E402
                                              flash_decode_ref)
from repro_torch.kernels.maxplus import (NEG_INF, maxplus_matmul,  # noqa: E402
                                         maxplus_matmul_plain)
from repro_torch.core import (ALL_APPS, CascadeCompiler,  # noqa: E402
                              IncrementalSTA, PassConfig, PostPnRParams,
                              analyze, analyze_vec, equivalent,
                              evaluate_design, lower_dense, lower_sparse,
                              post_pnr_pipeline, simulate, simulate_sparse,
                              sparse_equivalent)
from repro_torch.core.dfg import DFG  # noqa: E402
from repro_torch.core.sim_vec import _feed_matrix, _input_matrix  # noqa: E402
from repro_torch.core.interconnect import Fabric  # noqa: E402
from repro_torch.core.netlist import extract_netlist  # noqa: E402
from repro_torch.core.place import PlaceParams, place  # noqa: E402
from repro_torch.core.route import RouteParams, check_legal, route  # noqa: E402
from repro_torch.kernels.sim import (sim_dense, sim_dense_plain,  # noqa: E402
                                     sim_sparse, sim_sparse_plain,
                                     stage_plan)
from repro_torch.kernels.sim.sim import dense_launcher  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402

FD_MOD = importlib.import_module("repro_torch.kernels.flash_decode.flash_decode")
MP_MOD = importlib.import_module("repro_torch.kernels.maxplus.maxplus")
SIM_MOD = importlib.import_module("repro_torch.kernels.sim.sim")
KERNEL_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
              torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_properties(0).multi_processor_count


def _nan_equal(got, want):
    """Equal bit for bit where finite, and NaN at the same positions."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got, nan=0.0),
                                  np.nan_to_num(want, nan=0.0))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_head_dim_16_matches_plain_version(card, dtype):
    """On the card: d = 16 through the tensor-core kernel (bf16) or the
    CUDA-core one (f32), at the bf16 kernel's tile edges, against the plain
    version within the kernel bar."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(16)
    route = ("tensor_core_launches" if dt == torch.bfloat16
             else "cuda_core_launches")
    for s in (1, 127, 128, 129):
        for causal in (True, False):
            q = torch.randn(2, 4, s, 16, generator=gen, device="cuda").to(dt)
            k = torch.randn(2, 2, s, 16, generator=gen, device="cuda").to(dt)
            v = torch.randn(2, 2, s, 16, generator=gen, device="cuda").to(dt)
            before = getattr(flash_attention, route)
            got = flash_attention(q, k, v, causal=causal)
            assert getattr(flash_attention, route) == before + 1
            want = flash_attention_plain(q, k, v, causal=causal)
            torch.testing.assert_close(got.float(), want.float(),
                                       **KERNEL_TOL[dt])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_decode_at_several_splits_matches_plain_version(card, dtype):
    """On the card: the kernel at one, the plan's and many splits, with
    lengths that leave whole splits empty, against its plain version within
    the kernel bar; a split call launches two kernels, an unsplit one one;
    bf16 at head dims 16-128 takes the tensor cores."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, kv, g, t, hd, lens in [(4, 8, 4, 160, 128, [144, 1, 37, 160]),
                                  (2, 2, 6, 1000, 64, [1000, 10]),
                                  (2, 1, 20, 97, 16, [97, 5]),
                                  (2, 1, 3, 300, 256, [299, 2])]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((b, kv, g, hd), (b, kv, t, hd),
                                 (b, kv, t, hd)))
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        want = flash_decode_ref(q, k, v, ln).float()
        for n_split in (1, None, 7, -(-t // 16)):
            p = FD_MOD.plan(b, kv, g, t, hd, q.element_size(), 16, card,
                            n_split)
            before = (flash_decode.device_launches,
                      flash_decode.tensor_core_launches)
            got = (flash_decode(q, k, v, ln, bk=16) if n_split is None
                   else FD_MOD._launch(q, k, v, ln, 16, p))
            assert p.tensor_cores == (dt == torch.bfloat16 and hd <= 128)
            assert (flash_decode.device_launches - before[0],
                    flash_decode.tensor_core_launches - before[1]) == \
                (2 if p.n_split > 1 else 1, int(p.tensor_cores))
            torch.testing.assert_close(got.float(), want, **KERNEL_TOL[dt])


@pytest.mark.requires_cuda
def test_maxplus_equals_plain_version_with_nan_and_splits(card):
    """On the card: every tile and K-split choice equals the plain version
    bit for bit, NaN positions included; a split call launches two
    kernels."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for m, k, n in [(1, 257, 1), (100, 130, 70), (579, 579, 579)]:
        a = torch.randn(m, k, generator=gen, device="cuda")
        b = torch.randn(k, n, generator=gen, device="cuda")
        a[:, ::3] = NEG_INF
        a[0, 0] = float("nan")
        b[k // 2, n // 2] = float("nan")
        want = maxplus_matmul_plain(a, b).cpu().numpy()
        for tile in (64, 128):
            for splits in (1, 3, None):
                p = MP_MOD.plan(m, n, k, card, tile=tile, splits=splits)
                before = maxplus_matmul.device_launches
                got = MP_MOD._launch(a, b, p)
                assert maxplus_matmul.device_launches - before == \
                    (2 if p.splits > 1 else 1)
                _nan_equal(got.cpu().numpy(), want)
        _nan_equal(maxplus_matmul(a, b).cpu().numpy(), want)   # plan's


@pytest.mark.requires_cuda
def test_train_smoke_runs_through_the_tensor_cores(card):
    """On the card: ``train --smoke --steps 4`` runs, with finite losses, and
    every flash_attention launch is the bf16 tensor-core kernel at d = 16."""
    for name in ("launches", "tensor_core_launches", "cuda_core_launches"):
        setattr(flash_attention, name, 0)
    r = T.main(["--smoke", "--steps", "4"])
    cfg = r.model.cfg
    want = 4 * (2 if cfg.remat == "full" else 1) * cfg.num_layers
    assert cfg.head_dim == 16
    assert (flash_attention.launches, flash_attention.tensor_core_launches,
            flash_attention.cuda_core_launches) == (want, want, 0)
    assert len(r.losses) == 4 and all(np.isfinite(r.losses))


# ---------------------------------------------------------------------------
# the compiler's torch engines
# ---------------------------------------------------------------------------


def _routed(app, unroll):
    c = CascadeCompiler(device="cpu")
    r = c.compile(ALL_APPS[app], PassConfig(post_pnr=False, place_moves=40),
                  unroll=unroll)
    return r.design, c.timing


def _report(rep):
    return (rep.critical_path_ns, rep.max_freq_mhz, rep.clock_period_ns,
            rep.n_segments, rep.critical_path, rep.arrival_out)


@pytest.mark.requires_cuda
def test_torch_sta_on_the_card_equals_numpy_engine(card):
    """On the card: the float64 level loop gives the numpy engine's report
    bit for bit, and drives the post-PnR loop to the same state."""
    for app, unroll in (("gaussian", 1), ("harris", 1), ("mttkrp", 2)):
        design, tm = _routed(app, unroll)
        want = analyze(design, tm, backend="numpy")
        assert _report(analyze(design, tm)) == _report(want)
        assert _report(analyze(design, tm, backend="torch")) == _report(want)
        assert (_report(analyze_vec(design, tm, backend="torch",
                                    device="cuda")) == _report(want))
        runs = []
        for backend in ("numpy", "torch"):
            d = copy.deepcopy(design)
            res = post_pnr_pipeline(d, tm, PostPnRParams(max_iters=40),
                                    sta_backend=backend)
            runs.append((res.history, res.stop_reason, res.registers_added,
                         {k: sorted(rb.reg_hops)
                          for k, rb in d.routes.items()}))
        assert runs[0] == runs[1]


@pytest.mark.requires_cuda
def test_torch_placer_on_the_card_legal_and_deterministic(card):
    fabric = Fabric()
    nl = extract_netlist(ALL_APPS["harris"].build(1))
    pp = PlaceParams(seed=2, moves_per_node=60, backend="torch")
    s = {}
    a = place(nl, fabric, pp, stats=s)
    check_legal(nl, a, fabric)
    assert place(nl, fabric, pp) == a
    assert s["devices"] == 1 and len(s["replica_costs"]) == s["replicas"]


@pytest.mark.requires_cuda
def test_torch_router_on_the_card_legal_and_at_most_astar(card):
    fabric = Fabric()
    nl = extract_netlist(ALL_APPS["harris"].build(1))
    pl = place(nl, fabric, PlaceParams(seed=2, moves_per_node=60))
    got = route(nl, pl, fabric, RouteParams(backend="torch"))
    check_legal(nl, pl, fabric, got)
    assert got.total_wirelength() <= route(nl, pl, fabric).total_wirelength()
    # no RNG, first-index tie-breaks, the same float32 sums: the same trees
    # run to run, and on the card as on the CPU
    for other in (route(nl, pl, fabric, RouteParams(backend="torch")),
                  route(nl, pl, fabric, RouteParams(backend="torch"),
                        device="cpu")):
        assert all(got.routes[k].hops == other.routes[k].hops
                   for k in got.routes)


_NO_CUDA_CALLS = ("analyze", "analyze_vec", "IncrementalSTA", "post_pnr",
                  "evaluate_design", "place", "route", "compile_pnr",
                  "compile_sta")


@pytest.mark.parametrize("call", _NO_CUDA_CALLS)
def test_torch_engines_raise_without_cuda_unless_cpu_asked(call,
                                                           monkeypatch):
    """No quiet fallback: ``device=None`` means the card, and without one
    every torch engine raises."""
    design, tm = _routed("gaussian", 1)
    nl = extract_netlist(ALL_APPS["vecadd"].build(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "analyze": lambda: analyze(design, tm, backend="torch"),
        "analyze_vec": lambda: analyze_vec(design, tm, backend="torch"),
        "IncrementalSTA": lambda: IncrementalSTA(design, tm,
                                                 backend="torch"),
        "post_pnr": lambda: post_pnr_pipeline(copy.deepcopy(design), tm,
                                              sta_backend="torch"),
        "evaluate_design": lambda: evaluate_design(
            design, tm, CascadeCompiler().energy, 10, sta_backend="torch"),
        "place": lambda: place(nl, Fabric(), PlaceParams(backend="torch")),
        "route": lambda: route(nl, place(nl, Fabric()), Fabric(),
                               RouteParams(backend="torch")),
        "compile_pnr": lambda: CascadeCompiler().compile(
            ALL_APPS["vecadd"], PassConfig(pnr_backend="torch",
                                           place_moves=2)),
        "compile_sta": lambda: CascadeCompiler().compile(
            ALL_APPS["vecadd"], PassConfig(sta_backend="torch",
                                           place_moves=2)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[call]()


def _sim_inputs(g, length):
    rng = np.random.default_rng(0)
    return {n: rng.integers(0, 0x10000, size=length).tolist()
            for n, nd in g.nodes.items() if nd.kind == "input"}


def _starved():
    g = DFG("starve")
    a, b = g.add("input", name="a"), g.add("input", name="b")
    pe = g.add("pe", name="mix", op="add")
    g.connect(a, pe, port=0)
    g.connect(b, pe, port=1)
    g.connect(pe, g.add("output", name="o"))
    return g.validate()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("app", ["harris", "clip_pipe"])
def test_sim_dense_kernel_equals_plain_version(card, app):
    """On the card: one launch runs all cycles of a dense (harris) and a
    control (clip_pipe) app, bit for bit the plain version's and numpy's."""
    g = ALL_APPS[app].build(1)
    ins = _sim_inputs(g, 300)
    prog = lower_dense(g)
    x = torch.from_numpy(_input_matrix(prog, ins, 300)).cuda()
    before = sim_dense.launches
    got = sim_dense(prog, x, 300)
    assert sim_dense.launches == before + 1
    assert torch.equal(got, sim_dense_plain(prog, x, 300))
    assert simulate(g, ins, 300, backend="torch") == \
        simulate(g, ins, 300, backend="numpy")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["mttkrp", "deadlock"])
def test_sim_sparse_kernel_equals_plain_version(card, case):
    """On the card: the fixpoint's end state (occupancy, feed left, output
    counts, the last round's flag, the rounds) and its streams equal the
    plain version's, on a sparse app and on a graph that deadlocks."""
    if case == "deadlock":
        g, ins = _starved(), {"a": [1, 2, 3], "b": [5]}
    else:
        g = ALL_APPS[case].build(1)
        ins = _sim_inputs(g, 64)
    prog = lower_sparse(g)
    feed, frem = (torch.from_numpy(t).cuda()
                  for t in _feed_matrix(prog, ins))
    before = sim_sparse.launches
    got = sim_sparse(prog, feed, frem, 2560)
    assert sim_sparse.launches == before + 1
    want = sim_sparse_plain(prog, feed, frem, 2560)
    for field in ("blen", "frem", "ocnt", "fired", "rounds"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    for o in range(len(prog.output_names)):
        k = int(want.ocnt[o])
        assert torch.equal(got.outm[o, :k], want.outm[o, :k])
    # both quiesce; the deadlock with feed tokens left
    assert int(got.fired) == 0
    assert bool(got.frem.any()) == (case == "deadlock")


def _chain(k, ops=("add",), rom=False):
    """chip_smoke.py's chain program: INPUT -> k chained PEs (each over the
    one before and the input) -> a ROM if ``rom`` -> OUTPUT."""
    g = DFG("chain")
    i = g.add("input", name="i")
    prev = i
    for j in range(k):
        n = g.add("pe", name=f"n{j}", op=ops[j % len(ops)])
        g.connect(prev, n, port=0)
        if ops[j % len(ops)] != "abs":
            g.connect(i, n, port=1)
        prev = n
    if rom:
        n = g.add("mem", name="lut", op="rom", latency=1,
                  meta={"table": [(977 * t + 11) % 65536 for t in range(37)]})
        g.connect(prev, n)
        prev = n
    g.connect(prev, g.add("output", name="o"))
    return g.validate()


def _wide(seed, width=80):
    """Two layers of random two-input PEs, ``width`` and ``width // 2``
    wide: stages wider than two rounds of 32 lanes."""
    rng = np.random.default_rng(seed)
    ops = ["add", "sub", "mul", "and", "or", "xor", "min", "max"]
    g = DFG("wide")
    layers = [[g.add("input", name=f"in{i}") for i in range(3)]]
    for n in (width, width // 2):
        layer = []
        for _ in range(n):
            pe = g.add("pe", op=ops[int(rng.integers(len(ops)))])
            for port in (0, 1):
                g.connect(layers[-1][int(rng.integers(len(layers[-1])))], pe,
                          port=port)
            layer.append(pe)
        layers.append(layer)
    for i, pe in enumerate(layers[-1]):
        g.connect(pe, g.add("output", name=f"out{i}"))
    return g.validate()


_MIX = ("add", "mul", "xor", "sub", "shr", "min", "max", "or", "and", "gt",
        "abs", "eq", "shl", "ne", "le", "ge")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["add x1", "add x33", "mixed x32 + rom",
                                  "wide"])
def test_sim_dense_kernel_on_chains_and_a_wide_dag(card, case):
    """The chain programs of chip_smoke.py and a seeded DAG whose widest
    stage passes 64 (lanes loop over three rounds): one launch each, bit
    for bit the plain version's."""
    g = {"add x1": lambda: _chain(1), "add x33": lambda: _chain(33),
         "mixed x32 + rom": lambda: _chain(32, _MIX, rom=True),
         "wide": lambda: _wide(0)}[case]()
    prog = lower_dense(g)
    if case == "wide":
        assert max(sum(len(grp.out) for grp in prog.comb_groups[a:b])
                   for a, b in stage_plan(prog)) > 64
    x = torch.from_numpy(_input_matrix(prog, _sim_inputs(g, 300),
                                       300)).cuda()
    before = sim_dense.launches
    out, launch = dense_launcher(prog, x, 300)
    launch()
    assert sim_dense.launches == before + 1
    assert torch.equal(out, sim_dense_plain(prog, x, 300))


@pytest.mark.requires_cuda
def test_sim_sparse_kernel_through_the_feed_window(card, monkeypatch):
    """A feed longer than the staged window: rings refilled by cp.async
    ahead of the feed pointer; end state, rounds and streams equal the
    plain version's, in one launch."""
    monkeypatch.setattr(SIM_MOD, "FEED_WHOLE_WORDS", 0)
    g = ALL_APPS["mttkrp"].build(1)
    prog = lower_sparse(g)
    feed, frem = (torch.from_numpy(t).cuda()
                  for t in _feed_matrix(prog, _sim_inputs(g, 300)))
    assert SIM_MOD.pack_sparse(prog, tuple(feed.shape), 12000)[0][
        "window"] < 300
    before = sim_sparse.launches
    got = sim_sparse(prog, feed, frem, 12000)
    assert sim_sparse.launches == before + 1
    want = sim_sparse_plain(prog, feed, frem, 12000)
    for field in ("blen", "frem", "ocnt", "fired", "rounds"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    k = int(want.ocnt[0])
    assert k == 300 and torch.equal(got.outm[0, :k], want.outm[0, :k])


@pytest.mark.requires_cuda
def test_sim_dense_raises_for_a_program_past_shared_memory(card,
                                                           monkeypatch):
    """A latency ring longer than a block's shared memory runs on the
    global route, bit for bit numpy's; the only refusal left is a program
    larger than the card's free memory, raised before any launch and never
    run on the plain version."""
    g = DFG("deep")
    d = g.add("mem", name="d", op="delay", depth=70_000, latency=1)
    g.connect(g.add("input", name="i"), d)
    g.connect(d, g.add("output", name="o"))
    g.validate()
    ins = {"i": list(range(1, 200))}
    before = (sim_dense.launches, sim_dense.global_launches)
    assert simulate(g, ins, 8, backend="torch") == simulate(
        g, ins, 8, backend="numpy")
    assert (sim_dense.launches, sim_dense.global_launches) == (
        before[0] + 1, before[1] + 1)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (1024, 1024))
    with pytest.raises(ValueError, match="backend='numpy'"):
        simulate(g, ins, 8, backend="torch")
    assert sim_dense.launches == before[0] + 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("width", [1018, 4096])
def test_sim_dense_global_route_on_wide_dags(card, width):
    """The smallest seeded wide DAG past a block's shared memory (width
    1018: 2039 nodes) and one about 4x past it, 256 cycles each: one launch
    on the global route, bit for bit the numpy backend's."""
    g = _wide(0, width)
    ins = _sim_inputs(g, 256)
    before = (sim_dense.launches, sim_dense.global_launches)
    got = simulate(g, ins, 256, backend="torch")
    assert (sim_dense.launches, sim_dense.global_launches) == (
        before[0] + 1, before[1] + 1)
    assert got == simulate(g, ins, 256, backend="numpy")


@pytest.mark.requires_cuda
def test_sim_sparse_global_route_on_a_wide_dag(card):
    """The smallest seeded wide DAG past the sparse kernel's shared memory
    (width 176, as a sparse program): one launch on the global route, end
    state and streams bit for bit the plain version's and numpy's."""
    g = _wide(0, 176)
    g.sparse = True
    ins = _sim_inputs(g, 64)
    before = (sim_sparse.launches, sim_sparse.global_launches)
    got = simulate_sparse(g, ins, 64 * 40, backend="torch")
    assert (sim_sparse.launches, sim_sparse.global_launches) == (
        before[0] + 1, before[1] + 1)
    assert got == simulate_sparse(g, ins, 64 * 40, backend="numpy")
    prog = lower_sparse(g)
    feed, frem = (torch.from_numpy(t).cuda()
                  for t in _feed_matrix(prog, ins))
    k, want = (sim_sparse(prog, feed, frem, 2560),
               sim_sparse_plain(prog, feed, frem, 2560))
    for field in ("blen", "frem", "ocnt", "fired", "rounds"):
        assert torch.equal(getattr(k, field), getattr(want, field)), field


_SIM_CALLS = ("simulate", "simulate_sparse", "equivalent",
              "sparse_equivalent")


@pytest.mark.parametrize("call", _SIM_CALLS)
def test_torch_sim_backend_raises_without_cuda_unless_cpu_asked(call,
                                                                 monkeypatch):
    """``backend="torch"`` means the card; without one it raises, and with
    ``device="cpu"`` it runs the plain versions and equals numpy."""
    dense, sparse = ALL_APPS["gaussian"].build(1), ALL_APPS["vecadd"].build(1)
    dins, sins = _sim_inputs(dense, 80), _sim_inputs(sparse, 8)
    calls = {
        "simulate": lambda **kw: simulate(dense, dins, 16, **kw),
        "simulate_sparse": lambda **kw: simulate_sparse(sparse, sins, 256,
                                                        **kw),
        "equivalent": lambda **kw: equivalent(dense, dense.copy(), dins,
                                              n=16, **kw),
        "sparse_equivalent": lambda **kw: sparse_equivalent(
            sparse, sparse.copy(), sins, **kw)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[call](backend="torch")
    assert (calls[call](backend="torch", device="cpu")
            == calls[call](backend="numpy"))


# ---------------------------------------------------------------------------
# multi-app fabric sharing and the online scheduler on the card
# ---------------------------------------------------------------------------

MULTI_TORCH = PassConfig.full(place_moves=20, pnr_backend="torch",
                              sta_backend="torch")


def _resident_streams(r):
    """(verdict through the kernels, the interpreter's verdict, streams
    through the kernels, the interpreter's streams) of one resident, with
    the verify pass's inputs (64 tokens a stream for a sparse app)."""
    from repro_torch.core import clear_ref_memo
    ref, final = r.app.build(1), r.design.netlist.to_dfg()
    rng = np.random.default_rng(0)
    size, hi = (64, 0x10000) if r.app.sparse else (48, 255)
    ins = {n: rng.integers(0, hi, size=size).tolist()
           for n, nd in ref.nodes.items() if nd.kind == "input"}
    out = []
    for backend in ("torch", "interpreter"):
        clear_ref_memo()
        if r.app.sparse:
            out.append((sparse_equivalent(ref, final, ins, backend=backend),
                        simulate_sparse(final, ins, backend=backend)))
        else:
            out.append((equivalent(ref, final, ins, n=32, backend=backend),
                        simulate(final, ins, 128, backend=backend)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.requires_cuda
def test_two_app_pack_on_the_card_fenced_and_simulates(card):
    from repro_torch.core import CompileCache, MultiAppSpec
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache(),
                        device="cuda")
    m = c.compile_multi(MultiAppSpec.of(ALL_APPS["unsharp"],
                                        ALL_APPS["vecadd"],
                                        config=MULTI_TORCH),
                        backend="thread")
    sim_dense.launches = sim_sparse.launches = 0
    for r in m.results:
        region = m.regions[r.app.name]
        assert "region_fence_check" in r.pass_stats["pipeline"]
        assert all(region.contains(t) for t in r.design.placement.values())
        for rb in r.design.routes.values():
            assert all(region.contains(h.src) and region.contains(h.dst)
                       for h in rb.hops)
        ok_t, ok_i, got, want = _resident_streams(r)
        assert ok_t is ok_i is True and got == want
    # one launch a graph: source, design, design again for the streams
    assert (sim_dense.launches, sim_sparse.launches) == (3, 3)


@pytest.mark.requires_cuda
def test_evict_and_readmit_on_the_card_byte_identical(card):
    import json
    from repro_torch.core import (CompileCache, CompileService,
                                  FabricScheduler, resident_config,
                                  session_trace)
    narrow = Fabric(rows=8, cols=8, mem_col_stride=4, name="sched8x8")
    trace = session_trace([("vecadd", 0, 10_000_000),
                           ("elemmul", 100, None),
                           ("ttv", 5_000_000, 30_000_000)],
                          period=100_000, name="readmit")
    seated = {}

    class Audit(FabricScheduler):
        def _compile_into(self, app, cfg, slot, *a):
            ok = super()._compile_into(app, cfg, slot, *a)
            if ok:
                seated[app.name] = (slot, self._residents[app.name].result)
            return ok

    svc = CompileService(fabric=narrow, batch_window_s=0.0,
                         device="cuda").start()
    try:
        out = Audit(service=svc, allow_evict=False).run(
            trace, ALL_APPS, configs={n: MULTI_TORCH for n in trace.arrivals})
    finally:
        svc.stop()
    assert out.rejected == 1 and out.readmitted == 1
    region, served = seated["ttv"]
    fresh = CascadeCompiler(fabric=narrow, cache=CompileCache(),
                            stage_cache=CompileCache(), device="cuda")
    direct = fresh.compile(ALL_APPS["ttv"],
                           resident_config(MULTI_TORCH, region))
    assert served.design.placement == direct.design.placement
    assert (json.dumps(served.summary(), sort_keys=True)
            == json.dumps(direct.summary(), sort_keys=True))
