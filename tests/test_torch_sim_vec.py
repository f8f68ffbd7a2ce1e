"""The port's vectorized simulator against the JAX package's, on the CPU.

The same graphs, built in both packages, and the same numpy-seeded inputs
go through the reference (interpreter, ``numpy`` and ``jax`` backends) and
the port (``numpy``, and ``torch`` on the CPU, which runs the plain
versions of the ``sim_dense`` / ``sim_sparse`` kernels). The bar is the
reference's own: bit-identical streams, deadlock diagnostics and lowerings.
The kernels run only on the card (``tests/test_torch_card.py``); here their
host side is held: the stage plan, the packed program and the header and
opcode layouts the CUDA sources expect.
"""

import copy
import re
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from test_cascade_core import random_dfg, random_pred_dfg

from repro.core import CONTROL_APPS as REF_CONTROL  # noqa: E402
from repro.core import DENSE_APPS as REF_DENSE  # noqa: E402
from repro.core import SPARSE_APPS as REF_SPARSE  # noqa: E402
from repro.core import equivalent as ref_equivalent  # noqa: E402
from repro.core import lower_dense as ref_lower_dense  # noqa: E402
from repro.core import lower_sparse as ref_lower_sparse  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro.core import simulate_sparse as ref_simulate_sparse  # noqa: E402
from repro.core.cache import dfg_fingerprint as ref_fingerprint  # noqa: E402
from repro.core.dfg import DFG as RefDFG  # noqa: E402
from repro.core.dfg import PRED_PORT  # noqa: E402
from repro_torch.core import (CONTROL_APPS, DENSE_APPS,  # noqa: E402
                              SIM_BACKENDS, SPARSE_APPS, SimLoweringError,
                              clear_ref_memo, dfg_fingerprint, equivalent,
                              lower_dense, lower_sparse, simulate,
                              simulate_sparse, sparse_equivalent)
from repro_torch.core.dfg import DFG, INPUT, PE  # noqa: E402
from repro_torch.core.pipelining import compute_pipelining  # noqa: E402
from repro_torch.core.sim import ref_memo_stats  # noqa: E402
from repro_torch.core.sim_vec import _OPS  # noqa: E402
from repro_torch.kernels import sim as K  # noqa: E402
from repro_torch.kernels.sim.sim import (DENSE_FIELDS,  # noqa: E402
                                         SPARSE_FIELDS, pack_dense,
                                         pack_sparse)

CSRC = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
        / "kernels" / "sim" / "csrc")
PORT_BACKENDS = ("numpy", "torch")
REF_BACKENDS = ("interpreter", "numpy", "jax")
DENSE_CYCLES, SPARSE_TOKENS, SPARSE_MAX = 96, 48, 4096
ALL_DENSE = sorted(DENSE_APPS) + sorted(CONTROL_APPS)
# combinational stages of each app's sim_dense plan, and the buffers of each
# sparse app (all of capacity <= 2)
STAGES = {"gaussian": 7, "unsharp": 12, "camera": 8, "harris": 16,
          "resnet": 5, "thresh_conv": 9, "clip_pipe": 14, "refine": 38}
BUFFERS = {"vecadd": 18, "elemmul": 24, "mttkrp": 34, "ttv": 22}


def _ref_app(name):
    return {**REF_DENSE, **REF_CONTROL, **REF_SPARSE}[name].build(1)


def _port_app(name):
    return {**DENSE_APPS, **CONTROL_APPS, **SPARSE_APPS}[name].build(1)


def _port_graph(g: RefDFG) -> DFG:
    """The reference DFG ``g`` rebuilt node for node and edge for edge."""
    pg = DFG(g.name, sparse=g.sparse)
    for n in g.nodes.values():
        pg.add(n.kind, name=n.name, op=n.op, width=n.width,
               latency=n.latency, input_reg=n.input_reg, depth=n.depth,
               value=n.value, meta=copy.deepcopy(n.meta))
    for e in g.edges:
        pg.connect(e.src, e.dst, port=e.port, width=e.width)
    return pg


def _inputs(g, length, seed=0):
    rng = np.random.default_rng(seed)
    return {n: rng.integers(0, 0x10000, size=length).tolist()
            for n, nd in g.nodes.items() if nd.kind == INPUT}


def _port_dense(g, ins, cycles):
    return {b: simulate(g, ins, cycles, backend=b, device="cpu")
            for b in PORT_BACKENDS}


def _ref_dense(g, ins, cycles):
    return {b: ref_simulate(g, ins, cycles, backend=b) for b in REF_BACKENDS}


def _assert_all_equal(port: dict, ref: dict):
    want = ref["interpreter"]
    assert all(out == want for out in ref.values()), "reference backends"
    for backend, out in port.items():
        assert out == want, backend


def _same_arrays(a, b) -> bool:
    return (np.asarray(a).dtype == np.asarray(b).dtype
            and np.array_equal(np.asarray(a), np.asarray(b)))


# ---------------------------------------------------------------------------
# numpy-seeded twins of the hypothesis strategies of test_cascade_core.py
# ---------------------------------------------------------------------------


BINOPS = ["add", "sub", "mul", "and", "or", "xor", "min", "max"]
CMPS = ["gt", "lt", "eq", "ne", "ge", "le"]


def _seeded_dfg(seed) -> RefDFG:
    """A ``random_dfg`` draw from a numpy generator."""
    rng = np.random.default_rng(seed)
    pick = lambda xs: xs[int(rng.integers(len(xs)))]   # noqa: E731
    g = RefDFG("prop")
    srcs = [g.add("input", name=f"in{i}") for i in range(rng.integers(1, 4))]
    for _ in range(rng.integers(1, 15)):
        kind = pick(["pe"] * 6 + ["delay", "rf"])
        if kind == "pe":
            n = g.add("pe", op=pick(BINOPS))
            g.connect(pick(srcs), n, port=0)
            g.connect(pick(srcs), n, port=1)
        elif kind == "delay":
            n = g.add("mem", op="delay", depth=int(rng.integers(1, 4)),
                      latency=1)
            g.connect(pick(srcs), n)
        else:
            n = g.add("rf", depth=int(rng.integers(1, 3)))
            g.connect(pick(srcs), n)
        srcs.append(n)
    return _outputs(g)


def _seeded_pred_dfg(seed) -> RefDFG:
    """A ``random_pred_dfg`` draw from a numpy generator."""
    rng = np.random.default_rng(seed)
    pick = lambda xs: xs[int(rng.integers(len(xs)))]   # noqa: E731
    g = RefDFG("pred_prop")
    srcs = [g.add("input", name=f"in{i}") for i in range(rng.integers(2, 4))]
    for _ in range(rng.integers(2, 15)):
        kind = pick(["pe"] * 4 + ["cmp"] * 2 + ["mux", "steer", "sel", "phi",
                                                "pacc", "delay"])
        if kind in ("pe", "cmp"):
            n = g.add("pe", op=pick(BINOPS if kind == "pe" else CMPS))
            g.connect(pick(srcs), n, port=0)
            g.connect(pick(srcs), n, port=1)
        elif kind == "mux":
            n = g.add("pe", op="mux")
            for p in range(3):
                g.connect(pick(srcs), n, port=p)
        elif kind in ("sel", "phi"):
            n = g.add("pe", op=kind)
            g.connect(pick(srcs), n, port=0)
            g.connect(pick(srcs), n, port=1)
            g.connect(pick(srcs), n, port=PRED_PORT)
        elif kind == "steer":
            n = g.add("pe", op="steer")
            g.connect(pick(srcs), n, port=0)
            g.connect(pick(srcs), n, port=PRED_PORT)
        elif kind == "pacc":
            n = g.add("mem", op="accum", latency=1)
            g.connect(pick(srcs), n)
            g.connect(pick(srcs), n, port=PRED_PORT)
        else:
            n = g.add("mem", op="delay", depth=int(rng.integers(1, 4)),
                      latency=1)
            g.connect(pick(srcs), n)
        srcs.append(n)
    return _outputs(g)


def _outputs(g):
    sinks = [n for n in g.nodes if not g.succs(n)
             and g.nodes[n].kind != "output"]
    for i, s in enumerate(sinks):
        g.connect(s, g.add("output", name=f"out{i}"))
    return g.validate()


def _check_random(g: RefDFG, seed: int):
    pg = _port_graph(g)
    ins = _inputs(g, 32, seed)
    _assert_all_equal(_port_dense(pg, ins, 32), _ref_dense(g, ins, 32))
    _assert_lowering_equal(lower_dense(pg), ref_lower_dense(g))


# ---------------------------------------------------------------------------
# the lowering, array for array
# ---------------------------------------------------------------------------


def _assert_lowering_equal(got, want):
    assert got.signature() == want.signature()
    for f in ("name", "n_nodes", "order", "input_names", "output_names",
              "max_lat"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("input_pos", "output_pos", "const_pos", "const_vals",
              "accum_pos", "accum_src", "accum_pred", "accum_pmask",
              "seq_pos", "seq_lat", "table_mat", "tab_len"):
        assert _same_arrays(getattr(got, f), getattr(want, f)), f
    for kind in ("comb_groups", "seq_groups"):
        gs, ws = getattr(got, kind), getattr(want, kind)
        assert len(gs) == len(ws)
        for a, b in zip(gs, ws):
            assert a.op == b.op
            for f in ("out", "args", "rom_rows"):
                assert _same_arrays(getattr(a, f), getattr(b, f)), (kind, f)


def test_graph_copy_keeps_the_reference_fingerprint():
    for name in ALL_DENSE + sorted(SPARSE_APPS):
        g = _ref_app(name)
        assert dfg_fingerprint(_port_graph(g)) == ref_fingerprint(g)
        assert dfg_fingerprint(_port_app(name)) == ref_fingerprint(g)


@pytest.mark.parametrize("app", ALL_DENSE)
def test_dense_lowering_equals_reference(app):
    _assert_lowering_equal(lower_dense(_port_app(app)),
                           ref_lower_dense(_ref_app(app)))


@pytest.mark.parametrize("app", sorted(SPARSE_APPS))
def test_sparse_lowering_equals_reference(app):
    got, want = lower_sparse(_port_app(app)), ref_lower_sparse(_ref_app(app))
    assert got.signature() == want.signature()
    for f, v in vars(want).items():
        if isinstance(v, np.ndarray):
            assert _same_arrays(getattr(got, f), v), f
        else:
            assert getattr(got, f) == v, f


def test_lower_dense_signature_is_hashable_and_stable():
    g = DENSE_APPS["harris"].build(1)
    p1, p2 = lower_dense(g), lower_dense(g)
    assert p1.signature() == p2.signature()
    hash(p1.signature())


# ---------------------------------------------------------------------------
# streams, bit for bit, on the apps and on random DAGs
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _ref_app_streams(app):
    g = _ref_app(app)
    if app in SPARSE_APPS:
        ins = _inputs(g, SPARSE_TOKENS)
        return ins, {b: ref_simulate_sparse(g, ins, SPARSE_MAX, backend=b)
                     for b in REF_BACKENDS}
    ins = _inputs(g, DENSE_CYCLES)
    return ins, _ref_dense(g, ins, DENSE_CYCLES)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("app", ALL_DENSE)
def test_dense_streams_equal_reference(app, backend):
    ins, ref = _ref_app_streams(app)
    got = simulate(_port_app(app), ins, DENSE_CYCLES, backend=backend,
                   device="cpu")
    _assert_all_equal({backend: got}, ref)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("app", sorted(SPARSE_APPS))
def test_sparse_streams_equal_reference(app, backend):
    ins, ref = _ref_app_streams(app)
    got = simulate_sparse(_port_app(app), ins, SPARSE_MAX, backend=backend,
                          device="cpu")
    _assert_all_equal({backend: got}, ref)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_dense_backend_deterministic_across_calls(backend):
    g = DENSE_APPS["gaussian"].build(1)
    ins = _inputs(g, 64, seed=7)
    assert (simulate(g, ins, 64, backend=backend, device="cpu")
            == simulate(g, ins, 64, backend=backend, device="cpu"))


@settings(max_examples=12, deadline=None)
@given(random_dfg(), st.integers(0, 3))
def test_streams_equal_reference_on_random_dags(g, seed):
    _check_random(g, seed)


@settings(max_examples=12, deadline=None)
@given(random_pred_dfg(), st.integers(0, 3))
def test_streams_equal_reference_on_predicated_dags(g, seed):
    _check_random(g, seed)


@pytest.mark.parametrize("seed", range(8))
def test_streams_equal_reference_on_seeded_dags(seed):
    _check_random(_seeded_dfg(seed), seed)


@pytest.mark.parametrize("seed", range(12))
def test_streams_equal_reference_on_seeded_predicated_dags(seed):
    _check_random(_seeded_pred_dfg(seed), seed)


def test_plain_sparse_end_state_counts_the_reference_rounds():
    """The plain sparse loop reads its flag every FLAG_EVERY rounds, yet
    reports the reference's rounds (the non-firing one counted) and the
    numpy backend's streams."""
    g = SPARSE_APPS["mttkrp"].build(1)
    prog = lower_sparse(g)
    ins = _inputs(g, 16)
    feed = np.zeros((len(prog.input_names), 16), dtype=np.int64)
    for i, n in enumerate(prog.input_names):
        feed[i] = ins[n]
    frem = np.full(len(prog.input_names), 16)
    res = K.sim_sparse(prog, torch.from_numpy(feed), torch.from_numpy(frem),
                       4096)
    assert int(res.fired) == 0 and not res.frem.any()
    assert int(res.rounds) % K.ref.FLAG_EVERY != 0
    want = simulate_sparse(g, ins, 4096, backend="numpy")
    assert res.outm[0, :int(res.ocnt[0])].tolist() == \
        want[prog.output_names[0]]
    # capped: the same state after exactly as many rounds, and one fewer
    # leaves the last round's firing visible
    capped = K.sim_sparse(prog, torch.from_numpy(feed),
                          torch.from_numpy(frem), int(res.rounds))
    assert int(capped.rounds) == int(res.rounds)
    short = K.sim_sparse(prog, torch.from_numpy(feed),
                         torch.from_numpy(frem), int(res.rounds) - 1)
    assert int(short.fired) == 1 and int(short.rounds) == int(res.rounds) - 1


# ---------------------------------------------------------------------------
# the sim_dense stage plan and the kernels' host-side layouts
# ---------------------------------------------------------------------------


def _check_plan(prog):
    plan = K.stage_plan(prog)
    assert [a for a, _ in plan] == sorted(a for a, _ in plan)
    assert sum(b - a for a, b in plan) == len(prog.comb_groups)
    for a, b in plan:
        written = set()
        for grp in prog.comb_groups[a:b]:
            written.update(grp.out.tolist())
        for grp in prog.comb_groups[a:b]:
            assert written.isdisjoint(grp.args.ravel().tolist())
    return plan


@pytest.mark.parametrize("app", ALL_DENSE)
def test_stage_plan_reads_no_slot_its_stage_writes(app):
    assert len(_check_plan(lower_dense(_port_app(app)))) == STAGES[app]


@pytest.mark.parametrize("seed", range(4))
def test_stage_plan_on_seeded_predicated_dags(seed):
    _check_plan(lower_dense(_port_graph(_seeded_pred_dfg(seed))))


@pytest.mark.parametrize("app", sorted(SPARSE_APPS))
def test_sparse_apps_buffer_counts(app):
    prog = lower_sparse(_port_app(app))
    assert prog.n_buf == BUFFERS[app] and prog.max_cap <= 2


def _struct_fields(source: str, name: str):
    body = re.search(r"struct " + name + r" \{(.*?)\};", source, re.S)
    body = re.sub(r"//[^\n]*", "", body.group(1))
    return tuple(f.strip() for decl in body.split(";") if decl.strip()
                 for f in decl.replace("int ", "", 1).split(","))


def test_headers_match_the_cuda_structs():
    dense = (CSRC / "sim_dense.cu").read_text()
    sparse = (CSRC / "sim_sparse.cu").read_text()
    assert _struct_fields(dense, "DenseHeader") == DENSE_FIELDS
    assert _struct_fields(sparse, "SparseHeader") == SPARSE_FIELDS


def test_opcodes_match_the_cuda_enum():
    src = (CSRC / "sim_ops.cuh").read_text()
    body = re.search(r"enum SimOp \{(.*?)\};", src, re.S).group(1)
    names = tuple(x.strip()[len("kOp_"):] for x in body.split(",")
                  if x.strip())
    assert names == _OPS


@pytest.mark.parametrize("app", ALL_DENSE)
def test_dense_pack_is_canonical(app):
    prog = lower_dense(_port_app(app))
    h, blob = pack_dense(prog, 100)
    assert blob.dtype == np.int32 and h["blob_words"] == blob.size
    plan = K.stage_plan(prog)
    sizes = np.cumsum([0] + [len(g.out) for g in prog.comb_groups])
    stage = blob[h["o_stage"]:h["o_stage"] + len(plan) + 1]
    assert stage.tolist() == [int(sizes[a]) for a, _ in plan] + [sizes[-1]]
    comb = blob[h["o_comb"]:h["o_comb"] + 4 * h["n_comb"]].reshape(-1, 4)
    ops = np.concatenate([np.full(len(g.out), g.op)
                          for g in prog.comb_groups])
    assert (comb[:, 0] & 0xff).tolist() == ops.tolist()
    assert np.array_equal(comb[:, 1:], np.concatenate(
        [g.args for g in prog.comb_groups]))
    assert h["n_stages"] == STAGES[app]
    assert h["s_words"] * 4 < 64 * 1024 and h["threads"] % 32 == 0


def test_dense_pack_rejects_a_layout_that_is_not_canonical():
    prog = lower_dense(DENSE_APPS["harris"].build(1))
    prog.input_pos = prog.input_pos + 1
    with pytest.raises(ValueError, match="canonical"):
        pack_dense(prog, 8)


@pytest.mark.parametrize("app", sorted(SPARSE_APPS))
def test_sparse_pack_marks_absent_entries(app):
    prog = lower_sparse(_port_app(app))
    h, blob = pack_sparse(prog, (len(prog.input_names), 48), 100)
    ev = blob[h["o_ev"]:h["o_ev"] + 4 * h["n_ev"]].reshape(-1, 4)
    assert np.array_equal(np.where(prog.ev_in_mask, prog.ev_in, -1), ev[:, 1:])
    assert (ev[:, 0] & 0xff).tolist() == prog.ev_op.tolist()
    fan = blob[h["o_ev_out"]:h["o_ev_out"] + h["n_ev"] * h["fan"]]
    assert np.array_equal(fan.reshape(-1, h["fan"]),
                          np.where(prog.ev_out_mask, prog.ev_out, -1))
    assert h["threads"] % 32 == 0 and h["s_words"] * 4 < 64 * 1024


def test_wrappers_on_the_cpu_take_the_plain_version():
    g = DENSE_APPS["harris"].build(1)
    prog = lower_dense(g)
    before = (K.sim_dense.launches, K.sim_sparse.launches)
    ins = _inputs(g, 40)
    in_t = torch.tensor([ins[n] for n in prog.input_names])
    assert torch.equal(K.sim_dense(prog, in_t, 40),
                       K.sim_dense_plain(prog, in_t, 40))
    assert (K.sim_dense.launches, K.sim_sparse.launches) == before
    with pytest.raises(ValueError):
        K.sim_dense(prog, in_t[:, :10], 40)


# ---------------------------------------------------------------------------
# lowering guards, ROM without an address, deadlock diagnostics
# ---------------------------------------------------------------------------


def test_sim_lowering_error_is_value_error():
    assert issubclass(SimLoweringError, ValueError)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_out_of_domain_inputs_raise_lowering_error(backend):
    g = DENSE_APPS["gaussian"].build(1)
    ins = _inputs(g, 8)
    for bad in ([0x10000] * 8, [-1] * 8):
        with pytest.raises(SimLoweringError):
            simulate(g, {**ins, next(iter(ins)): bad}, 8, backend=backend,
                     device="cpu")
    sg = SPARSE_APPS["vecadd"].build(1)
    sins = _inputs(sg, 4)
    with pytest.raises(SimLoweringError):
        simulate_sparse(sg, {**sins, next(iter(sins)): [0x10000]}, 64,
                        backend=backend, device="cpu")


def _rom_no_addr_graph(dfg_cls, table=(42, 7, 9)):
    g = dfg_cls("romfix")
    i = g.add("input", name="i")
    rom = g.add("mem", name="lut", op="rom", latency=1,
                meta={"table": list(table)})
    s = g.add("pe", name="s", op="add")
    g.connect(i, s, port=0)
    g.connect(rom, s, port=1)
    g.connect(s, g.add("output", name="o"))
    return g.validate()


@pytest.mark.parametrize("backend", SIM_BACKENDS)
def test_rom_without_address_reads_entry_zero(backend):
    ins = {"i": list(range(8))}
    want = ref_simulate(_rom_no_addr_graph(RefDFG), ins, 8)
    assert want["o"][1:] == [t + 42 for t in range(1, 8)]
    assert simulate(_rom_no_addr_graph(DFG), ins, 8, backend=backend,
                    device="cpu") == want


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_rom_table_out_of_domain_raises(backend):
    g = _rom_no_addr_graph(DFG, table=(1, 0x10000))
    with pytest.raises(SimLoweringError):
        simulate(g, {"i": [0]}, 2, backend=backend, device="cpu")


def _starved_graph(dfg_cls):
    g = dfg_cls("starve")
    a, b = g.add("input", name="a"), g.add("input", name="b")
    pe = g.add("pe", name="mix", op="add")
    g.connect(a, pe, port=0)
    g.connect(b, pe, port=1)
    g.connect(pe, g.add("output", name="o"))
    return g.validate()


def _deadlock(run) -> str:
    with pytest.raises(RuntimeError) as ei:
        run()
    return str(ei.value)


@pytest.mark.parametrize("backend", SIM_BACKENDS)
def test_deadlock_message_identical_to_reference(backend):
    ins = {"a": [1, 2, 3], "b": [5]}
    ref = {_deadlock(lambda: ref_simulate_sparse(_starved_graph(RefDFG), ins,
                                                 64, backend=b))
           for b in REF_BACKENDS}
    assert len(ref) == 1
    got = _deadlock(lambda: simulate_sparse(_starved_graph(DFG), ins, 64,
                                            backend=backend, device="cpu"))
    assert {got} == ref
    assert "1 input token(s) pending" in got and "p1<-b" in got


def test_unknown_backend_rejected():
    g = DENSE_APPS["gaussian"].build(1)
    for name in ("cuda", "jax"):
        with pytest.raises(ValueError, match="unknown sim backend"):
            simulate(g, _inputs(g, 4), 4, backend=name)
        with pytest.raises(ValueError, match="unknown sim backend"):
            simulate_sparse(g, {}, 4, backend=name)


# ---------------------------------------------------------------------------
# equivalent / sparse_equivalent and the reference-stream memo
# ---------------------------------------------------------------------------


def _pipelined_gaussian():
    ref = DENSE_APPS["gaussian"].build(1)
    xform = ref.copy()
    compute_pipelining(xform, rf_threshold=3)
    return ref, xform


@pytest.mark.parametrize("backend", SIM_BACKENDS)
def test_equivalent_agrees_with_reference(backend):
    ref, xform = _pipelined_gaussian()
    ins = _inputs(ref, 96, seed=3)
    rref = REF_DENSE["gaussian"].build(1)
    want = ref_equivalent(rref, _ref_pipelined(rref), ins, n=32)
    assert want
    assert equivalent(ref, xform, ins, n=32, backend=backend,
                      device="cpu") == want
    # a transform that changes the function is caught on every backend
    assert not equivalent(ref, _broken(xform), ins, n=32, backend=backend,
                          device="cpu")


def _broken(g):
    """``g`` with its first two-input ALU op replaced by another."""
    g = g.copy()
    node = next(nd for nd in g.nodes.values() if nd.kind == PE
                and nd.op in ("add", "sub", "mul", "and", "or", "min", "max"))
    node.op = "xor"
    return g


def _ref_pipelined(rref):
    from repro.core.pipelining import compute_pipelining as ref_pipelining
    x = rref.copy()
    ref_pipelining(x, rf_threshold=3)
    return x


@pytest.mark.parametrize("backend", SIM_BACKENDS)
def test_sparse_equivalent_agrees_across_backends(backend):
    ref = SPARSE_APPS["vecadd"].build(1)
    ins = _inputs(ref, 24)
    assert sparse_equivalent(ref, ref.copy(), ins, backend=backend,
                             device="cpu")
    assert not sparse_equivalent(ref, _broken(ref), ins, backend=backend,
                                 device="cpu")


@pytest.mark.parametrize("backend", SIM_BACKENDS)
def test_equivalent_memoizes_reference_streams(backend):
    clear_ref_memo()
    ref, xform = _pipelined_gaussian()
    ins = _inputs(ref, 96, seed=5)
    kw = dict(backend=backend, device="cpu")
    assert equivalent(ref, xform, ins, n=32, **kw)
    misses0 = ref_memo_stats["misses"]
    assert misses0 >= 1
    assert equivalent(ref, xform, ins, n=32, **kw)
    assert equivalent(ref, xform, ins, n=16, **kw)   # a prefix of the memo
    assert ref_memo_stats["misses"] == misses0
    assert ref_memo_stats["hits"] >= 2
    assert equivalent(ref, xform, _inputs(ref, 96, seed=6), n=32, **kw)
    assert ref_memo_stats["misses"] == misses0 + 1
    clear_ref_memo()
    assert ref_memo_stats == {"hits": 0, "misses": 0}


def test_memo_keys_on_the_backend():
    clear_ref_memo()
    ref, xform = _pipelined_gaussian()
    ins = _inputs(ref, 96, seed=8)
    for backend in SIM_BACKENDS:
        assert equivalent(ref, xform, ins, n=32, backend=backend,
                          device="cpu")
    assert ref_memo_stats == {"hits": 0, "misses": len(SIM_BACKENDS)}
    clear_ref_memo()
