"""The port's vectorized simulator against the JAX package's, on the CPU.

The same graphs, built in both packages, and the same numpy-seeded inputs
go through the reference (interpreter, ``numpy`` and ``jax`` backends) and
the port (``numpy``, and ``torch`` on the CPU, which runs the plain
versions of the ``sim_dense`` / ``sim_sparse`` kernels). The bar is the
reference's own: bit-identical streams, deadlock diagnostics and lowerings.
The kernels run only on the card (``tests/test_torch_card.py``); here their
host side is held: the stage plan, the packed program, the header, opcode,
micro-op and flag layouts the CUDA sources expect, the micro-ops against
the plain formulas, the ROM reciprocal over every 16-bit address, and
pure-Python walkers that execute the packed programs in the kernels' own
order and check them against the plain versions.
"""

import copy
import importlib
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
from repro_torch.core.sim_vec import _feed_matrix, _input_matrix  # noqa: E402
from repro_torch.core.pipelining import compute_pipelining  # noqa: E402
from repro_torch.core.sim import ref_memo_stats  # noqa: E402
from repro_torch.core.sim_vec import _OPS  # noqa: E402
from repro_torch.kernels import sim as K  # noqa: E402
from repro_torch.kernels.sim import ref  # noqa: E402
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


@pytest.mark.parametrize("kernel", ["sim_dense", "sim_sparse"])
def test_launch_bindings_match_the_cuda_signatures(kernel, monkeypatch):
    """The ctypes argument list of each ``*_launch`` has as many entries as
    its ``extern "C"`` definition has parameters (checked on a stand-in
    library: the real one is built only where nvcc is)."""
    class Fn:
        def __init__(self, ret=0):
            self.ret = ret

        def __call__(self):
            return self.ret

    class Lib:
        sim_dense_launch, sim_sparse_launch = Fn(), Fn()
        sim_dense_header_ints = Fn(len(DENSE_FIELDS))
        sim_sparse_header_ints = Fn(len(SPARSE_FIELDS))

    mod = importlib.import_module("repro_torch.kernels.sim.sim")
    monkeypatch.setattr(mod._build, "load", lambda name: Lib())
    lib = mod._kernel_lib.__wrapped__()
    src = (CSRC / f"{kernel}.cu").read_text()
    params = re.search(rf"int {kernel}_launch\((.*?)\)", src, re.S).group(1)
    assert len(getattr(lib, f"{kernel}_launch").argtypes) == len(
        params.split(","))


def test_opcodes_match_the_cuda_enum():
    src = (CSRC / "sim_ops.cuh").read_text()
    body = re.search(r"enum SimOp \{(.*?)\};", src, re.S).group(1)
    names = tuple(x.strip()[len("kOp_"):] for x in body.split(",")
                  if x.strip())
    assert names == _OPS


def _dense_rounds(h, blob):
    """The packed dense rounds: (light [n_light + 1, 32, 8], heavy
    [n_heavy, 32, 8]) descriptors as non-negative ints."""
    split = h["n_light"] + (h["n_light"] > 0)
    n = split + h["n_heavy"]
    desc = blob[h["o_desc"]:h["o_desc"] + 8 * 32 * n].view(np.uint32)
    desc = desc.astype(np.int64).reshape(-1, 32, 8)
    return desc[:split], desc[split:]


@pytest.mark.parametrize("app", ALL_DENSE)
def test_dense_pack_is_canonical(app):
    """The lane-major schedule holds each stage of the plan as its own light
    rounds, every node once with its micro-op and permuted operands; every
    input, output, accumulator and latency node once, in a light round after
    its operands are final or in a heavy round (rings and ROMs always
    there); and the light rounds end with a copy of the first."""
    prog = lower_dense(_port_app(app))
    h, blob = pack_dense(prog, 100)
    assert blob.dtype == np.int32 and h["blob_words"] == blob.size
    light, heavy = _dense_rounds(h, blob)
    assert np.array_equal(light[-1], light[0])
    light = light[:-1]
    fl, shift = K.sim.DENSE_FLAGS, K.sim.D_SHIFT
    pad, one, idle = prog.n_nodes, prog.n_nodes + 1, prog.n_nodes + 2
    seen = {}                 # (flags, dest) -> (round, x, y, z, word 3)
    for r, rnd in enumerate(np.concatenate([light, heavy])):
        for lane, dw in enumerate(rnd):
            key = (dw[3] >> shift & 0x3F, (dw[3] & ((1 << shift) - 1)) // 4)
            if key != (0, idle):
                assert key not in seen
                seen[key] = (r, *[v // 4 for v in dw[:3]], dw[3])
    comb = {}
    for g in prog.comb_groups:
        for i in range(len(g.out)):
            comb[int(g.out[i])] = K.sim.canon_op(g.op, g.args[i].tolist(),
                                                 pad, one)
    plan, r0 = K.stage_plan(prog), 0
    assert len(plan) == STAGES[app]
    final = {}                          # comb slot -> first round it is final
    for a, b in plan:
        outs = [int(o) for g in prog.comb_groups[a:b] for o in g.out]
        n_rounds = -(-len(outs) // 32)
        for o in outs:
            r, x, y, z, w3 = seen.pop((0, o))
            assert r0 <= r < r0 + n_rounds
            assert comb[o] == (w3 >> K.sim.D_UOP_SHIFT, x, y, z)
            final[o] = r0 + n_rounds
        r0 += n_rounds
    assert r0 == h["n_light"]
    n_in = len(prog.input_pos)
    want = ([(fl["XIn"] | fl["DNext"], i) for i in range(n_in)]
            + [(fl["DOut"], o * K.sim.CHUNK)
               for o in range(len(prog.output_pos))])
    for j in range(len(prog.seq_pos)):
        f = fl["DNext"]
        f |= fl["Ring"] if prog.seq_lat[j] > 1 else 0
        f |= fl["Rom"] if any(g.op == _OPS.index("rom") and j in g.out
                              for g in prog.seq_groups) else 0
        want.append((f, n_in + j))
    want += [(fl["DNext"], int(a)) for a in prog.accum_pos]
    for key in want:
        r, x, y, z, _ = seen.pop(key)
        if key[0] & (fl["Ring"] | fl["Rom"]):
            assert r >= h["n_light"]
        reads = [x] if not key[0] & fl["XIn"] else []
        assert r >= max([final.get(v, 0) for v in reads + [y, z]])
    assert not seen
    assert h["s_words"] * 4 < 64 * 1024


def test_dense_pack_rejects_a_layout_that_is_not_canonical():
    prog = lower_dense(DENSE_APPS["harris"].build(1))
    prog.input_pos = prog.input_pos + 1
    with pytest.raises(ValueError, match="canonical"):
        pack_dense(prog, 8)


def _sparse_items(h, blob):
    """The packed sparse items: [n_rounds * 32, desc_words] non-negative
    ints."""
    n = h["n_rounds"] * 32 * h["desc_words"]
    desc = blob[h["o_desc"]:h["o_desc"] + n].view(np.uint32)
    return desc.astype(np.int64).reshape(-1, h["desc_words"])


@pytest.mark.parametrize("app", sorted(SPARSE_APPS))
def test_sparse_pack_marks_absent_entries(app):
    """Every node with inputs, OUTPUT, INPUT and CONST refill is one item
    whose popped and pushed buffers are the lowering's; absent inputs read
    the never-empty dummy, absent outputs the never-full one; idle lanes
    touch only the dummies and never fire."""
    prog = lower_sparse(_port_app(app))
    h, blob = pack_sparse(prog, (len(prog.input_names), 48), 100)
    items = _sparse_items(h, blob)
    n_tot = h["n_buf"] + h["n_in"]
    d_in, d_out, n_out = n_tot, n_tot + 1, h["n_out"]
    got = []
    for it in items:
        ins = [it[1] & 0xFFFF, it[1] >> 16, it[2] & 0xFFFF]
        outs = [(o & 0xFFFF, o >> 16) for o in it[5:5 + K.sim.FAN]]
        more = int(it[5 + K.sim.FAN])
        n, at = more & 0xFFF, h["o_outs"] + (more >> K.sim.MORE_SHIFT)
        outs += [(int(o) & 0xFFFF, int(o) >> 16) for o in blob[at:at + n]]
        if not it[0] >> 4 & K.sim.SPARSE_FLAGS["Valid"]:
            assert ins == [d_in] * 3 and it[2] >> 16 == n_out
            assert all(b == d_out for b, _ in outs) and more == 0
            continue
        got.append((sorted(b for b in ins if b != d_in),
                    sorted((b, c) for b, c in outs if b != d_out),
                    it[2] >> 16))
    n_buf = prog.n_buf
    want = []
    for i in range(len(prog.ev_names)):
        ins = sorted(prog.ev_in[i][prog.ev_in_mask[i]].tolist())
        if ins:
            outs = [(int(b), int(prog.cap[b]))
                    for b in prog.ev_out[i][prog.ev_out_mask[i]]]
            want.append((ins, sorted(outs), n_out))
    want += [([int(b)], [], o) for o, b in
             enumerate(prog.out_buf[:len(prog.output_names)])]
    want += [([n_buf + j], sorted((int(b), int(prog.cap[b])) for b in
                                  prog.in_out[j][prog.in_out_mask[j]]),
              n_out) for j in range(len(prog.input_names))]
    want += [([], [(int(b), 1)], n_out) for b in prog.const_buf]
    assert got == want
    assert h["n_rounds"] == -(-len(want) // 32)
    assert h["window"] == 48 and h["refill"] == 0        # staged whole
    assert h["s_words"] * 4 < 64 * 1024


def _counts():
    return [getattr(fn, c) for fn in (K.sim_dense, K.sim_sparse)
            for c in ("launches", "shared_launches", "global_launches")]


def test_wrappers_on_the_cpu_take_the_plain_version():
    g = DENSE_APPS["harris"].build(1)
    prog = lower_dense(g)
    before = _counts()
    ins = _inputs(g, 40)
    in_t = torch.tensor([ins[n] for n in prog.input_names])
    assert torch.equal(K.sim_dense(prog, in_t, 40),
                       K.sim_dense_plain(prog, in_t, 40))
    assert _counts() == before
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


# ---------------------------------------------------------------------------
# pure-Python walkers of the packed programs, in the kernels' own order
# ---------------------------------------------------------------------------
#
# Each walker executes a blob as its kernel does: one warp, round by round,
# each lane's descriptor loaded one round ahead, banks switched as the
# kernel switches them, inputs and feed tokens landing only at the kernel's
# cp.async waits. Between two __syncwarp() calls the lanes run in no
# order, so a walker records every shared word each lane reads and writes
# in that interval and fails on a word that one lane writes and another
# reads or writes (a race), or that is read while a copy into it is in
# flight. The only races a design allows are named where they are allowed.
# ``layout`` picks the blob's layout (``K.sim.LAYOUTS``). On "global" a
# walker runs the same rounds over the wide descriptors, its workspace
# words checked as the shared words are, and the staging copies made by the
# lanes as plain stores. On "stream" shared memory holds the copied tables
# and the state, the descriptors are read from the blob in device memory
# in the order of each lane's stream (``_Stream``).

M32 = 0xFFFFFFFF
UOP_NAMES = ("add", "sub", "mul", "and", "or", "xor", "shr", "shl",
             "minmax", "abs", "gtz", "nez", "sel", "accp")


def _alu16(u, x, y, z):
    s, zm = y & 0xF, -(z & 1) & M32
    return (x + y, x - y, x * y, x & y, x | y, x ^ y, x >> s, x << s,
            max(x, y) if z & 1 else min(x, y), x if x < 0x8000 else -x,
            int(x + (z & 1) > y), int(x != y) ^ (z & 1),
            (x & zm) | (y & ~zm), x + (y & zm))[u] & 0xFFFF


def _byte_perm(a, b, sel):
    src = (a & M32) | (b & M32) << 32
    return sum(((src >> 8 * ((sel >> 4 * i) & 7)) & 0xFF) << 8 * i
               for i in range(4))


class _Warp:
    """Shared memory of one warp, with per-interval race checks."""

    def __init__(self, blob, words, allowed=()):
        self.sm = [int(w) & M32 for w in blob] + [0] * (words - blob.size)
        self.pending = {}               # word -> value of a copy in flight
        self.allowed = set(allowed)     # words whose races are benign
        self.reads = [set() for _ in range(32)]
        self.writes = [set() for _ in range(32)]
        self.syncs = 0

    def ld(self, lane, addr):
        assert addr not in self.pending, f"read of word {addr} in flight"
        self.reads[lane].add(addr)
        return self.sm[addr]

    def st(self, lane, addr, v):
        assert addr not in self.pending, f"write of word {addr} in flight"
        self.writes[lane].add(addr)
        self.sm[addr] = v & M32

    def copy(self, addr, v):
        self.pending[addr] = v & M32

    def wait(self):
        for addr, v in self.pending.items():
            self.sm[addr] = v
        self.pending = {}

    def sync(self):
        self.syncs += 1
        touched = {}
        for lane in range(32):
            for addr in self.writes[lane] - self.allowed:
                touched.setdefault(addr, set()).add(lane)
        for lane in range(32):
            for addr in (self.reads[lane] | self.writes[lane]) & touched.keys():
                others = touched[addr] - {lane}
                assert not others, (f"word {addr}: lane {lane} and lanes "
                                    f"{sorted(others)} race")
        for s in self.reads + self.writes:
            s.clear()


class _Stream:
    """One lane's descriptors streamed from device memory, in the kernels'
    order (``sim_ops.cuh`` ``DescStream``): position q (round q % n of the
    cycle's list) sits in chunk q // C, and chunks are copied, one copy
    group each, into two buffers by turns: chunks 0 and 1 at the start,
    chunk j + 1 when position j * C is taken, after a wait for all copies.
    Checks that every read finds its chunk landed in its buffer, and that
    no chunk overwrites a buffer before every position of the chunk there
    was read."""

    def __init__(self, n, chunk):
        self.n, self.C = n, chunk
        self.buf, self.pending, self.fetched, self.q = {}, [], 0, 0
        self._fetch()
        self._fetch()
        self._wait(1)
        self.held = self._read(0)

    def _fetch(self):
        j = self.fetched
        old = self.buf.get(j % 2)
        assert old is None or (old[0] + 1) * self.C <= self.q, (old, j)
        self.buf[j % 2] = (j, False)
        self.pending.append(j)
        self.fetched += 1

    def _wait(self, n):
        landed = self.pending[:len(self.pending) - n]
        for j in landed:
            self.buf[j % 2] = (j, True)
        self.pending = self.pending[len(landed):]

    def _read(self, q):
        assert self.buf.get(q // self.C % 2) == (q // self.C, True), \
            (q, self.buf)
        return q % self.n

    def advance(self):
        """The held position's round; the next position is held, and at a
        chunk's first position the chunk after it sent for."""
        got = self.held
        self.q += 1
        if self.q % self.C == 0:
            self._wait(0)
            assert self.fetched == self.q // self.C + 1
            self._fetch()
        self.held = self._read(self.q)
        return got


def _warp_of(h, blob):
    """The warp's shared memory: the blob (shared layout), its copied
    sections (stream), or the workspace (global), then the state."""
    lo = h["o_copy"] if h["layout"] == 1 else 0
    n = h["copy_words"] if h["layout"] == 1 else blob.size
    return blob[lo:lo + n]


def walk_dense(prog, in_mat, cycles, layout="shared", out_chunk=None):
    """``sim_dense`` over ``pack_dense``'s blob, lane by lane: the outputs
    [n_out][cycles], as the kernel flushes them from its output staging
    (``out_chunk`` cycles a bank). Idle lanes all write the idle slot,
    which nothing reads: the one race the design allows."""
    h, blob = pack_dense(prog, cycles, layout, out_chunk or K.sim.CHUNK)
    assert h["layout"] == K.sim.LAYOUTS.index(layout)
    assert h["global_route"] == int(layout != "shared")
    wide, stream = layout == "global", layout == "stream"
    stride, ch, n_in, n_out = h["stride"], K.sim.CHUNK, h["n_in"], h["n_out"]
    idle = [h["s_val"] + b * stride + h["n_nodes"] + 2 for b in (0, 1)]
    w = _Warp(_warp_of(h, blob), h["s_words"], allowed=idle)
    sm = w.sm
    gm = [int(v) & M32 for v in blob]       # device memory's program
    val, ring, ptr = h["s_val"], h["s_ring"], h["s_ptr"]
    inbuf, outbuf = h["s_in"], h["s_out"]
    fl = K.sim.DENSE_FLAGS
    for i in range(h["n_const"]):
        slot, v = sm[h["o_const"] + 2 * i], sm[h["o_const"] + 2 * i + 1]
        w.st(i % 32, val + slot, v)
        w.st(i % 32, val + stride + slot, v)
    w.st(0, val + h["n_nodes"] + 1, 1)
    w.st(0, val + stride + h["n_nodes"] + 1, 1)
    out = [[None] * cycles for _ in range(n_out)]

    def stage(c):
        t0 = c * ch
        width = min(ch, cycles - t0)
        for i in range(n_in * max(0, width)):
            r, k = divmod(i, width)
            addr = inbuf + (c & 1) * n_in * ch + r * ch + k
            if wide:
                w.st(i % 32, addr, int(in_mat[r][t0 + k]))
            else:
                w.copy(addr, int(in_mat[r][t0 + k]))

    oc = h["out_chunk"]

    def flush(c):
        t0 = c * oc
        width = min(oc, cycles - t0)
        for i in range(n_out * width):
            o, k = divmod(i, width)
            assert out[o][t0 + k] is None
            out[o][t0 + k] = w.ld(i % 32, outbuf + (c & 1) * n_out * oc
                                  + o * oc + k)

    stage(0)
    w.wait()
    stage(1)
    w.sync()
    for i in range(n_in):
        w.st(i % 32, val + i, w.ld(i % 32, inbuf + i * ch))
    w.sync()
    od, n_light, n_heavy = h["o_desc"], h["n_light"], h["n_heavy"]
    heavy0 = od + 8 * 32 * (n_light + (n_light > 0))
    src = gm if stream else sm
    desc = lambda base, k, lane: src[base + 8 * (k * 32 + lane):][:8]  # noqa
    # flags and micro-op: word 3's high bits, or word 7 on the global
    # layout; the destination's byte offset: word 3's low bits, or all of it
    ctl = (lambda dw: dw[7]) if wide else (lambda dw: dw[3])  # noqa: E731
    dest = ((lambda dw: dw[3]) if wide  # noqa: E731
            else (lambda dw: dw[3] & ((1 << K.sim.D_SHIFT) - 1)))
    d = [desc(od, 0, lane) if n_light else [0] * 8 for lane in range(32)]
    hd = [desc(heavy0, 0, lane) if n_heavy else [0] * 8 for lane in range(32)]
    per_cycle = n_light + n_heavy
    feed = (_Stream(per_cycle, K.sim.STREAM_CHUNKS["dense"])
            if stream and per_cycle else None)

    def streamed(k, heavy):
        """The stream's next position: round k of the light or heavy list
        (the light list's closing copy is never streamed)."""
        r = feed.advance()
        assert r == (n_light + k if heavy else k)
        return [desc(heavy0 if heavy else od, k, lane) for lane in range(32)]

    for t in range(cycles):
        if t % ch == ch - 1 and t + 1 < cycles:
            w.wait()
            w.sync()
            stage(t // ch + 2)
        if t % oc == oc - 1 and t >= oc:
            flush(t // oc - 1)
        V, Vn = val + (t & 1) * stride, val + ((t + 1) & 1) * stride
        u = t + 1
        inb = inbuf + ((u // ch) & 1) * n_in * ch + u % ch
        outb = outbuf + ((t // oc) & 1) * n_out * oc + t % oc

        def store(lane, dw, value):
            f = ctl(dw) >> K.sim.D_SHIFT & 0x3F
            base = Vn if f & fl["DNext"] else outb if f & fl["DOut"] else V
            w.st(lane, base + dest(dw) // 4, value)

        def xbase(dw):
            return inb if ctl(dw) >> K.sim.D_SHIFT & fl["XIn"] else V

        for k in range(n_light):
            if stream:
                d = streamed(k, False)
            else:
                dn = [desc(od, k + 1, lane) for lane in range(32)]
            for lane in range(32):
                dw = d[lane]
                x = w.ld(lane, xbase(dw) + dw[0] // 4)
                y, z = w.ld(lane, V + dw[1] // 4), w.ld(lane, V + dw[2] // 4)
                store(lane, dw, _alu16(ctl(dw) >> K.sim.D_UOP_SHIFT, x, y, z))
            w.sync()
            if not stream:
                d = dn
        for k in range(n_heavy):
            rnd = streamed(k, True) if stream else None
            for lane in range(32):
                dw = (rnd[lane] if stream else hd[lane] if k == 0
                      else desc(heavy0, k, lane))
                f = ctl(dw) >> K.sim.D_SHIFT & 0x3F
                x = w.ld(lane, xbase(dw) + dw[0] // 4)
                y, z = w.ld(lane, V + dw[1] // 4), w.ld(lane, V + dw[2] // 4)
                r = 0
                if h["n_rom"]:
                    ro = h["o_rom"] + 4 * dw[4]
                    idx = ((sm[ro + 2] * x) & M32) * sm[ro + 1] >> 32
                    r = w.ld(lane, h["o_table"] + sm[ro] + idx)
                slot = ptr + k * 32 + lane
                p = w.ld(lane, slot)
                pn = 0 if p + 1 == dw[6] else p + 1
                head = w.ld(lane, ring + dw[5] + pn)
                v = r if f & fl["Rom"] else _alu16(
                    ctl(dw) >> K.sim.D_UOP_SHIFT, x, y, z)
                w.st(lane, ring + dw[5] + p, v)
                w.st(lane, slot, pn)
                store(lane, dw, head if f & fl["Ring"] else v)
        w.sync()
    last = (cycles - 1) // oc
    if cycles % oc and last > 0:
        flush(last - 1)
    if cycles:
        flush(last)
    w.wait()
    return out


def walk_sparse(prog, feed, frem, max_cycles, layout="shared"):
    """``sim_sparse`` over ``pack_sparse``'s blob, lane by lane: (blen,
    frem, streams, ocnt, fired, rounds). A consumer reads its buffer's head
    even when the buffer is empty, and discards it (it does not fire); a
    producer may push into that word in the same round: the one race the
    design allows, so such a read is not recorded. An item's outputs past
    the descriptor's four are the warp's: every lane tests and pushes a
    stride of them, item after item of the round."""
    feed = np.asarray(feed)
    h, blob = pack_sparse(prog, feed.shape, max_cycles, layout)
    assert h["layout"] == K.sim.LAYOUTS.index(layout)
    assert h["global_route"] == int(layout != "shared")
    wide, stream = layout == "global", layout == "stream"
    w = _Warp(_warp_of(h, blob), h["s_words"])
    sm = w.sm
    gm = [int(v) & M32 for v in blob]       # device memory's program
    n_buf, n_in, n_out = h["n_buf"], h["n_in"], h["n_out"]
    nt = n_buf + n_in
    nb = nt + 2
    P, Q, rpa, wpa = h["s_p"], h["s_q"], h["s_rpa"], h["s_wpa"]
    data, accv, ocnt = h["s_data"], h["s_accv"], h["s_ocnt"]
    trash = h["s_trash"]
    fl = K.sim.SPARSE_FLAGS
    fan, shift = K.sim.FAN, K.sim.MORE_SHIFT
    binfo = lambda b: (sm[h["o_binfo"] + 2 * b],  # noqa: E731
                       sm[h["o_binfo"] + 2 * b + 1])
    frem0 = [int(v) for v in frem]
    for b in range(nb):
        w.st(b % 32, rpa + b, binfo(b)[0])
        w.st(b % 32, wpa + b, binfo(b)[0])
        n = 0 if b < n_buf else frem0[b - n_buf] if b < nt else int(b == nt)
        w.st(b % 32, P + b, n)
        w.st(b % 32, P + nb + b, n)

    def stage(lo, span):
        for j in range(n_in):
            for k in range(lo[j], lo[j] + span):
                if k < frem0[j] and k < h["max_feed"]:
                    addr = data + binfo(n_buf + j)[0] + k % h["window"]
                    if wide:         # lane i % 32 of the kernel's loop
                        w.st((j * span + k - lo[j]) % 32, addr,
                             int(feed[j, k]))
                    else:
                        w.copy(addr, int(feed[j, k]))

    R = h["refill"]
    stage([0] * n_in, 2 * R if R else h["max_feed"])
    w.wait()
    w.sync()
    D = h["desc_words"]
    outm = [[0] * max_cycles for _ in range(max(1, n_out))]

    def decode(dw):
        """(flags word, ins, sink, selxy, selzk, the first outputs,
        (count, first entry) of the rest)."""
        if wide:
            outs = list(zip(dw[8:8 + fan], dw[8 + fan:8 + 2 * fan]))
            return dw[0], dw[1:4], dw[4], dw[5], dw[6], outs, dw[7]
        outs = [(o & 0xFFFF, o >> 16) for o in dw[5:5 + fan]]
        return (dw[0], [dw[1] & 0xFFFF, dw[1] >> 16, dw[2] & 0xFFFF],
                dw[2] >> 16, dw[3], dw[4], outs, dw[5 + fan])

    def entry(more, f):
        """Entry f of an item's out-list: (buffer, limit)."""
        at = (more >> shift) + f
        if wide:
            return sm[h["o_outs"] + 2 * at], sm[h["o_outs"] + 2 * at + 1]
        o = sm[h["o_outs"] + at]
        return o & 0xFFFF, o >> 16

    def wrap(a, b):
        base, cap = binfo(b)
        return base if a == base + cap else a

    def step(lane, item, dw, cur, ok_more):
        Pc, Qc = P + cur * nb, Q + cur * nb
        Pn, Qn = P + (cur ^ 1) * nb, Q + (cur ^ 1) * nb
        w0, ins, sink, selxy, selzk, outs, _ = decode(dw)
        flags = w0 >> 4 & 0xFF
        ok = bool(flags & fl["Valid"]) and ok_more
        head, q, ra = [0] * 3, [0] * 3, [0] * 3
        for k, b in enumerate(ins):
            q[k] = w.ld(lane, Qc + b)
            p = w.ld(lane, Pc + b)
            ok = ok and p != q[k]
            ra[k] = w.ld(lane, rpa + b)
            # an empty buffer's head is read and discarded: not recorded
            head[k] = (w.sm[data + ra[k]] if p == q[k]
                       else w.ld(lane, data + ra[k]))
        po = []
        for b, lim in outs:
            po.append(w.ld(lane, Pc + b))
            ok = ok and po[-1] - w.ld(lane, Qc + b) < lim
        oc = w.ld(lane, ocnt + sink)
        kval = (w.ld(lane, accv + item) if flags & fl["Acc"]
                else selzk >> 16)
        h01, h2k = head[0] | head[1] << 16, head[2] | kval << 16
        x = _byte_perm(h01, h2k, selxy & 0xFFFF) & 0xFFFF
        y = _byte_perm(h01, h2k, selxy >> 16) & 0xFFFF
        z = _byte_perm(h01, h2k, selzk & 0xFFFF) & 0xFFFF
        ro = h["o_rom"] + 4 * (w0 >> K.sim.ROM_SHIFT)
        idx = ((sm[ro + 2] * x) & M32) * sm[ro + 1] >> 32
        r = w.ld(lane, h["o_table"] + sm[ro] + idx)
        v = r if flags & fl["Rom"] else _alu16(w0 & 0xF, x, y, z)
        fire = int(ok)
        mine = trash + lane            # the lane's word for stores not made
        for k, b in enumerate(ins):
            real = b < nt
            w.st(lane, Qn + b if real else mine, q[k] + fire)
            w.st(lane, rpa + b if real else mine,
                 wrap(ra[k] + 1, b) if fire else ra[k])
        for (b, _), p in zip(outs, po):
            real = b < nt
            a = w.ld(lane, wpa + b)
            w.st(lane, Pn + b if real else mine, p + fire)
            w.st(lane, data + a if real and fire else mine, v)
            w.st(lane, wpa + b if real else mine,
                 wrap(a + 1, b) if fire else a)
        if fire and sink < n_out:
            outm[sink][oc] = v
        w.st(lane, ocnt + sink if fire and sink < n_out else mine, oc + 1)
        w.st(lane, accv + item if fire and flags & fl["Acc"] else mine, v)
        return fire, v

    def item_round(k, descs, cur):
        """Item round k of a round: the wide items' further outputs tested
        by the warp, every lane's item, then those outputs pushed by the
        warp. Returns the lanes that fired."""
        Pc, Qc = P + cur * nb, Q + cur * nb
        Pn = P + (cur ^ 1) * nb
        more = [decode(dw)[6] for dw in descs]
        wide_lanes = [lane for lane in range(32) if more[lane] & 0xFFF]
        ok_more = [True] * 32
        for src in wide_lanes:
            n = more[src] & ((1 << shift) - 1)
            part = [all(w.ld(lane, Pc + b) - w.ld(lane, Qc + b) < lim
                        for b, lim in (entry(more[src], f)
                                       for f in range(lane, n, 32)))
                    for lane in range(32)]
            ok_more[src] = all(part)
        res = [step(lane, k * 32 + lane, descs[lane], cur, ok_more[lane])
               for lane in range(32)]
        for src in wide_lanes:
            n = more[src] & ((1 << shift) - 1)
            fire, v = res[src]
            for lane in range(32):
                for f in range(lane, n, 32):
                    b, _ = entry(more[src], f)
                    w.st(lane, Pn + b, w.ld(lane, Pc + b) + fire)
                    if fire:
                        a = w.ld(lane, wpa + b)
                        w.st(lane, data + a, v)
                        w.st(lane, wpa + b, wrap(a + 1, b))
        return [f for f, _ in res]

    src = gm if stream else sm
    desc = lambda k, lane: src[h["o_desc"] + (k * 32 + lane) * D:][:D]  # noqa
    ring = (_Stream(h["n_rounds"], K.sim.STREAM_CHUNKS["sparse"])
            if stream and h["n_rounds"] else None)
    fired, rounds, cur = 1, 0, 0
    while rounds < max_cycles:
        if R and rounds > 0 and rounds % R == 0:
            w.wait()
            w.sync()
            stage([sm[Q + cur * nb + n_buf + j] + R for j in range(n_in)], R)
        rounds += 1
        any_ = False
        for k in range(h["n_rounds"]):
            if ring is not None:
                assert ring.advance() == k
            any_ |= any(item_round(k, [desc(k, lane) for lane in range(32)],
                                   cur))
        fired = int(any_)
        w.sync()
        cur ^= 1
        if not fired:
            break
    w.wait()
    Pf, Qf = P + cur * nb, Q + cur * nb
    blen = [sm[Pf + b] - sm[Qf + b] for b in range(n_buf)]
    frem_out = [sm[Pf + n_buf + j] - sm[Qf + n_buf + j] if j < n_in
                else frem0[j] for j in range(len(frem0))]
    counts = [sm[ocnt + o] if o < n_out else 0
              for o in range(max(1, n_out))]
    return blen, frem_out, outm, counts, fired, rounds


def _check_dense_walk(prog, ins, cycles, layout="shared", out_chunk=None):
    x = _input_matrix(prog, ins, cycles)
    want = K.sim_dense_plain(prog, torch.from_numpy(x), cycles)
    assert walk_dense(prog, x, cycles, layout, out_chunk) == want.tolist()


def _check_sparse_walk(prog, ins, max_cycles, layout="shared"):
    feed, frem = _feed_matrix(prog, ins)
    want = K.sim_sparse_plain(prog, torch.from_numpy(feed),
                              torch.from_numpy(frem), max_cycles)
    blen, frem_out, outm, ocnt, fired, rounds = walk_sparse(
        prog, feed, frem, max_cycles, layout)
    assert (blen, frem_out, ocnt, fired, rounds) == (
        want.blen.tolist(), want.frem.tolist(), want.ocnt.tolist(),
        int(want.fired), int(want.rounds))
    for o in range(len(prog.output_names)):
        assert outm[o][:ocnt[o]] == want.outm[o, :ocnt[o]].tolist()
    return rounds


# 70 cycles cross two input chunks, so both staging banks are refilled
WALK_CYCLES = 70


@pytest.mark.parametrize("app", ALL_DENSE)
def test_dense_walker_equals_plain_version(app):
    g = _port_app(app)
    _check_dense_walk(lower_dense(g), _inputs(g, WALK_CYCLES), WALK_CYCLES)


@pytest.mark.parametrize("app", sorted(SPARSE_APPS))
def test_sparse_walker_equals_plain_version(app):
    g = _port_app(app)
    _check_sparse_walk(lower_sparse(g), _inputs(g, SPARSE_TOKENS),
                       SPARSE_MAX)


@pytest.mark.parametrize("app", ["mttkrp", "vecadd"])
def test_sparse_walker_through_the_feed_window(app, monkeypatch):
    """A feed past FEED_WHOLE_WORDS goes through rings refilled ahead of
    the feed pointer; the end state and the rounds stay the plain
    version's."""
    monkeypatch.setattr(K.sim, "FEED_WHOLE_WORDS", 0)
    g = _port_app(app)
    prog = lower_sparse(g)
    h, _ = pack_sparse(prog, (len(prog.input_names), 300), 300 * 40)
    assert h["refill"] == K.sim.FEED_REFILL and h["window"] < 300
    rounds = _check_sparse_walk(prog, _inputs(g, 300), 300 * 40)
    assert rounds > 2 * K.sim.FEED_REFILL


@pytest.mark.parametrize("max_cycles", [0, 1, 5, 60])
def test_sparse_walker_capped_and_deadlocked(max_cycles):
    _check_sparse_walk(lower_sparse(_port_app("mttkrp")),
                       _inputs(_port_app("mttkrp"), 16), max_cycles)
    _check_sparse_walk(lower_sparse(_starved_graph(DFG)),
                       {"a": [1, 2, 3], "b": [5]}, max_cycles)


@pytest.mark.parametrize("seed", range(6))
def test_dense_walker_on_seeded_dags(seed):
    for make in (_seeded_dfg, _seeded_pred_dfg):
        pg = _port_graph(make(seed))
        _check_dense_walk(lower_dense(pg), _inputs(pg, 40, seed), 40)


@settings(max_examples=8, deadline=None)
@given(random_pred_dfg(), st.integers(0, 3))
def test_dense_walker_on_random_dags(g, seed):
    pg = _port_graph(g)
    _check_dense_walk(lower_dense(pg), _inputs(pg, 40, seed), 40)


def _wide_dfg(seed, width=80):
    """Three inputs, ``width`` two-input PEs over them, then half as many
    over those: stages wider than two rounds of lanes."""
    rng = np.random.default_rng(seed)
    g = DFG("wide")
    ins = [g.add(INPUT, name=f"in{i}") for i in range(3)]
    layers = [ins]
    for n in (width, width // 2):
        layer = []
        for _ in range(n):
            pe = g.add(PE, op=BINOPS[int(rng.integers(len(BINOPS)))])
            for port in (0, 1):
                g.connect(layers[-1][int(rng.integers(len(layers[-1])))], pe,
                          port=port)
            layer.append(pe)
        layers.append(layer)
    for i, n in enumerate(list(g.nodes)):
        if g.nodes[n].kind == PE and not g.succs(n):
            g.connect(n, g.add("output", name=f"out{i}"))
    return g.validate()


def test_dense_walker_on_a_wide_dag():
    g = _wide_dfg(0)
    prog = lower_dense(g)
    assert max(sum(len(grp.out) for grp in prog.comb_groups[a:b])
               for a, b in K.stage_plan(prog)) > 64           # lanes loop
    _check_dense_walk(prog, _inputs(g, 40), 40)


# H100's opt-in shared memory a block, in bytes: what the plans are held to
SMEM_LIMIT = 232_448


@pytest.mark.parametrize("app", ALL_DENSE)
def test_dense_walker_on_the_global_route(app):
    """The global route's blob (wide descriptors, staging by plain stores)
    walked lane by lane equals the plain version, race-free."""
    g = _port_app(app)
    _check_dense_walk(lower_dense(g), _inputs(g, WALK_CYCLES), WALK_CYCLES,
                      "global")


@pytest.mark.parametrize("app", sorted(SPARSE_APPS))
def test_sparse_walker_on_the_global_route(app):
    g = _port_app(app)
    _check_sparse_walk(lower_sparse(g), _inputs(g, SPARSE_TOKENS),
                       SPARSE_MAX, "global")


def test_sparse_walker_on_the_global_route_through_the_feed_window(
        monkeypatch):
    monkeypatch.setattr(K.sim, "FEED_WHOLE_WORDS", 0)
    g = _port_app("mttkrp")
    rounds = _check_sparse_walk(lower_sparse(g), _inputs(g, 300), 300 * 40,
                                "global")
    assert rounds > 2 * K.sim.FEED_REFILL


@pytest.mark.parametrize("seed", range(3))
def test_global_route_walkers_on_seeded_dags(seed):
    """Seeded DAGs (predicated ones too, a wide one whose stages loop over
    lanes, and the wide one with a fan-out past the descriptor's four
    register-held outputs as a sparse program) on the global route."""
    for make in (_seeded_dfg, _seeded_pred_dfg):
        pg = _port_graph(make(seed))
        _check_dense_walk(lower_dense(pg), _inputs(pg, 40, seed), 40,
                          "global")
    g = _wide_dfg(seed)
    _check_dense_walk(lower_dense(g), _inputs(g, 40, seed), 40, "global")
    g = _wide_dfg(seed, width=12)
    g.sparse = True
    prog = lower_sparse(g)
    assert pack_sparse(prog, (3, 16), 640)[0]["fan"] > 4
    _check_sparse_walk(prog, _inputs(g, 16, seed), 640, "global")


@pytest.mark.parametrize("app", ALL_DENSE)
def test_dense_walker_on_the_stream_layout(app):
    """The global route's stream layout (state in shared memory, the
    descriptors streamed from device memory) walked lane by lane equals the
    plain version, race-free."""
    g = _port_app(app)
    _check_dense_walk(lower_dense(g), _inputs(g, WALK_CYCLES), WALK_CYCLES,
                      "stream")


@pytest.mark.parametrize("app", sorted(SPARSE_APPS))
def test_sparse_walker_on_the_stream_layout(app):
    g = _port_app(app)
    _check_sparse_walk(lower_sparse(g), _inputs(g, SPARSE_TOKENS),
                       SPARSE_MAX, "stream")


@pytest.mark.parametrize("out_chunk", [1, 4, 16])
def test_dense_walker_with_a_short_output_staging(out_chunk):
    """Outputs staged fewer cycles a bank (the stream layout's choice where
    32 cycles of them do not fit): flushed every ``out_chunk`` cycles, the
    last bank partly filled at 70 cycles, equal to the plain version."""
    g = _wide_dfg(2, 40)
    for layout in ("stream", "shared"):
        _check_dense_walk(lower_dense(g), _inputs(g, WALK_CYCLES, 2),
                          WALK_CYCLES, layout, out_chunk)


def test_dense_plan_shrinks_the_output_staging_to_fit():
    """Between the stream layout's words at two output stagings, the plan
    takes the smaller staging; its descriptors address output rows of that
    many words."""
    prog = lower_dense(_wide_dfg(0, 300))
    words = {oc: pack_dense(prog, 64, "stream", oc)[0]["s_words"]
             for oc in K.sim.OUT_CHUNKS}
    assert all(words[a] > words[b] for a, b in zip(K.sim.OUT_CHUNKS,
                                                   K.sim.OUT_CHUNKS[1:]))
    h, blob = K.dense_plan(prog, 64, 4 * words[4])
    assert (h["layout"], h["out_chunk"]) == (1, 4)
    light, heavy = _dense_rounds(h, blob)
    desc = np.concatenate([light[:-1], heavy]).reshape(-1, 8)
    outs = desc[(desc[:, 3] >> K.sim.D_SHIFT) & K.sim.DENSE_FLAGS["DOut"]
                > 0, 3] & ((1 << K.sim.D_SHIFT) - 1)
    assert sorted(outs.tolist()) == [16 * o for o in range(h["n_out"])]


def test_sparse_walker_on_the_stream_layout_through_the_feed_window(
        monkeypatch):
    monkeypatch.setattr(K.sim, "FEED_WHOLE_WORDS", 0)
    g = _port_app("mttkrp")
    rounds = _check_sparse_walk(lower_sparse(g), _inputs(g, 300), 300 * 40,
                                "stream")
    assert rounds > 2 * K.sim.FEED_REFILL


def _one_wide_item(fan):
    """An input feeding ``fan`` adders (one wide item), each adding a
    second, narrow input, the sums chained pairwise into outputs."""
    g = DFG("fan")
    a, b = g.add(INPUT, name="a"), g.add(INPUT, name="b")
    pes = []
    for i in range(fan):
        pe = g.add(PE, op=BINOPS[i % len(BINOPS)])
        g.connect(a, pe, port=0)
        g.connect(b if i == 0 else pes[-1], pe, port=1)
        pes.append(pe)
    for i, pe in enumerate(pes):
        g.connect(pe, g.add("output", name=f"o{i}"))
    g.sparse = True
    return g.validate()


@pytest.mark.parametrize("layout", ["shared", "stream", "global"])
@pytest.mark.parametrize("fan", [5, 36, 70])
def test_sparse_walker_on_one_wide_item_among_narrow_ones(fan, layout):
    """One item with a fan-out past the descriptor's four (past one and
    two strides of the warp) among items of one or two outputs: its
    further outputs tested and pushed by the whole warp."""
    g = _one_wide_item(fan)
    prog = lower_sparse(g)
    h, blob = pack_sparse(prog, (2, 16), 640, layout)
    assert h["fan"] == fan
    desc = blob[h["o_desc"]:h["o_desc"] + h["n_rounds"] * 32 *
                h["desc_words"]].view(np.uint32).reshape(-1, h["desc_words"])
    more = desc[:, 7 if layout == "global" else 5 + K.sim.FAN] & 0xFFF
    assert sorted(int(m) for m in more if m) == [fan - K.sim.FAN]
    _check_sparse_walk(prog, _inputs(g, 16), 640, layout)


@pytest.mark.parametrize("seed", range(3))
def test_walkers_on_seeded_wide_dags_in_every_layout(seed):
    """The seeded wide DAGs, dense and sparse, in each layout: the shared
    route, the stream layout (state in shared memory, program streamed)
    and the global layout, each equal to the plain version."""
    g = _wide_dfg(seed)
    prog = lower_dense(g)
    for layout in K.sim.LAYOUTS:
        _check_dense_walk(prog, _inputs(g, 40, seed), 40, layout)
    g = _wide_dfg(seed, width=12)
    g.sparse = True
    prog = lower_sparse(g)
    for layout in K.sim.LAYOUTS:
        _check_sparse_walk(prog, _inputs(g, 16, seed), 640, layout)


def test_walkers_on_programs_whose_state_fits_but_not_the_program():
    """At a block of less shared memory than the shared route needs but
    more than the state does, the plans take the stream layout; its blobs
    walk equal to the plain version."""
    g = _wide_dfg(1, 160)
    prog = lower_dense(g)
    shared, _ = pack_dense(prog, WALK_CYCLES)
    stream, _ = pack_dense(prog, WALK_CYCLES, "stream", 4)
    limit = 4 * stream["s_words"]
    assert 4 * shared["s_words"] > limit
    h, _ = K.dense_plan(prog, WALK_CYCLES, limit)
    assert (h["layout"], h["out_chunk"]) == (1, 4)
    _check_dense_walk(prog, _inputs(g, WALK_CYCLES, 1), WALK_CYCLES,
                      "stream", 4)
    g = _wide_dfg(1, 320)
    g.sparse = True
    prog = lower_sparse(g)
    shared, _ = pack_sparse(prog, (3, 24), 960)
    stream, _ = pack_sparse(prog, (3, 24), 960, "stream")
    limit = 4 * stream["s_words"]
    assert 4 * shared["s_words"] > limit
    assert K.sparse_plan(prog, (3, 24), 960, limit)[0]["layout"] == 1
    _check_sparse_walk(prog, _inputs(g, 24, 1), 960, "stream")


def test_plans_take_the_global_route_past_shared_memory():
    """The plan packs on the shared route while the blob and state fit a
    block's shared memory; else in the stream layout while the state (and
    the tables) fit; else in the global layout; from the packed sizes
    alone. The apps stay on the shared route."""
    for app in ALL_DENSE:
        prog = lower_dense(_port_app(app))
        assert K.dense_plan(prog, 256, SMEM_LIMIT)[0]["global_route"] == 0
    for app in sorted(SPARSE_APPS):
        prog = lower_sparse(_port_app(app))
        h, _ = K.sparse_plan(prog, (len(prog.input_names), 64), 2560,
                             SMEM_LIMIT)
        assert h["global_route"] == 0
    routes = []
    for width in (80, 1024):
        prog = lower_dense(_wide_dfg(0, width))
        shared, _ = pack_dense(prog, 256)
        h, blob = K.dense_plan(prog, 256, SMEM_LIMIT)
        stream, _ = pack_dense(prog, 256, "stream", h["out_chunk"])
        assert h["global_route"] == int(4 * shared["s_words"] > SMEM_LIMIT)
        assert 4 * stream["s_words"] <= SMEM_LIMIT
        assert h["s_words"] == (stream if h["layout"] else shared)[
            "s_words"] and h["blob_words"] == blob.size
        routes.append(h["layout"])
        # a block with less shared memory than either: the global layout
        least = pack_dense(prog, 256, "stream", 1)[0]["s_words"]
        tight = 4 * min(shared["s_words"], least) - 4
        assert K.dense_plan(prog, 256, tight)[0]["layout"] == 2
    assert routes == [0, 1]
    routes = []
    for width in (200, 960):
        g = _wide_dfg(0, width)
        g.sparse = True
        prog = lower_sparse(g)
        shared, _ = pack_sparse(prog, (3, 64), 2560)
        stream, _ = pack_sparse(prog, (3, 64), 2560, "stream")
        h, _ = K.sparse_plan(prog, (3, 64), 2560, SMEM_LIMIT)
        assert h["global_route"] == int(4 * shared["s_words"] > SMEM_LIMIT)
        assert 4 * stream["s_words"] <= SMEM_LIMIT
        routes.append(h["layout"])
        tight = 4 * min(shared["s_words"], stream["s_words"]) - 4
        assert K.sparse_plan(prog, (3, 64), 2560, tight)[0]["layout"] == 2
    assert routes == [0, 1]


def test_plans_take_the_global_route_past_the_16_bit_fields():
    """A latency ring of 70 000 words passes the shared route's 16-bit
    fields: the plan takes the global route whatever the shared memory, and
    the shared route's pack refuses it."""
    g = DFG("deep")
    d = g.add("mem", name="d", op="delay", depth=70_000, latency=1)
    g.connect(g.add("input", name="i"), d)
    g.connect(d, g.add("output", name="o"))
    prog = lower_dense(g.validate())
    with pytest.raises(ValueError, match="16-bit"):
        pack_dense(prog, 8)
    h, _ = K.dense_plan(prog, 8, 1 << 30)
    assert h["global_route"] == 1
    ins = {"i": list(range(1, 9))}
    _check_dense_walk(prog, ins, 8, "global")


def test_dense_walker_on_a_routed_netlist():
    """A Table I design (harris, full pipelining) compiled and routed on
    the CPU at a few moves a node: its netlist's DFG."""
    from repro_torch.core import CascadeCompiler, PassConfig
    r = CascadeCompiler(device="cpu").compile(
        DENSE_APPS["harris"], PassConfig.full(place_moves=4), verify=False)
    g = r.design.netlist.to_dfg()
    _check_dense_walk(lower_dense(g), _inputs(g, WALK_CYCLES), WALK_CYCLES)


def _enum(src: str, name: str):
    body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S).group(1)
    return tuple(x.strip() for x in body.split(",") if x.strip())


def _flags(src: str):
    return {name: int(a) << int(b) for name, a, b in re.findall(
        r"constexpr uint32_t k(\w+) = (\d+)u << (\d+);", src)}


def test_micro_ops_and_flags_match_the_cuda_source():
    ops = (CSRC / "sim_ops.cuh").read_text()
    assert tuple(u[len("kU_"):] for u in _enum(ops, "Uop")) == \
        K.sim.UOPS == UOP_NAMES
    dense = (CSRC / "sim_dense.cu").read_text()
    assert _flags(dense) == {n: f << K.sim.D_SHIFT
                             for n, f in K.sim.DENSE_FLAGS.items()}
    assert f"kChunk = {K.sim.CHUNK};" in dense
    assert "alu16(ctl >> 24" in dense and K.sim.D_UOP_SHIFT == 24
    sparse = (CSRC / "sim_sparse.cu").read_text()
    assert _flags(sparse) == {n: f << 4 for n, f in
                              K.sim.SPARSE_FLAGS.items()}
    assert f"kRomShift = {K.sim.ROM_SHIFT};" in sparse


def test_layout_constants_match_the_cuda_source():
    """The layouts' numbering, the sparse descriptor's inline outputs and
    more-word split, and each kernel's streamed chunk, as the kernels
    declare them."""
    ops = (CSRC / "sim_ops.cuh").read_text()
    assert tuple(v.split("=")[0].strip() for v in _enum(ops, "Layout")) == \
        tuple(f"k{n.capitalize()}Layout" for n in K.sim.LAYOUTS)
    dense = (CSRC / "sim_dense.cu").read_text()
    sparse = (CSRC / "sim_sparse.cu").read_text()
    assert f"kStreamChunk = {K.sim.STREAM_CHUNKS['dense']};" in dense
    assert f"kStreamChunk = {K.sim.STREAM_CHUNKS['sparse']};" in sparse
    assert "DescStream<2, kStreamChunk>" in dense
    assert "DescStream<3, kStreamChunk>" in sparse
    assert f"kFan = {K.sim.FAN};" in sparse
    assert f"kMoreShift = {K.sim.MORE_SHIFT};" in sparse


@pytest.mark.parametrize("op", [o for o in _OPS if o not in ("acc", "accp")])
def test_micro_ops_equal_the_plain_formulas(op):
    """Each opcode as the kernels evaluate it (canon_op's micro-op over
    permuted operands, _alu16) equals ref.py's formula, on edge values and
    random 16-bit operands."""
    rng = np.random.default_rng(3)
    edge = [0, 1, 2, 15, 16, 0x7FFF, 0x8000, 0x8001, 0xFFFE, 0xFFFF]
    a = np.array([[x, y, z] for x in edge for y in edge for z in (0, 1)]
                 + rng.integers(0, 0x10000, size=(400, 3)).tolist())
    code = _OPS.index(op)
    # operand refs 0-2 read a0-a2, ref 3 reads 0 and ref 4 reads 1
    uop, x, y, z = K.sim.canon_op(code, [0, 1, 2], 3, 4)
    table, tab_len = [5, 6, 7], np.array([3])
    d, m = K.sim.rom_magic(tab_len)
    want = ref._apply_op(code, *torch.from_numpy(a).T,
                         torch.zeros(len(a), dtype=torch.long),
                         torch.tensor([table]),
                         torch.from_numpy(tab_len)).tolist()
    for row, w in zip(a.tolist(), want):
        v = row + [0, 1]
        got = _alu16(uop, v[x], v[y], v[z])
        if op == "rom":                      # the kernels' lookup
            got = table[int(K.sim.rom_index(got, d[0], m[0]))]
        assert got == w, (op, row)


def test_rom_reciprocal_is_exact():
    """umulhi((m * a) mod 2**32, d) == a % tab_len for every 16-bit a and
    every table length the apps' lowerings emit, and at the edges."""
    lens = set()
    for name in ALL_DENSE:
        lens.update(lower_dense(_port_app(name)).tab_len.tolist())
    for name in SPARSE_APPS:
        lens.update(lower_sparse(_port_app(name)).tab_len.tolist())
    lens.update([1, 2, 3, 7, 37, 255, 256, 257, 4095, 65535, 65536, 65537,
                 100_000])
    a = np.arange(1 << 16, dtype=np.uint64)
    for n in sorted(lens):
        d, m = K.sim.rom_magic(np.array([n]))
        got = K.sim.rom_index(a, d[0], m[0])
        assert np.array_equal(got, a % np.uint64(n)), n
        assert int(got.max()) < min(n, 1 << 16)
