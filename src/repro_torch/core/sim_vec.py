"""Vectorized simulator backends — the ``"numpy"`` / ``"torch"`` sim kernels.

The interpreter in :mod:`repro_torch.core.sim` is the correctness oracle for
every pipelining pass, but it walks every node in topological order with
Python dicts and deques every cycle.  This module lowers a
:class:`~repro_torch.core.dfg.DFG` *once* into dense tensor form and steps
**all** nodes per cycle with numpy, or runs the whole simulation on a torch
device: on the card as one launch of a hand-written CUDA kernel
(``repro_torch.kernels.sim``: ``sim_dense`` for the dense cycle loop,
``sim_sparse`` for the ready-valid fixpoint), on the CPU through the
kernels' plain PyTorch versions.

Lowered dense form (:func:`lower_dense`):

* a flat value vector indexed by topological position, with one trailing
  *pad* slot that always reads 0 (missing arguments gather from it);
* padded per-node argument-gather indices ``(node, 3)`` — the widest op is
  ``mux`` — grouped by ``(combinational level, opcode)`` so each group is
  one gather + one vectorized op + one scatter;
* latency shift-register state as a ``(seq_nodes, max_lat)`` circular
  buffer with a per-node write pointer (REG/RF/FIFO/MEM latency queues);
* ROM tables padded into one ``(n_rom, max_table)`` matrix;
* accumulator state as its own vector (present/sample exactly like the
  interpreter's ``accum`` dict).

Lowered sparse form (:func:`lower_sparse`): one circular FIFO per
``(dst, port)`` input buffer — capacity ``depth`` for FIFO nodes, 1
otherwise — and ready-valid firing as a **masked fire-vector fixpoint**:
each round fires every node whose inputs are all non-empty and whose
output buffers all have space, applies all pops/pushes synchronously, and
repeats until no node can fire.  Bounded-buffer Kahn networks are
confluent, so the quiescent state — and therefore every output stream —
is identical to the interpreter's sequential sweep; deadlock is detected
exactly as in the interpreter, when the fire mask is empty while input
feed tokens are still pending.

Contract with the interpreter:

* **bit-identical** output streams for both ``simulate`` and
  ``simulate_sparse`` on any graph whose values stay in the 16-bit domain
  — input streams, CONST values, and ROM tables must fit ``[0, 0xFFFF]``
  (every PE/MEM op is closed over that domain, so this is the whole
  reachable state space; out-of-range values raise rather than silently
  diverging from the interpreter's unbounded Python ints);
* deterministic: there is no RNG anywhere, so equal inputs give equal
  outputs on every backend, every run;
* ``torch`` runs on ``device`` (default: the card; without CUDA it raises
  unless ``device="cpu"`` is asked for), and the kernels are imported
  lazily so numpy-only users never build them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .dfg import (CONST, CONTROL_PORT, DFG, FIFO, INPUT, MEM, OUTPUT, PE,
                  PE_ARITY, PE_OPS, PRED_OPS, PRED_PORT)

MASK = 0xFFFF

#: Vectorized opcode space.  The named PE ops mirror ``PE_OPS`` order-free
#: (predicated ops gather their predicate as the last argument — the
#: port-sorted edge lists put the ``PRED_PORT`` band after the data
#: operands, so the gather order matches the ``PE_OPS`` lambda signature);
#: ``pass`` also covers REG/RF/FIFO/OUTPUT/MEM-delay forwarding, ``zero``
#: covers unconnected forwards and empty-table ROMs, ``rom`` is the
#: table-lookup MEM, ``acc`` the sparse accumulator and ``accp`` its
#: predicated (hold-on-false) variant.
_OPS = ("zero", "pass", "add", "sub", "mul", "and", "or", "xor", "shr",
        "shl", "min", "max", "abs", "gt", "lt", "eq", "ne", "ge", "le",
        "mux", "sel", "phi", "steer", "rom", "acc", "accp")
_OPC = {name: i for i, name in enumerate(_OPS)}


class SimLoweringError(ValueError):
    """The graph (or its inputs) cannot be lowered for a vectorized
    backend; it must be simulated with the interpreter backend."""


def _check_u16(values, what: str):
    for v in values:
        if not (0 <= int(v) <= MASK):
            raise SimLoweringError(
                f"{what} value {v!r} is outside the 16-bit domain "
                f"[0, 0x{MASK:X}] the vectorized backends are bit-identical "
                f"over; use the interpreter backend for wider values")


def _op_table(xp, romgather):
    """Opcode -> vectorized implementation over arrays of one dtype.

    Every formula is the *same expression* as the interpreter's
    ``PE_OPS`` lambda, evaluated elementwise; masking keeps wrapped
    arithmetic exact in any integer dtype wide enough to hold the
    pre-mask intermediate modulo the dtype (int64 for numpy, uint32 in
    the CUDA kernels — ``(a * b) mod 2**32 & 0xFFFF == (a * b) & 0xFFFF``).
    """
    def cast(b, like):
        return b.astype(like.dtype)

    return {
        _OPC["zero"]: lambda a0, a1, a2, g: xp.zeros_like(a0),
        _OPC["pass"]: lambda a0, a1, a2, g: a0,
        _OPC["add"]: lambda a0, a1, a2, g: (a0 + a1) & MASK,
        _OPC["sub"]: lambda a0, a1, a2, g: (a0 - a1) & MASK,
        _OPC["mul"]: lambda a0, a1, a2, g: (a0 * a1) & MASK,
        _OPC["and"]: lambda a0, a1, a2, g: a0 & a1,
        _OPC["or"]: lambda a0, a1, a2, g: a0 | a1,
        _OPC["xor"]: lambda a0, a1, a2, g: a0 ^ a1,
        _OPC["shr"]: lambda a0, a1, a2, g: (a0 >> (a1 & 0xF)) & MASK,
        _OPC["shl"]: lambda a0, a1, a2, g: (a0 << (a1 & 0xF)) & MASK,
        _OPC["min"]: lambda a0, a1, a2, g: xp.minimum(a0, a1),
        _OPC["max"]: lambda a0, a1, a2, g: xp.maximum(a0, a1),
        _OPC["abs"]: lambda a0, a1, a2, g: xp.where(
            a0 < 0x8000, a0, (-a0) & MASK),
        _OPC["gt"]: lambda a0, a1, a2, g: cast(a0 > a1, a0),
        _OPC["lt"]: lambda a0, a1, a2, g: cast(a0 < a1, a0),
        _OPC["eq"]: lambda a0, a1, a2, g: cast(a0 == a1, a0),
        _OPC["ne"]: lambda a0, a1, a2, g: cast(a0 != a1, a0),
        _OPC["ge"]: lambda a0, a1, a2, g: cast(a0 >= a1, a0),
        _OPC["le"]: lambda a0, a1, a2, g: cast(a0 <= a1, a0),
        _OPC["mux"]: lambda a0, a1, a2, g: xp.where(
            cast(a0 & 1, a0) != 0, a1, a2),
        # predicated ops: the predicate arrives as the last gathered arg
        _OPC["sel"]: lambda a0, a1, a2, g: xp.where(
            cast(a2 & 1, a0) != 0, a0, a1),
        _OPC["phi"]: lambda a0, a1, a2, g: xp.where(
            cast(a2 & 1, a0) != 0, a0, a1),
        _OPC["steer"]: lambda a0, a1, a2, g: xp.where(
            cast(a1 & 1, a0) != 0, a0, xp.zeros_like(a0)),
        _OPC["rom"]: romgather,
    }


# ---------------------------------------------------------------------------
# dense lowering
# ---------------------------------------------------------------------------


@dataclass
class _Group:
    """One ``(level, opcode)`` evaluation group: gather args, apply the op,
    scatter results.  ``out`` indexes the value vector for combinational
    groups and the seq-slot space for sample-phase groups."""

    op: int
    out: np.ndarray                # (k,) scatter targets
    args: np.ndarray               # (k, 3) gather indices into val (pad = N)
    rom_rows: np.ndarray           # (k,) row into table matrix (rom only)


@dataclass
class DenseProgram:
    """A DFG lowered for the dense per-cycle steppers (backend-agnostic:
    every tensor is a host numpy array; the torch backend ships them to the
    device once per call)."""

    name: str
    n_nodes: int
    order: List[str]
    input_names: List[str]         # stream gather order
    output_names: List[str]
    input_pos: np.ndarray          # (n_in,) value-vector slots
    output_pos: np.ndarray
    const_pos: np.ndarray
    const_vals: np.ndarray
    accum_pos: np.ndarray          # (n_accum,) value slots
    accum_src: np.ndarray          # (n_accum,) arg gather index (pad ok)
    accum_pred: np.ndarray         # (n_accum,) predicate gather index (pad ok)
    accum_pmask: np.ndarray        # (n_accum,) bool: True = predicated
    seq_pos: np.ndarray            # (n_seq,) value slots of latency nodes
    seq_lat: np.ndarray            # (n_seq,) cycle latencies (>= 1)
    comb_groups: List[_Group] = field(default_factory=list)   # level-ordered
    seq_groups: List[_Group] = field(default_factory=list)    # out = seq slot
    table_mat: np.ndarray = None   # (n_rom, max_tab)
    tab_len: np.ndarray = None     # (n_rom,)

    @property
    def max_lat(self) -> int:
        return int(self.seq_lat.max()) if len(self.seq_lat) else 1

    def signature(self) -> tuple:
        """Static program shape: the reference's jit-factory cache key,
        kept so that a lowering means the same in both packages."""
        return (self.n_nodes, len(self.input_pos), len(self.output_pos),
                len(self.const_pos), len(self.accum_pos), len(self.seq_pos),
                self.max_lat,
                self.table_mat.shape if self.table_mat is not None else None,
                tuple((g.op, len(g.out)) for g in self.comb_groups),
                tuple((g.op, len(g.out)) for g in self.seq_groups))


def _eval_spec(g: DFG, node, args: List[int], pad: int,
               rom_tables: List[List[int]]) -> Tuple[int, List[int], int]:
    """(opcode, padded arg indices, rom row) for one evaluable node —
    mirrors ``sim._eval_node`` case by case."""
    a = list(args)[:3] + [pad] * (3 - min(3, len(args)))
    if node.kind == PE:
        if node.op not in PE_OPS or node.op not in _OPC:
            raise SimLoweringError(
                f"{g.name}: PE op {node.op!r} has no vectorized lowering")
        if node.op in PRED_OPS and len(args) != PE_ARITY[node.op] + 1:
            # the interpreter tolerates a missing predicate (acts enabled);
            # the vectorized gather would read the 0-pad slot and disable
            # the op, so refuse to lower rather than silently diverge
            raise SimLoweringError(
                f"{g.name}: predicated PE {node.name} op={node.op} needs "
                f"its predicate edge for vectorized lowering "
                f"(got {len(args)} in-band inputs)")
        return _OPC[node.op], a, -1
    if node.kind == MEM and node.op == "rom":
        table = node.meta.get("table", [])
        if not table:
            return _OPC["zero"], a, -1
        _check_u16(table, f"ROM {node.name} table")
        rom_tables.append([int(v) for v in table])
        return _OPC["rom"], a, len(rom_tables) - 1
    # MEM delay/linebuffer/default, REG, RF, FIFO, OUTPUT: forward arg 0
    return (_OPC["pass"] if args else _OPC["zero"]), a, -1


def _op_key(g: DFG, node, has_args: bool) -> int:
    """Grouping opcode for one evaluable node (no side effects — the
    table-registering twin is :func:`_eval_spec`)."""
    if node.kind == PE:
        if node.op not in PE_OPS or node.op not in _OPC:
            raise SimLoweringError(
                f"{g.name}: PE op {node.op!r} has no vectorized lowering")
        return _OPC[node.op]
    if node.kind == MEM and node.op == "rom":
        return _OPC["rom"] if node.meta.get("table") else _OPC["zero"]
    return _OPC["pass"] if has_args else _OPC["zero"]


def lower_dense(g: DFG) -> DenseProgram:
    """Lower ``g`` once for the dense vectorized steppers.

    The value-vector slot layout is canonical — ``[inputs | seq | accum |
    const | comb groups]`` with every evaluation group a *contiguous*
    slot range — so each per-cycle phase is a static-slice write instead
    of a scatter (the ``sim_dense`` kernel's present phase writes slot
    ranges, and the layout is fully determined by
    :meth:`DenseProgram.signature`).
    """
    order = g.topo_order()
    n = len(order)
    pad = n
    in_edges = {name: sorted((e for e in g.in_edges(name)
                              if e.port < CONTROL_PORT),
                             key=lambda e: e.port) for name in order}

    inputs, consts, accums, seqs, combs = [], [], [], [], []
    for name in order:
        nd = g.nodes[name]
        if nd.kind == INPUT:
            inputs.append(name)
        elif nd.kind == CONST:
            _check_u16([nd.value], f"CONST {name}")
            consts.append(name)
        elif nd.kind == MEM and nd.op == "accum":
            accums.append(name)
        elif nd.cycle_latency() > 0:
            seqs.append(name)
        else:
            combs.append(name)

    # combinational levels: a comb node's args are final once every comb
    # predecessor has evaluated; everything else is fixed at present time
    level = {}
    for name in combs:
        lv = 0
        for e in in_edges[name]:
            if e.src in level:
                lv = max(lv, level[e.src] + 1)
        level[name] = lv

    comb_names: Dict[Tuple[int, int], List[str]] = {}
    for name in combs:
        key = (level[name], _op_key(g, g.nodes[name], bool(in_edges[name])))
        comb_names.setdefault(key, []).append(name)
    seq_names: Dict[int, List[str]] = {}
    for name in seqs:
        key = _op_key(g, g.nodes[name], bool(in_edges[name]))
        seq_names.setdefault(key, []).append(name)

    # canonical slot layout: inputs, seq (group order), accum, const,
    # then each comb group as one contiguous range
    slot: Dict[str, int] = {}
    seq_ordered: List[str] = []
    for key in sorted(seq_names):
        seq_ordered.extend(seq_names[key])
    cursor = 0
    for name in inputs + seq_ordered + accums + consts:
        slot[name] = cursor
        cursor += 1
    comb_ranges: List[Tuple[Tuple[int, int], List[str]]] = []
    for key in sorted(comb_names):
        comb_ranges.append((key, comb_names[key]))
        for name in comb_names[key]:
            slot[name] = cursor
            cursor += 1
    assert cursor == n

    rom_tables: List[List[int]] = []

    def build_group(op_key, names, out_slots) -> _Group:
        args, roms = [], []
        for name in names:
            nd = g.nodes[name]
            a_idx = [slot[e.src] for e in in_edges[name]]
            op, a, rom = _eval_spec(g, nd, a_idx, pad, rom_tables)
            args.append(a)
            roms.append(rom)
        return _Group(op=op_key,
                      out=np.array(out_slots, dtype=np.int64),
                      args=np.array(args, dtype=np.int64),
                      rom_rows=np.array(roms, dtype=np.int64))

    comb_groups = [build_group(key[1], names,
                               [slot[nm] for nm in names])
                   for key, names in comb_ranges]
    seq_slot = {name: i for i, name in enumerate(seq_ordered)}
    seq_groups = []
    for key in sorted(seq_names):
        names = seq_names[key]
        seq_groups.append(build_group(key, names,
                                      [seq_slot[nm] for nm in names]))

    max_tab = max((len(t) for t in rom_tables), default=1)
    table_mat = np.zeros((max(1, len(rom_tables)), max_tab), dtype=np.int64)
    tab_len = np.ones(max(1, len(rom_tables)), dtype=np.int64)
    for i, t in enumerate(rom_tables):
        table_mat[i, :len(t)] = t
        tab_len[i] = len(t)

    outputs = [name for name in order if g.nodes[name].kind == OUTPUT]
    accum_src, accum_pred, accum_pmask = [], [], []
    for name in accums:
        data = [e for e in in_edges[name] if e.port < PRED_PORT]
        pe_ = [e for e in in_edges[name] if e.port >= PRED_PORT]
        accum_src.append(slot[data[0].src] if data else pad)
        accum_pred.append(slot[pe_[0].src] if pe_ else pad)
        accum_pmask.append(bool(pe_))

    return DenseProgram(
        name=g.name, n_nodes=n, order=order,
        input_names=list(inputs), output_names=outputs,
        input_pos=np.array([slot[i] for i in inputs], dtype=np.int64),
        output_pos=np.array([slot[o] for o in outputs], dtype=np.int64),
        const_pos=np.array([slot[c] for c in consts], dtype=np.int64),
        const_vals=np.array([g.nodes[c].value for c in consts],
                            dtype=np.int64),
        accum_pos=np.array([slot[a] for a in accums], dtype=np.int64),
        accum_src=np.array(accum_src, dtype=np.int64),
        accum_pred=np.array(accum_pred, dtype=np.int64),
        accum_pmask=np.array(accum_pmask, dtype=bool),
        seq_pos=np.array([slot[s] for s in seq_ordered], dtype=np.int64),
        seq_lat=np.array([g.nodes[s].cycle_latency() for s in seq_ordered],
                         dtype=np.int64),
        comb_groups=comb_groups,
        seq_groups=seq_groups,
        table_mat=table_mat, tab_len=tab_len)


def _input_matrix(prog: DenseProgram, inputs: Dict[str, Sequence[int]],
                  cycles: int) -> np.ndarray:
    mat = np.zeros((len(prog.input_names), cycles), dtype=np.int64)
    for row, name in enumerate(prog.input_names):
        seq = inputs.get(name, ())
        _check_u16(seq, f"input stream {name!r}")
        k = min(len(seq), cycles)
        if k:
            mat[row, :k] = np.asarray(list(seq[:k]), dtype=np.int64)
    return mat


# ---------------------------------------------------------------------------
# dense numpy backend
# ---------------------------------------------------------------------------


def _dense_numpy(prog: DenseProgram, in_mat: np.ndarray,
                 cycles: int) -> np.ndarray:
    n_seq, n_acc = len(prog.seq_pos), len(prog.accum_pos)
    val = np.zeros(prog.n_nodes + 1, dtype=np.int64)
    val[prog.const_pos] = prog.const_vals
    seq_state = np.zeros((max(1, n_seq), prog.max_lat), dtype=np.int64)
    seq_ptr = np.zeros(max(1, n_seq), dtype=np.int64)
    seq_ar = np.arange(max(1, n_seq))
    accum = np.zeros(max(1, n_acc), dtype=np.int64)
    out_mat = np.zeros((len(prog.output_pos), cycles), dtype=np.int64)

    def romgather(a0, a1, a2, grp):
        rows = grp.rom_rows
        return prog.table_mat[rows, a0 % prog.tab_len[rows]]

    ops = _op_table(np, romgather)

    for t in range(cycles):
        # present phase
        val[prog.input_pos] = in_mat[:, t]
        if n_seq:
            val[prog.seq_pos] = seq_state[seq_ar, seq_ptr]
        if n_acc:
            val[prog.accum_pos] = accum[:n_acc]
        # combinational phase, level by level
        for grp in prog.comb_groups:
            a = val[grp.args]
            val[grp.out] = ops[grp.op](a[:, 0], a[:, 1], a[:, 2], grp)
        out_mat[:, t] = val[prog.output_pos]
        # sample phase (a false predicate holds the accumulator)
        if n_acc:
            en = (~prog.accum_pmask) | ((val[prog.accum_pred] & 1) == 1)
            accum[:n_acc] = np.where(
                en, (accum[:n_acc] + val[prog.accum_src]) & MASK,
                accum[:n_acc])
        if n_seq:
            newv = np.zeros(n_seq, dtype=np.int64)
            for grp in prog.seq_groups:
                a = val[grp.args]
                newv[grp.out] = ops[grp.op](a[:, 0], a[:, 1], a[:, 2], grp)
            seq_state[seq_ar, seq_ptr] = newv
            seq_ptr = (seq_ptr + 1) % prog.seq_lat
    return out_mat


def _dense_torch(prog: DenseProgram, in_mat: np.ndarray, cycles: int,
                 device) -> np.ndarray:
    from ..kernels.sim import sim_dense           # lazy: it imports this

    dev = resolve_device(device)
    out = sim_dense(prog, torch.from_numpy(in_mat).to(dev), cycles)
    return out.cpu().numpy()


def simulate_dense_vec(g: DFG, inputs: Dict[str, Sequence[int]],
                       cycles: int, backend: str = "numpy", device=None
                       ) -> Dict[str, List[int]]:
    """Vectorized ``simulate`` — bit-identical to the interpreter over the
    16-bit domain (raises :class:`SimLoweringError` outside it).
    ``device`` is read by the ``torch`` backend only."""
    prog = lower_dense(g)
    in_mat = _input_matrix(prog, inputs, cycles)
    if backend == "torch":
        out_mat = _dense_torch(prog, in_mat, cycles, device)
    else:
        out_mat = _dense_numpy(prog, in_mat, cycles)
    return {name: out_mat[i].tolist()
            for i, name in enumerate(prog.output_names)}


# ---------------------------------------------------------------------------
# sparse lowering
# ---------------------------------------------------------------------------


@dataclass
class SparseProgram:
    """A ready-valid DFG lowered to per-``(dst, port)`` circular buffers
    and fire-vector tensors."""

    name: str
    order: List[str]
    # buffers
    n_buf: int
    cap: np.ndarray                # (n_buf,)
    max_cap: int
    buf_label: List[Tuple[str, int]]          # (dst node, port) per buffer
    buf_src_name: List[str]                   # producing node per buffer
    # evaluable (non-IO, non-const) nodes
    ev_names: List[str]
    ev_op: np.ndarray              # (n_ev,)
    ev_rom: np.ndarray             # (n_ev,) row into table matrix
    ev_acc: np.ndarray             # (n_ev,) accumulator slot or -1
    acc_ev: np.ndarray             # (n_acc,) ev index per accumulator slot
    ev_in: np.ndarray              # (n_ev, 3) buffer ids (pad 0)
    ev_in_mask: np.ndarray         # (n_ev, 3)
    ev_has_in: np.ndarray          # (n_ev,)
    ev_out: np.ndarray             # (n_ev, F)
    ev_out_mask: np.ndarray
    # inputs / consts / outputs
    input_names: List[str]
    in_out: np.ndarray             # (n_in, F)
    in_out_mask: np.ndarray
    const_buf: np.ndarray          # (n_cb,) buffers fed by consts
    const_val: np.ndarray          # (n_cb,)
    output_names: List[str]
    out_buf: np.ndarray            # (n_outn,)
    # reverse maps: every buffer has exactly one producer and one consumer
    buf_src_ev: np.ndarray         # (n_buf,) producing ev index or -1
    buf_src_in: np.ndarray         # (n_buf,) producing input index or -1
    buf_cons_ev: np.ndarray        # (n_buf,) consuming ev index or -1
    buf_cons_out: np.ndarray       # (n_buf,) consuming output index or -1
    n_acc: int
    table_mat: np.ndarray
    tab_len: np.ndarray

    def signature(self) -> tuple:
        return (self.n_buf, self.max_cap, len(self.ev_names),
                self.ev_out.shape[1], len(self.input_names),
                self.in_out.shape[1], len(self.const_buf),
                len(self.output_names), self.n_acc, self.table_mat.shape,
                tuple(int(o) for o in self.ev_op))


def lower_sparse(g: DFG) -> SparseProgram:
    order = g.topo_order()
    nodes = g.nodes
    data_in = {n: sorted((e for e in g.in_edges(n) if e.port < CONTROL_PORT),
                         key=lambda e: e.port) for n in order}
    data_out = {n: [e for e in g.out_edges(n) if e.port < CONTROL_PORT]
                for n in order}

    buf_id: Dict[Tuple[str, int], int] = {}
    buf_label, buf_src_name, caps = [], [], []
    for n in order:
        for e in data_in[n]:
            key = (n, e.port)
            if key in buf_id:
                raise SimLoweringError(
                    f"{g.name}: two edges land on {n}.port{e.port}; the "
                    f"sparse vectorized backend needs one source per port")
            buf_id[key] = len(buf_label)
            buf_label.append(key)
            buf_src_name.append(e.src)
            caps.append(nodes[n].depth if nodes[n].kind == FIFO else 1)
    n_buf = len(buf_label)
    cap = np.array(caps if caps else [1], dtype=np.int64)

    rom_tables: List[List[int]] = []
    ev_names, ev_rows = [], []
    inputs, outputs, const_rows = [], [], []
    for n in order:
        nd = nodes[n]
        if nd.kind == INPUT:
            inputs.append(n)
        elif nd.kind == CONST:
            _check_u16([nd.value], f"CONST {n}")
            for e in data_out[n]:
                const_rows.append((buf_id[(e.dst, e.port)], nd.value))
        elif nd.kind == OUTPUT:
            if len(data_in[n]) != 1:
                raise SimLoweringError(
                    f"{g.name}: OUTPUT {n} has {len(data_in[n])} data "
                    f"inputs; the sparse backends support exactly one")
            outputs.append(n)
        else:
            ev_names.append(n)
            ins = [buf_id[(n, e.port)] for e in data_in[n]]
            outs = [buf_id[(e.dst, e.port)] for e in data_out[n]]
            if nd.kind == MEM and nd.op == "accum":
                # predicated accumulators (a PRED_PORT-band in-edge) hold
                # state on a false predicate but still consume/emit tokens
                has_pred = any(e.port >= PRED_PORT for e in data_in[n])
                op, rom = _OPC["accp" if has_pred else "acc"], -1
            else:
                op, _, rom = _eval_spec(g, nd, list(range(len(ins))), 0,
                                        rom_tables)
            ev_rows.append((op, rom, ins, outs))

    n_ev = len(ev_names)
    F = max([len(r[3]) for r in ev_rows] +
            [len(data_out[i]) for i in inputs] + [1])
    ev_op = np.array([r[0] for r in ev_rows] or [0], dtype=np.int64)
    ev_rom = np.array([max(r[1], 0) for r in ev_rows] or [0], dtype=np.int64)
    acc_slot, acc_ev, n_acc = [], [], 0
    for i, r in enumerate(ev_rows):
        if r[0] in (_OPC["acc"], _OPC["accp"]):
            acc_slot.append(n_acc)
            acc_ev.append(i)
            n_acc += 1
        else:
            acc_slot.append(-1)
    ev_in = np.zeros((max(1, n_ev), 3), dtype=np.int64)
    ev_in_mask = np.zeros((max(1, n_ev), 3), dtype=bool)
    ev_out = np.zeros((max(1, n_ev), F), dtype=np.int64)
    ev_out_mask = np.zeros((max(1, n_ev), F), dtype=bool)
    for i, (_, _, ins, outs) in enumerate(ev_rows):
        if len(ins) > 3:
            raise SimLoweringError(
                f"{g.name}: {ev_names[i]} has {len(ins)} data inputs (>3)")
        ev_in[i, :len(ins)] = ins
        ev_in_mask[i, :len(ins)] = True
        ev_out[i, :len(outs)] = outs
        ev_out_mask[i, :len(outs)] = True
    ev_has_in = ev_in_mask.any(axis=1)

    in_out = np.zeros((max(1, len(inputs)), F), dtype=np.int64)
    in_out_mask = np.zeros((max(1, len(inputs)), F), dtype=bool)
    for i, n in enumerate(inputs):
        outs = [buf_id[(e.dst, e.port)] for e in data_out[n]]
        in_out[i, :len(outs)] = outs
        in_out_mask[i, :len(outs)] = True

    out_buf = np.array([buf_id[(n, data_in[n][0].port)] for n in outputs]
                       or [0], dtype=np.int64)

    buf_src_ev = np.full(max(1, n_buf), -1, dtype=np.int64)
    buf_src_in = np.full(max(1, n_buf), -1, dtype=np.int64)
    buf_cons_ev = np.full(max(1, n_buf), -1, dtype=np.int64)
    buf_cons_out = np.full(max(1, n_buf), -1, dtype=np.int64)
    ev_index = {n: i for i, n in enumerate(ev_names)}
    in_index = {n: i for i, n in enumerate(inputs)}
    out_index = {n: i for i, n in enumerate(outputs)}
    for b, (dst, port) in enumerate(buf_label):
        src = buf_src_name[b]
        if src in ev_index:
            buf_src_ev[b] = ev_index[src]
        elif src in in_index:
            buf_src_in[b] = in_index[src]
        if dst in ev_index:
            buf_cons_ev[b] = ev_index[dst]
        elif dst in out_index:
            buf_cons_out[b] = out_index[dst]

    max_tab = max((len(t) for t in rom_tables), default=1)
    table_mat = np.zeros((max(1, len(rom_tables)), max_tab), dtype=np.int64)
    tab_len = np.ones(max(1, len(rom_tables)), dtype=np.int64)
    for i, t in enumerate(rom_tables):
        table_mat[i, :len(t)] = t
        tab_len[i] = len(t)

    return SparseProgram(
        name=g.name, order=order, n_buf=max(1, n_buf), cap=cap,
        max_cap=int(cap.max()), buf_label=buf_label,
        buf_src_name=buf_src_name,
        ev_names=ev_names, ev_op=ev_op, ev_rom=ev_rom,
        ev_acc=np.array(acc_slot or [-1], dtype=np.int64),
        acc_ev=np.array(acc_ev or [0], dtype=np.int64),
        ev_in=ev_in, ev_in_mask=ev_in_mask, ev_has_in=ev_has_in,
        ev_out=ev_out, ev_out_mask=ev_out_mask,
        input_names=inputs, in_out=in_out, in_out_mask=in_out_mask,
        const_buf=np.array([r[0] for r in const_rows], dtype=np.int64),
        const_val=np.array([r[1] for r in const_rows], dtype=np.int64),
        output_names=outputs, out_buf=out_buf,
        buf_src_ev=buf_src_ev, buf_src_in=buf_src_in,
        buf_cons_ev=buf_cons_ev, buf_cons_out=buf_cons_out,
        n_acc=n_acc, table_mat=table_mat, tab_len=tab_len)


def _feed_matrix(prog: SparseProgram, inputs: Dict[str, Sequence[int]]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    max_feed = max([len(inputs.get(n, ())) for n in prog.input_names] + [1])
    feed = np.zeros((max(1, len(prog.input_names)), max_feed),
                    dtype=np.int64)
    frem = np.zeros(max(1, len(prog.input_names)), dtype=np.int64)
    for i, n in enumerate(prog.input_names):
        seq = list(inputs.get(n, ()))
        _check_u16(seq, f"input stream {n!r}")
        feed[i, :len(seq)] = seq
        frem[i] = len(seq)
    return feed, frem


def _sparse_quiescent_error(g: DFG, prog: SparseProgram, blen: np.ndarray,
                            frem: np.ndarray):
    """Raise the interpreter-compatible deadlock diagnostic from vector
    state (confluence makes the quiescent marking backend-independent)."""
    from .sim import _deadlock_message          # lazy: avoids import cycle

    buf_len = {prog.buf_label[b]: int(blen[b]) for b in range(len(
        prog.buf_label))}
    feed_left = {n: int(frem[i]) for i, n in enumerate(prog.input_names)}
    raise RuntimeError(_deadlock_message(g, buf_len, feed_left))


# ---------------------------------------------------------------------------
# sparse numpy backend
# ---------------------------------------------------------------------------


def _sparse_numpy(g: DFG, prog: SparseProgram,
                  inputs: Dict[str, Sequence[int]],
                  max_cycles: int) -> Dict[str, List[int]]:
    n_buf, n_ev = prog.n_buf, len(prog.ev_names)
    buf = np.zeros((n_buf, prog.max_cap), dtype=np.int64)
    blen = np.zeros(n_buf, dtype=np.int64)
    brp = np.zeros(n_buf, dtype=np.int64)
    ar_buf = np.arange(n_buf)
    feed, frem = _feed_matrix(prog, inputs)
    fptr = np.zeros_like(frem)
    accum = np.zeros(max(1, prog.n_acc), dtype=np.int64)
    outputs: Dict[str, List[int]] = {n: [] for n in prog.output_names}

    def romgather(a0, a1, a2, rows):
        return prog.table_mat[rows, a0 % prog.tab_len[rows]]

    ops = _op_table(np, None)

    quiescent = False
    for _ in range(max_cycles):
        heads = buf[ar_buf, brp]
        nonempty, space = blen > 0, blen < prog.cap
        ev_fire = ((nonempty[prog.ev_in] | ~prog.ev_in_mask).all(axis=1)
                   & prog.ev_has_in
                   & (space[prog.ev_out] | ~prog.ev_out_mask).all(axis=1))
        out_fire = (nonempty[prog.out_buf]
                    if prog.output_names else np.zeros(1, bool))
        in_fire = ((frem > 0)
                   & (space[prog.in_out] | ~prog.in_out_mask).all(axis=1))
        n_cb = len(prog.const_buf)
        c_push = (blen[prog.const_buf] == 0) if n_cb else np.zeros(0, bool)
        fired = (bool(ev_fire.any() if n_ev else False)
                 or bool(out_fire.any() if prog.output_names else False)
                 or bool(in_fire.any() if prog.input_names else False)
                 or bool(c_push.any()))
        if not fired:
            quiescent = True
            break
        # evaluate all ev nodes against the frozen heads
        a0 = np.where(prog.ev_in_mask[:, 0], heads[prog.ev_in[:, 0]], 0)
        a1 = np.where(prog.ev_in_mask[:, 1], heads[prog.ev_in[:, 1]], 0)
        a2 = np.where(prog.ev_in_mask[:, 2], heads[prog.ev_in[:, 2]], 0)
        v = np.zeros(max(1, n_ev), dtype=np.int64)
        for op in np.unique(prog.ev_op[:n_ev] if n_ev else []):
            sel = prog.ev_op[:n_ev] == op
            if op == _OPC["acc"]:
                v[sel] = (accum[prog.ev_acc[sel]] + a0[sel]) & MASK
            elif op == _OPC["accp"]:
                held = accum[prog.ev_acc[sel]]
                v[sel] = np.where((a1[sel] & 1) == 1,
                                  (held + a0[sel]) & MASK, held)
            elif op == _OPC["rom"]:
                v[sel] = romgather(a0[sel], None, None, prog.ev_rom[sel])
            else:
                v[sel] = ops[int(op)](a0[sel], a1[sel], a2[sel], None)
        if prog.n_acc:
            accum = np.where(ev_fire[prog.acc_ev], v[prog.acc_ev], accum)
        # pops (consumer fired)
        popped = (((prog.buf_cons_ev >= 0)
                   & ev_fire[np.maximum(prog.buf_cons_ev, 0)])
                  | ((prog.buf_cons_out >= 0)
                     & out_fire[np.maximum(prog.buf_cons_out, 0)]))
        popped &= ar_buf < len(prog.buf_label)
        # record outputs from the pre-round heads
        for oi, name in enumerate(prog.output_names):
            if out_fire[oi]:
                outputs[name].append(int(heads[prog.out_buf[oi]]))
        blen = blen - popped
        brp = (brp + popped) % prog.cap
        # pushes (producer fired), against post-pop occupancy
        push = np.zeros(n_buf, dtype=bool)
        pval = np.zeros(n_buf, dtype=np.int64)
        src_ev_ok = (prog.buf_src_ev >= 0) & \
            ev_fire[np.maximum(prog.buf_src_ev, 0)]
        push |= src_ev_ok
        pval[src_ev_ok] = v[prog.buf_src_ev[src_ev_ok]]
        tok = feed[np.arange(len(frem)), np.minimum(fptr, feed.shape[1] - 1)]
        src_in_ok = (prog.buf_src_in >= 0) & \
            in_fire[np.maximum(prog.buf_src_in, 0)]
        push |= src_in_ok
        pval[src_in_ok] = tok[prog.buf_src_in[src_in_ok]]
        if n_cb and c_push.any():
            cb = prog.const_buf[c_push]
            push[cb] = True
            pval[cb] = prog.const_val[c_push]
        pos = (brp + blen) % prog.cap
        buf[ar_buf[push], pos[push]] = pval[push]
        blen = blen + push
        fptr = fptr + in_fire
        frem = frem - in_fire
    if quiescent and frem.any():
        _sparse_quiescent_error(g, prog, blen, frem)
    return outputs


def _sparse_torch(g: DFG, prog: SparseProgram,
                  inputs: Dict[str, Sequence[int]], max_cycles: int,
                  device) -> Dict[str, List[int]]:
    from ..kernels.sim import sim_sparse          # lazy: it imports this

    dev = resolve_device(device)
    feed, frem = _feed_matrix(prog, inputs)
    res = sim_sparse(prog, torch.from_numpy(feed).to(dev),
                     torch.from_numpy(frem).to(dev), max_cycles)
    ocnt = res.ocnt.cpu().numpy()
    frem_f = res.frem.cpu().numpy()
    if not bool(res.fired) and frem_f.any():
        _sparse_quiescent_error(g, prog, res.blen.cpu().numpy(), frem_f)
    outm = res.outm[:, :int(ocnt.max(initial=0))].cpu().numpy()
    return {name: outm[i, :int(ocnt[i])].tolist()
            for i, name in enumerate(prog.output_names)}


def simulate_sparse_vec(g: DFG, inputs: Dict[str, Sequence[int]],
                        max_cycles: int = 100_000, backend: str = "numpy",
                        device=None) -> Dict[str, List[int]]:
    """Vectorized ``simulate_sparse`` — same streams, same deadlock
    semantics as the interpreter (Kahn-network confluence).  ``device`` is
    read by the ``torch`` backend only."""
    prog = lower_sparse(g)
    if backend == "torch":
        return _sparse_torch(g, prog, inputs, max_cycles, device)
    return _sparse_numpy(g, prog, inputs, max_cycles)
