"""Cycle-accurate functional simulation of Cascade DFGs.

This module is the *correctness oracle* for every pipelining pass: a
transformed graph must produce exactly the same output stream as the original,
shifted by the added pipeline latency (the invariant branch-delay matching
guarantees, paper Section III-B / V-A / V-D).

Two simulators:

``simulate``        statically-scheduled (dense) graphs: every node fires every
                    cycle; sequential nodes delay by ``cycle_latency`` cycles.
``simulate_sparse`` ready-valid (sparse) graphs: token streams with
                    backpressure through FIFO nodes; verifies FIFO insertion
                    preserves stream contents and introduces no deadlock.

Both accept a ``backend`` argument (``"interpreter"`` / ``"numpy"`` /
``"torch"``, default interpreter): the vectorized backends in
:mod:`repro_torch.core.sim_vec` lower the graph once to tensor form and are
bit-identical to the interpreter over the 16-bit value domain.  ``torch``
runs on ``device`` (default: the card, as one launch of a hand-written
CUDA kernel; without CUDA it raises unless ``device="cpu"``, where it runs
the kernels' plain versions).  Drivers read ``CASCADE_SIM_BACKEND`` through
:func:`repro_torch.core.config.sim_backend`; library code only ever takes
the explicit argument.

The interpreter is also the *oracle for predicated execution*: edges in
the ``[PRED_PORT, CONTROL_PORT)`` band resolve to the consuming node's
1-bit predicate (the last positional argument of ``steer``/``sel``/``phi``
PEs); a MEM accumulator with a false predicate holds its state — in the
sparse simulator it still consumes its input tokens and emits the held
value (value-gating), so the Kahn network's firing schedule is
predicate-independent and all three backends agree on deadlock markings.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

from .config import SIM_BACKENDS
from .dfg import (CONST, CONTROL_PORT, DFG, FIFO, INPUT, MEM, OUTPUT, PE,
                  PE_OPS, PRED_OPS, PRED_PORT, REG, RF)


def _eval_node(node, args: List[int], pred: Optional[int] = None) -> int:
    if node.kind == PE:
        fn = PE_OPS[node.op]
        if node.op in PRED_OPS:
            # predicate is the last positional argument; a node with no
            # predicate edge (validate() rejects, but partial graphs occur
            # in tests) behaves as if enabled.
            return fn(*args, 1 if pred is None else pred)
        return fn(*args)
    if node.kind == MEM:
        if node.op == "rom":
            table = node.meta.get("table", [])
            if not table:
                return 0
            # a ROM with no address edge reads entry 0 (was: IndexError)
            return table[(args[0] if args else 0) % len(table)]
        # "delay" / "linebuffer" / default: pure delay, handled by latency queue
        return args[0] if args else 0
    if node.kind in (REG, RF, FIFO):
        return args[0] if args else 0
    if node.kind == OUTPUT:
        return args[0] if args else 0
    raise ValueError(f"cannot evaluate node kind {node.kind}")


def _split_args(edges, value: Dict[str, int]):
    """Split a node's in-band values into positional data args and the
    (optional) predicate.  ``edges`` is the port-sorted ``< CONTROL_PORT``
    edge list, so data operands stay positional and the predicate — if any
    — is the single edge in the ``[PRED_PORT, CONTROL_PORT)`` band."""
    args: List[int] = []
    pred: Optional[int] = None
    for e in edges:
        if e.port >= PRED_PORT:
            pred = value[e.src]
        else:
            args.append(value[e.src])
    return args, pred


def _dispatch_backend(backend: Optional[str]) -> str:
    name = backend or "interpreter"
    if name not in SIM_BACKENDS:
        raise ValueError(
            f"unknown sim backend {backend!r}; expected one of "
            f"{SIM_BACKENDS}")
    return name


def simulate(g: DFG, inputs: Dict[str, Sequence[int]], cycles: int,
             backend: Optional[str] = None,
             device=None) -> Dict[str, List[int]]:
    """Run ``g`` for ``cycles`` cycles; returns per-OUTPUT sampled streams.

    Sequential nodes (REG/RF/FIFO/MEM/pipelined PE) delay their result by
    ``cycle_latency()`` cycles; combinational PEs evaluate within the cycle.
    ``backend`` selects the interpreter (default) or a vectorized backend
    from :mod:`repro_torch.core.sim_vec`; ``device`` is read by ``torch``.
    """
    name = _dispatch_backend(backend)
    if name != "interpreter":
        from . import sim_vec
        return sim_vec.simulate_dense_vec(g, inputs, cycles, backend=name,
                                          device=device)
    return _simulate_interp(g, inputs, cycles)


def _simulate_interp(g: DFG, inputs: Dict[str, Sequence[int]],
                     cycles: int) -> Dict[str, List[int]]:
    order = g.topo_order()
    in_edges = {n: sorted((e for e in g.in_edges(n) if e.port < CONTROL_PORT),
                          key=lambda e: e.port) for n in g.nodes}
    # queues hold the in-flight values of sequential nodes.
    queues: Dict[str, deque] = {}
    for name in order:
        node = g.nodes[name]
        lat = node.cycle_latency()
        if node.kind != INPUT and node.kind != CONST and lat > 0:
            queues[name] = deque([0] * lat, maxlen=lat)

    value: Dict[str, int] = {n: 0 for n in g.nodes}
    outputs: Dict[str, List[int]] = {
        n: [] for n, nd in g.nodes.items() if nd.kind == OUTPUT}
    accum = {n: 0 for n, nd in g.nodes.items()
             if nd.kind == MEM and nd.op == "accum"}

    for t in range(cycles):
        # present phase: sequential nodes expose the head of their queue;
        # inputs and consts drive fresh values.
        for name in order:
            node = g.nodes[name]
            if node.kind == INPUT:
                seq = inputs.get(name, ())
                value[name] = seq[t] if t < len(seq) else 0
            elif node.kind == CONST:
                value[name] = node.value
            elif name in accum:
                value[name] = accum[name]
            elif name in queues:
                value[name] = queues[name][0]
        # combinational phase (topological order)
        for name in order:
            node = g.nodes[name]
            if node.kind in (INPUT, CONST) or name in queues or name in accum:
                continue
            args, pred = _split_args(in_edges[name], value)
            value[name] = _eval_node(node, args, pred)
        # sample phase: sequential nodes capture this cycle's inputs.
        for name in accum:
            args, pred = _split_args(in_edges[name], value)
            # predicated store: a false predicate holds the accumulator
            if pred is None or (pred & 1):
                accum[name] = (accum[name] + (args[0] if args else 0)) & 0xFFFF
        for name, q in queues.items():
            if name in accum:
                continue
            node = g.nodes[name]
            args, pred = _split_args(in_edges[name], value)
            q.popleft()
            q.append(_eval_node(node, args, pred))
        for name in outputs:
            outputs[name].append(value[name])
    return outputs


def output_latency(g: DFG) -> Dict[str, int]:
    """Cycle arrival time at each OUTPUT node (pipeline fill latency)."""
    arrival: Dict[str, int] = {}
    for name in g.topo_order():
        node = g.nodes[name]
        preds = g.preds(name)
        base = max((arrival[p] for p in preds), default=0)
        arrival[name] = base + node.cycle_latency()
    return {n: arrival[n] for n, nd in g.nodes.items() if nd.kind == OUTPUT}


# ---------------------------------------------------------------------------
# reference-stream memo for the oracle checks
# ---------------------------------------------------------------------------
#
# equivalent()/sparse_equivalent() re-simulate the *unchanged* reference
# graph on every post-PnR verification round.  Reference streams are
# memoized by (DFG content hash, inputs hash, backend); dense entries store
# the simulated cycle count so shorter requests are served as prefixes
# (streams are prefix-stable: cycle t never depends on cycles > t).

_REF_MEMO: "OrderedDict[tuple, tuple]" = OrderedDict()
_REF_MEMO_LOCK = threading.Lock()
_REF_MEMO_MAX = 128
ref_memo_stats = {"hits": 0, "misses": 0}


def clear_ref_memo() -> None:
    with _REF_MEMO_LOCK:
        _REF_MEMO.clear()
        ref_memo_stats["hits"] = 0
        ref_memo_stats["misses"] = 0


def _inputs_key(inputs: Dict[str, Sequence[int]]) -> tuple:
    return tuple(sorted((k, tuple(v)) for k, v in inputs.items()))


def dfg_fingerprint(g: DFG) -> str:
    """Stable structural digest of a DFG (nodes + edges + flags); the
    reference keeps it in its compile-cache module, not ported yet."""
    nodes = sorted(
        (n.name, n.kind, n.op, n.width, n.latency, n.depth, n.value,
         n.input_reg, tuple(sorted((k, repr(v)) for k, v in n.meta.items())))
        for n in g.nodes.values())
    edges = sorted((e.src, e.dst, e.port, e.width) for e in g.edges)
    h = hashlib.sha256()
    h.update(repr((g.name, g.sparse, nodes, edges)).encode())
    return h.hexdigest()


def _memo_key(kind: str, g: DFG, inputs, backend: str) -> tuple:
    return (kind, dfg_fingerprint(g), _inputs_key(inputs), backend)


def _ref_dense_outputs(g: DFG, inputs, cycles: int, backend: str,
                       device=None) -> Dict[str, List[int]]:
    key = _memo_key("dense", g, inputs, backend)
    with _REF_MEMO_LOCK:
        hit = _REF_MEMO.get(key)
        if hit is not None and hit[0] >= cycles:
            _REF_MEMO.move_to_end(key)
            ref_memo_stats["hits"] += 1
            return {n: s[:cycles] for n, s in hit[1].items()}
        ref_memo_stats["misses"] += 1
    out = simulate(g, inputs, cycles, backend=backend, device=device)
    with _REF_MEMO_LOCK:
        _REF_MEMO[key] = (cycles, out)
        _REF_MEMO.move_to_end(key)
        while len(_REF_MEMO) > _REF_MEMO_MAX:
            _REF_MEMO.popitem(last=False)
    return out


def _ref_sparse_outputs(g: DFG, inputs, max_cycles: int, backend: str,
                        device=None) -> Dict[str, List[int]]:
    key = _memo_key("sparse", g, inputs, backend) + (max_cycles,)
    with _REF_MEMO_LOCK:
        hit = _REF_MEMO.get(key)
        if hit is not None:
            _REF_MEMO.move_to_end(key)
            ref_memo_stats["hits"] += 1
            return hit[1]
        ref_memo_stats["misses"] += 1
    out = simulate_sparse(g, inputs, max_cycles, backend=backend,
                          device=device)
    with _REF_MEMO_LOCK:
        _REF_MEMO[key] = (max_cycles, out)
        _REF_MEMO.move_to_end(key)
        while len(_REF_MEMO) > _REF_MEMO_MAX:
            _REF_MEMO.popitem(last=False)
    return out


def equivalent(ref: DFG, xform: DFG, inputs: Dict[str, Sequence[int]],
               n: int = 64, backend: Optional[str] = None,
               device=None) -> bool:
    """True iff ``xform`` reproduces ``ref``'s output streams modulo latency."""
    name = _dispatch_backend(backend)
    lat_r, lat_x = output_latency(ref), output_latency(xform)
    cycles = n + max(max(lat_x.values(), default=0), max(lat_r.values(), default=0)) + 1
    out_r = _ref_dense_outputs(ref, inputs, cycles, name, device)
    out_x = simulate(xform, inputs, cycles, backend=name, device=device)
    for name_, stream_r in out_r.items():
        if name_ not in out_x:
            return False
        a = stream_r[lat_r[name_]: lat_r[name_] + n]
        b = out_x[name_][lat_x[name_]: lat_x[name_] + n]
        if a != b:
            return False
    return True


# ---------------------------------------------------------------------------
# ready-valid (sparse) token simulator
# ---------------------------------------------------------------------------

def _deadlock_message(g: DFG, buf_len: Dict[Tuple[str, int], int],
                      feed_left: Dict[str, int], limit: int = 8) -> str:
    """Build the sparse-deadlock diagnostic from a quiescent marking.

    ``buf_len`` maps each ``(dst node, port)`` input buffer to its token
    count and ``feed_left`` each INPUT node to its undelivered stream
    length.  Names the stalled nodes with their starved input ports and
    full (backpressured) output buffers so FIFO-insertion bugs point at
    the offending edge, not just the graph.  Shared by the interpreter
    and the vectorized backends (the quiescent state is unique for a
    bounded-buffer Kahn network, so every backend reports the same
    marking).
    """
    in_edges = {n: sorted((e for e in g.in_edges(n) if e.port < CONTROL_PORT),
                          key=lambda e: e.port) for n in g.nodes}
    cap = {n: (g.nodes[n].depth if g.nodes[n].kind == FIFO else 1)
           for n in g.nodes}
    stalled = []
    for name in g.topo_order():
        node = g.nodes[name]
        reasons = []
        if node.kind == INPUT:
            if feed_left.get(name, 0) <= 0:
                continue
            blocked = [e for e in g.out_edges(name) if e.port < CONTROL_PORT
                       and buf_len.get((e.dst, e.port), 0) >= cap[e.dst]]
            reasons.append(f"{feed_left[name]} feed token(s) pending")
            if blocked:
                reasons.append("blocked out: " + ", ".join(
                    f"{e.dst}.p{e.port} full" for e in blocked))
        elif node.kind == CONST:
            continue
        else:
            ports = in_edges[name]
            if not ports:
                continue
            have = [buf_len.get((name, e.port), 0) for e in ports]
            if not any(have):
                continue  # idle, not stalled
            if all(have) and node.kind != OUTPUT:
                blocked = [e for e in g.out_edges(name)
                           if e.port < CONTROL_PORT
                           and buf_len.get((e.dst, e.port), 0) >= cap[e.dst]]
                if not blocked:
                    continue
                reasons.append("blocked out: " + ", ".join(
                    f"{e.dst}.p{e.port} full" for e in blocked))
            else:
                starved = [e for e, h in zip(ports, have) if h == 0]
                if starved:
                    reasons.append("starved in: " + ", ".join(
                        f"p{e.port}<-{e.src}" for e in starved))
        if reasons:
            stalled.append(f"{name}(" + "; ".join(reasons) + ")")
    pending = sum(v for v in feed_left.values() if v > 0)
    detail = ", ".join(stalled[:limit])
    if len(stalled) > limit:
        detail += f", ... (+{len(stalled) - limit} more)"
    if not detail:
        detail = "<no stalled node with tokens - check FIFO capacities>"
    return (f"{g.name}: sparse simulation deadlocked with {pending} input "
            f"token(s) pending; stalled: {detail}")


def simulate_sparse(g: DFG, inputs: Dict[str, Sequence[int]],
                    max_cycles: int = 100_000,
                    backend: Optional[str] = None,
                    device=None) -> Dict[str, List[int]]:
    """Token-level simulation with backpressure.

    Every non-FIFO node has an implicit 1-deep skid buffer per input; FIFO
    nodes have ``depth``-deep queues.  A node fires when every input port has
    a token and every successor buffer has space.  Raises on deadlock.
    ``backend`` selects the interpreter (default) or a vectorized
    fire-vector backend from :mod:`repro_torch.core.sim_vec`; ``device`` is
    read by ``torch``.
    """
    name = _dispatch_backend(backend)
    if name != "interpreter":
        from . import sim_vec
        return sim_vec.simulate_sparse_vec(g, inputs, max_cycles,
                                           backend=name, device=device)
    return _simulate_sparse_interp(g, inputs, max_cycles)


def _simulate_sparse_interp(g: DFG, inputs: Dict[str, Sequence[int]],
                            max_cycles: int) -> Dict[str, List[int]]:
    order = g.topo_order()
    in_edges = {n: sorted((e for e in g.in_edges(n) if e.port < CONTROL_PORT),
                          key=lambda e: e.port) for n in g.nodes}
    cap = {n: (g.nodes[n].depth if g.nodes[n].kind == FIFO else 1) for n in g.nodes}
    # per-(node, port) input queues
    bufs: Dict[tuple, deque] = {}
    for n in g.nodes:
        for e in in_edges[n]:
            bufs[(n, e.port)] = deque()
    feed = {n: deque(inputs.get(n, ())) for n, nd in g.nodes.items() if nd.kind == INPUT}
    outputs: Dict[str, List[int]] = {n: [] for n, nd in g.nodes.items() if nd.kind == OUTPUT}
    accum_state: Dict[str, int] = {}
    done_tokens = 0

    for _ in range(max_cycles):
        fired = False
        for name in order:
            node = g.nodes[name]
            outs = g.out_edges(name)
            if node.kind == INPUT:
                if feed[name] and all(
                        len(bufs[(e.dst, e.port)]) < cap[e.dst] for e in outs):
                    v = feed[name].popleft()
                    for e in outs:
                        bufs[(e.dst, e.port)].append(v)
                    fired = True
                continue
            if node.kind == CONST:
                for e in outs:
                    if not bufs[(e.dst, e.port)]:
                        bufs[(e.dst, e.port)].append(node.value)
                        fired = True
                continue
            ports = [bufs[(name, e.port)] for e in in_edges[name]]
            if not ports or any(not p for p in ports):
                continue
            if node.kind == OUTPUT:
                outputs[name].append(ports[0].popleft())
                done_tokens += 1
                fired = True
                continue
            if any(len(bufs[(e.dst, e.port)]) >= cap[e.dst] for e in outs):
                continue
            args, pred = [], None
            for e, p in zip(in_edges[name], ports):
                if e.port >= PRED_PORT:
                    pred = p[0]
                else:
                    args.append(p[0])
            if node.kind == MEM and node.op == "accum":
                # value-gating: a false predicate still consumes the input
                # tokens and emits the (held) accumulator value, keeping
                # the Kahn network's firing schedule predicate-independent
                if pred is None or (pred & 1):
                    v = (accum_state.get(name, 0) + args[0]) & 0xFFFF
                    accum_state[name] = v
                else:
                    v = accum_state.get(name, 0)
            else:
                v = _eval_node(node, args, pred)
            for p in ports:
                p.popleft()
            for e in outs:
                bufs[(e.dst, e.port)].append(v)
            fired = True
        if not fired:
            if all(not q for q in feed.values()):
                break  # drained
            raise RuntimeError(_deadlock_message(
                g, {k: len(q) for k, q in bufs.items()},
                {n: len(q) for n, q in feed.items()}))
    return outputs


def sparse_equivalent(ref: DFG, xform: DFG,
                      inputs: Dict[str, Sequence[int]],
                      backend: Optional[str] = None, device=None) -> bool:
    name = _dispatch_backend(backend)
    out_r = _ref_sparse_outputs(ref, inputs, 100_000, name, device)
    return out_r == simulate_sparse(xform, inputs, backend=name,
                                    device=device)
