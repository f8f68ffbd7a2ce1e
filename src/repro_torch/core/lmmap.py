"""Lower LM transformer-block compute onto Cascade CGRA dataflow graphs.

The assigned architectures are LM transformers; the paper's toolkit compiles
*dataflow graphs* onto a CGRA.  This bridge lowers the inner-loop tile of
each architecture family to a 16-bit fixed-point Cascade DFG, so every
Cascade pass (compute pipelining, broadcast pipelining, placement alpha,
post-PnR register insertion, sparse FIFO insertion) runs on real LM compute
shapes:

  attention families  -> q.k dot tile + exp-LUT softmax tile + p.v accumulate
                         (the paper's ResNet benchmark generalized to
                         attention arithmetic: MAC trees + ROM nonlinearity)
  ssm / hybrid        -> recurrent state-update tile
                         s' = decay*s + k*v (MEM accumulator + multipliers) —
                         the rwkv6/mamba2 token recurrence
  moe                 -> top-1 router (compare/mux argmax tree) feeding a
                         READY-VALID expert FFN tile: data-dependent token
                         flow, i.e. the paper's *sparse* pipelining path

Each lowering is wrapped in an AppSpec so ``CascadeCompiler`` treats it like
any other benchmark app; `benchmarks/lm_lowering.py` reports unpipelined vs
fully-pipelined CP/EDP per assigned architecture.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

from .apps import AppSpec
from .dfg import CONST, DFG, FIFO, INPUT, MEM, OUTPUT, PE, PRED_PORT, RF


def _const(g: DFG, v: int) -> str:
    return g.add(CONST, value=v, width=16)


def _pe(g: DFG, op: str, *srcs: str) -> str:
    n = g.add(PE, op=op)
    for i, s in enumerate(srcs):
        g.connect(s, n, port=i)
    return n


def _tree(g: DFG, op: str, items: List[str]) -> str:
    while len(items) > 1:
        nxt = [_pe(g, op, items[i], items[i + 1])
               for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


EXP_LUT = [min(255, int(math.exp(-i / 16.0) * 255)) for i in range(256)]


# ---------------------------------------------------------------------------
# family lowerings (one tile copy each)


def _attention_tile(copy: int, g: DFG, taps: int):
    """One attention output lane: score = q.k over `taps` channels,
    p = expLUT(max - score), out += p * v (streaming accumulate)."""
    q = [g.add(INPUT, name=f"q{copy}_{i}") for i in range(taps)]
    k = [g.add(INPUT, name=f"k{copy}_{i}") for i in range(taps)]
    v = g.add(INPUT, name=f"v{copy}")
    prods = [_pe(g, "mul", q[i], k[i]) for i in range(taps)]
    score = _pe(g, "shr", _tree(g, "add", prods), _const(g, 4))
    # streaming softmax: running max (MEM max-accumulate modeled as max PE
    # with RF feedback-free approximation: max against a broadcast constant
    # bias), exp LUT, then p*v accumulate
    m = _pe(g, "max", score, _const(g, 64))
    diff = _pe(g, "sub", m, score)
    rom = g.add(MEM, name=f"exp{copy}", op="rom", latency=1,
                meta={"table": EXP_LUT})
    g.connect(diff, rom)
    pv = _pe(g, "mul", rom, v)
    acc = g.add(MEM, name=f"acc{copy}", op="accum", latency=1)
    g.connect(pv, acc)
    out = g.add(OUTPUT, name=f"out{copy}")
    g.connect(acc, out)


def _ssm_tile(copy: int, g: DFG, lanes: int):
    """Recurrent state-update lanes: s' = (w * s_in + k * v) per channel,
    plus the output contraction r . s' — the rwkv6/mamba2 inner loop.

    The token recurrence is cut at the state boundary (state-in as an INPUT
    stream, state-out as an OUTPUT): on hardware the MEM-tile schedule
    stitches s_out(t) -> s_in(t+1), exactly how the statically-scheduled
    memory controllers of the target CGRA realize loop-carried state.  The
    compiled DFG stays a DAG, as every Cascade pass requires."""
    outs = []
    r = [g.add(INPUT, name=f"r{copy}_{i}") for i in range(lanes)]
    for i in range(lanes):
        w = g.add(INPUT, name=f"w{copy}_{i}")
        k = g.add(INPUT, name=f"k{copy}_{i}")
        v = g.add(INPUT, name=f"v{copy}_{i}")
        s_in = g.add(INPUT, name=f"sin{copy}_{i}")
        buf = g.add(MEM, name=f"s{copy}_{i}", op="delay", depth=1, latency=1)
        g.connect(s_in, buf)
        decayed = _pe(g, "mul", w, buf)
        kv = _pe(g, "mul", k, v)
        s_new = _pe(g, "add", decayed, kv)
        s_out = g.add(OUTPUT, name=f"sout{copy}_{i}")
        g.connect(s_new, s_out)
        outs.append(_pe(g, "mul", r[i], s_new))
    y = _pe(g, "shr", _tree(g, "add", outs), _const(g, 4))
    o = g.add(OUTPUT, name=f"out{copy}")
    g.connect(y, o)


def _moe_tile(copy: int, g: DFG, experts: int, taps: int,
              predicated: bool = False):
    """Sparse (ready-valid) MoE tile: top-1 argmax router over `experts`
    scores, mux-selected expert weight row, FFN MAC lane behind FIFOs.

    ``predicated=True`` routes the argmax through ``sel`` merges with the
    comparator on a ``PRED_PORT``-band predicate edge instead of mux data
    ports — same function, exercising the predicated IR path.
    Off by default so existing lm app fingerprints are unchanged.
    """
    x = [g.add(INPUT, name=f"x{copy}_{i}") for i in range(taps)]
    scores = [g.add(INPUT, name=f"s{copy}_{e}") for e in range(experts)]
    wrows = [g.add(INPUT, name=f"wr{copy}_{e}") for e in range(experts)]

    def fifo(src):
        f = g.add(FIFO, depth=2)
        g.connect(src, f)
        return f

    def pick(cond, a, b):
        if not predicated:
            return _pe(g, "mux", cond, a, b)
        n = g.add(PE, op="sel")
        g.connect(a, n, port=0)
        g.connect(b, n, port=1)
        g.connect(cond, n, port=PRED_PORT)
        return n

    # argmax tree: carry (best_score, best_row) pairs through cmp+sel/mux
    best_s, best_w = fifo(scores[0]), fifo(wrows[0])
    for e in range(1, experts):
        se, we = fifo(scores[e]), fifo(wrows[e])
        gt = _pe(g, "gt", se, best_s)
        best_s = pick(gt, se, best_s)
        best_w = pick(gt, we, best_w)
    # expert FFN MAC lane: sum_i x_i * w (row broadcast), relu
    prods = [_pe(g, "mul", fifo(x[i]), best_w) for i in range(taps)]
    acc = _pe(g, "shr", _tree(g, "add", prods), _const(g, 4))
    y = _pe(g, "max", acc, _const(g, 0))        # relu
    o = g.add(OUTPUT, name=f"out{copy}")
    g.connect(y, o)


# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _BlockTileBuilder:
    """Picklable builder for ``lower_block`` app specs.

    ``compile_batch(backend="process")`` ships job specs to worker
    processes, so the builder must serialize — a closure over ``cfg``
    wouldn't.  All lowering parameters are captured as plain fields.
    """
    family: str
    taps: int
    experts: int = 0
    predicated: bool = False

    def __call__(self, copy: int, g: DFG, width: int) -> None:
        if self.family in ("ssm", "hybrid"):
            # 4 state lanes/copy: 5 input streams per lane is IO-bound on
            # the 64-IO-tile Amber fabric
            _ssm_tile(copy, g, max(2, self.taps // 2))
        elif self.family == "moe":
            _moe_tile(copy, g, experts=self.experts, taps=self.taps,
                      predicated=self.predicated)
        else:
            _attention_tile(copy, g, self.taps)


def lower_block(cfg, taps: int = 8, unroll: int = 2,
                predicated: bool = False) -> AppSpec:
    """AppSpec for one tile of `cfg`'s block compute on the Amber CGRA.

    tokens-per-frame is scaled so runtimes are comparable across archs:
    one "frame" = 4096 tokens x (d_model / taps) lanes of work per copy.
    ``predicated`` switches the MoE router's argmax to ``sel`` merges on
    predicate edges (off by default — fingerprints unchanged).
    """
    fam = cfg.family
    work = (4096, max(1, cfg.d_model // taps))
    if fam == "moe":
        build = _BlockTileBuilder(fam, taps,
                                  experts=min(8, cfg.num_experts),
                                  predicated=predicated)
        return AppSpec(f"lm_{cfg.name}", build, sparse=True,
                       work_tokens=work[0] * work[1] // 64)
    return AppSpec(f"lm_{cfg.name}", _BlockTileBuilder(fam, taps),
                   frame=work, unroll=unroll)
