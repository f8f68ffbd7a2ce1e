"""Benchmark applications (paper Section VIII).

Dense image-processing / ML apps (Table I, also benchmarks of [16]):
Gaussian blur, unsharp masking, camera pipeline, Harris corner detection, and
a ResNet-18 conv5_x layer.  Each builder emits one *copy* of the kernel as a
DFG; unrolling instantiates several copies (or one copy stamped by
low-unrolling duplication).  Frame sizes and unroll factors follow the paper:

    gaussian  6400x4800, unroll 12     unsharp 1536x2560, unroll 4
    camera    2560x1920, unroll 4      harris  1530x2554, unroll 2 (baseline) / 4
    resnet    conv5_x (7x7x512 out, 512 in ch, 3x3), 16 MACs/copy, 4 copies

Sparse apps (Table II, from the TACO suite [18]) are SAM-style dataflow
graphs — scanners over compressed levels, intersect/union joiners, value
loads, ALUs and reductions — with ready-valid FIFOs at the input of every
compute unit (the sparse compiler applies compute pipelining by default,
Section VIII-D).

Predicated control-flow apps (``CONTROL_APPS``) exercise the
``PRED_PORT`` band end to end: a thresholded conv with predicated
accumulate, a sel-based clip/saturate pipeline, and a bounded while-style
iterative refinement unrolled with per-lane exit predicates.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .dfg import CONST, DFG, FIFO, INPUT, MEM, OUTPUT, PE, PRED_PORT, RF


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _const(g: DFG, v: int) -> str:
    return g.add(CONST, value=v, width=16)


def _pe(g: DFG, op: str, *srcs: str, tag: str = "") -> str:
    n = g.add(PE, op=op)
    for i, s in enumerate(srcs):
        g.connect(s, n, port=i)
    return n


def _tree_reduce(g: DFG, op: str, items: List[str]) -> str:
    while len(items) > 1:
        nxt = []
        for i in range(0, len(items) - 1, 2):
            nxt.append(_pe(g, op, items[i], items[i + 1]))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def _window3x3(g: DFG, src: str, width: int, prefix: str) -> List[List[str]]:
    """3x3 window formation: two MEM line buffers + RF shift taps.

    Returns taps[row][col]; taps[r][0] is the raw row stream."""
    lb1 = g.add(MEM, name=f"{prefix}_lb1", op="delay", depth=width, latency=1)
    lb2 = g.add(MEM, name=f"{prefix}_lb2", op="delay", depth=width, latency=1)
    g.connect(src, lb1)
    g.connect(lb1, lb2)
    taps: List[List[str]] = []
    for r, row_src in enumerate([src, lb1, lb2]):
        row = [row_src]
        for c in (1, 2):
            rf = g.add(RF, name=f"{prefix}_t{r}{c}", depth=1)
            g.connect(row[-1], rf)
            row.append(rf)
        taps.append(row)
    return taps


def _conv3x3(g: DFG, taps, weights: List[List[int]], shift: int) -> str:
    prods = []
    for r in range(3):
        for c in range(3):
            w = weights[r][c]
            if w == 0:
                continue
            if w == 1:
                prods.append(taps[r][c])
            else:
                prods.append(_pe(g, "mul", taps[r][c], _const(g, w)))
    s = _tree_reduce(g, "add", prods)
    if shift:
        s = _pe(g, "shr", s, _const(g, shift))
    return s


# ---------------------------------------------------------------------------
# dense app builders (one copy each)
# ---------------------------------------------------------------------------

G3 = [[1, 2, 1], [2, 4, 2], [1, 2, 1]]
SOBEL_X = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
SOBEL_Y = [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]
BOX = [[1, 1, 1], [1, 1, 1], [1, 1, 1]]


def _signed_conv3x3(g: DFG, taps, weights, shift: int = 0) -> str:
    """Conv with +/- weights via separate add/sub trees."""
    pos, neg = [], []
    for r in range(3):
        for c in range(3):
            w = weights[r][c]
            if w == 0:
                continue
            t = taps[r][c]
            if abs(w) != 1:
                t = _pe(g, "mul", t, _const(g, abs(w)))
            (pos if w > 0 else neg).append(t)
    p = _tree_reduce(g, "add", pos) if pos else _const(g, 0)
    if neg:
        n = _tree_reduce(g, "add", neg)
        p = _pe(g, "sub", p, n)
    if shift:
        p = _pe(g, "shr", p, _const(g, shift))
    return p


def build_gaussian(copy: int, g: DFG, width: int):
    src = g.add(INPUT, name=f"in{copy}")
    taps = _window3x3(g, src, width, f"g{copy}")
    out = _conv3x3(g, taps, G3, shift=4)
    o = g.add(OUTPUT, name=f"out{copy}")
    g.connect(out, o)


def build_unsharp(copy: int, g: DFG, width: int):
    src = g.add(INPUT, name=f"in{copy}")
    taps = _window3x3(g, src, width, f"u{copy}")
    blur = _conv3x3(g, taps, G3, shift=4)
    center = taps[1][1]
    detail = _pe(g, "sub", center, blur)
    amp = _pe(g, "mul", detail, _const(g, 2))
    sharp = _pe(g, "add", center, amp)
    clamped = _pe(g, "min", _pe(g, "max", sharp, _const(g, 0)),
                  _const(g, 255))
    o = g.add(OUTPUT, name=f"out{copy}")
    g.connect(clamped, o)


def build_camera(copy: int, g: DFG, width: int):
    """Demosaic -> white balance -> 3x3 CCM -> gamma ROM -> tone curve."""
    src = g.add(INPUT, name=f"in{copy}")
    taps = _window3x3(g, src, width, f"c{copy}")
    # demosaic: horizontal/vertical neighbor averages
    gH = _pe(g, "shr", _pe(g, "add", taps[1][0], taps[1][2]), _const(g, 1))
    gV = _pe(g, "shr", _pe(g, "add", taps[0][1], taps[2][1]), _const(g, 1))
    r_ch = taps[1][1]
    g_ch = _pe(g, "shr", _pe(g, "add", gH, gV), _const(g, 1))
    b_ch = _pe(g, "shr", _pe(g, "add", taps[0][0], taps[2][2]), _const(g, 1))
    # white balance
    chans = [_pe(g, "mul", ch, _const(g, wgt))
             for ch, wgt in ((r_ch, 3), (g_ch, 2), (b_ch, 4))]
    # color correction matrix (3x3 signed)
    ccm = [[5, -1, -1], [-1, 6, -1], [-1, -1, 5]]
    corrected = []
    for row in ccm:
        pos, neg = [], []
        for ch, w in zip(chans, row):
            t = ch if abs(w) == 1 else _pe(g, "mul", ch, _const(g, abs(w)))
            (pos if w > 0 else neg).append(t)
        v = _tree_reduce(g, "add", pos)
        if neg:
            v = _pe(g, "sub", v, _tree_reduce(g, "add", neg))
        corrected.append(_pe(g, "shr", v, _const(g, 2)))
    # gamma lookup (MEM ROM) + tone curve
    outs = []
    for i, ch in enumerate(corrected):
        rom = g.add(MEM, name=f"c{copy}_gamma{i}", op="rom", latency=1,
                    meta={"table": [min(255, int((v / 255.0) ** 0.45 * 255))
                                    for v in range(256)]})
        g.connect(ch, rom)
        toned = _pe(g, "add", _pe(g, "mul", rom, _const(g, 2)), _const(g, 8))
        outs.append(toned)
    merged = _tree_reduce(g, "add", outs)   # pack to single stream
    o = g.add(OUTPUT, name=f"out{copy}")
    g.connect(merged, o)


def build_harris(copy: int, g: DFG, width: int):
    src = g.add(INPUT, name=f"in{copy}")
    taps = _window3x3(g, src, width, f"h{copy}_in")
    ix = _signed_conv3x3(g, taps, SOBEL_X, shift=1)
    iy = _signed_conv3x3(g, taps, SOBEL_Y, shift=1)
    ixx = _pe(g, "mul", ix, ix)
    iyy = _pe(g, "mul", iy, iy)
    ixy = _pe(g, "mul", ix, iy)
    sums = []
    for name, sig in (("xx", ixx), ("yy", iyy), ("xy", ixy)):
        w = _window3x3(g, sig, width, f"h{copy}_{name}")
        sums.append(_conv3x3(g, w, BOX, shift=0))
    sxx, syy, sxy = sums
    det = _pe(g, "sub", _pe(g, "mul", sxx, syy), _pe(g, "mul", sxy, sxy))
    trace = _pe(g, "add", sxx, syy)
    tr2 = _pe(g, "mul", trace, trace)
    ktr2 = _pe(g, "shr", tr2, _const(g, 4))       # k ~ 1/16
    resp = _pe(g, "sub", det, ktr2)
    thresh = _pe(g, "gt", resp, _const(g, 1000))
    o = g.add(OUTPUT, name=f"out{copy}")
    g.connect(resp, o)
    o2 = g.add(OUTPUT, name=f"corner{copy}")
    g.connect(thresh, o2)


def build_resnet(copy: int, g: DFG, width: int):
    """conv5_x tile: a 16-tap MAC tree + output-channel accumulator."""
    acts = g.add(INPUT, name=f"in{copy}")
    buf = g.add(MEM, name=f"r{copy}_abuf", op="delay", depth=1, latency=1)
    g.connect(acts, buf)
    taps = [buf]
    for i in range(15):
        rf = g.add(RF, name=f"r{copy}_t{i}", depth=1)
        g.connect(taps[-1], rf)
        taps.append(rf)
    prods = [_pe(g, "mul", t, _const(g, (7 * i + 3) % 31 + 1))
             for i, t in enumerate(taps)]
    tree = _tree_reduce(g, "add", prods)
    acc = g.add(MEM, name=f"r{copy}_acc", op="accum", latency=1)
    g.connect(tree, acc)
    relu = _pe(g, "max", acc, _const(g, 0))
    o = g.add(OUTPUT, name=f"out{copy}")
    g.connect(relu, o)


# ---------------------------------------------------------------------------
# predicated control-flow app builders
# ---------------------------------------------------------------------------

def _pred_pe(g: DFG, op: str, *srcs: str, pred: str) -> str:
    """PE with data operands plus a predicate edge in the PRED_PORT band."""
    n = g.add(PE, op=op)
    for i, s in enumerate(srcs):
        g.connect(s, n, port=i)
    g.connect(pred, n, port=PRED_PORT)
    return n


def build_thresh_conv(copy: int, g: DFG, width: int):
    """Thresholded 3x3 conv: pixels above threshold are steered through and
    accumulated (predicated store); below-threshold pixels contribute 0 and
    hold the accumulator."""
    src = g.add(INPUT, name=f"in{copy}")
    taps = _window3x3(g, src, width, f"tc{copy}")
    conv = _conv3x3(g, taps, G3, shift=4)
    above = _pe(g, "ge", conv, _const(g, 48))
    kept = _pred_pe(g, "steer", conv, pred=above)
    acc = g.add(MEM, name=f"tc{copy}_acc", op="accum", latency=1)
    g.connect(kept, acc, 0)
    g.connect(above, acc, port=PRED_PORT)
    o = g.add(OUTPUT, name=f"out{copy}")
    g.connect(kept, o)
    o2 = g.add(OUTPUT, name=f"energy{copy}")
    g.connect(acc, o2)


def build_clip_pipe(copy: int, g: DFG, width: int):
    """Data-dependent clip/saturate: an unsharp-style sharpened stream is
    clamped by comparator-driven ``sel`` merges instead of min/max — the
    canonical if/else diamond, fully predicated."""
    src = g.add(INPUT, name=f"in{copy}")
    taps = _window3x3(g, src, width, f"cl{copy}")
    blur = _conv3x3(g, taps, G3, shift=4)
    center = taps[1][1]
    detail = _pe(g, "sub", center, blur)
    amp = _pe(g, "mul", detail, _const(g, 3))
    sharp = _pe(g, "add", center, amp)
    hi, lo = _const(g, 240), _const(g, 16)
    # wrapped subtraction can leave "negative" (huge) values: saturate high
    # only in the plausible range, then low
    over = _pe(g, "gt", sharp, hi)
    capped = _pred_pe(g, "sel", hi, sharp, pred=over)
    under = _pe(g, "lt", capped, lo)
    clipped = _pred_pe(g, "sel", lo, capped, pred=under)
    o = g.add(OUTPUT, name=f"out{copy}")
    g.connect(clipped, o)


def build_refine(copy: int, g: DFG, width: int):
    """Bounded while-style iterative refinement, unrolled with exit
    predicates: each unrolled iteration nudges the estimate toward
    ``x / 3`` and a ``phi`` merge holds the value once the per-lane exit
    condition (|error| <= tol) fires — the loop body executes, the lane
    just stops updating, exactly how a CGRA predicates a data-dependent
    ``while`` with a static iteration bound."""
    src = g.add(INPUT, name=f"in{copy}")
    tol = _const(g, 2)
    y = _pe(g, "shr", src, _const(g, 2))          # initial estimate x/4
    done = None
    for _ in range(4):
        three_y = _pe(g, "add", y, _pe(g, "shl", y, _const(g, 1)))
        err = _pe(g, "sub", src, three_y)         # wrapped signed error
        mag = _pe(g, "abs", err)
        done = _pe(g, "le", mag, tol)             # exit predicate
        delta = _pe(g, "max", _pe(g, "shr", mag, _const(g, 2)),
                    _const(g, 1))
        too_big = _pe(g, "gt", three_y, src)
        moved = _pred_pe(g, "sel",
                         _pe(g, "sub", y, delta),
                         _pe(g, "add", y, delta), pred=too_big)
        y = _pred_pe(g, "phi", y, moved, pred=done)
    o = g.add(OUTPUT, name=f"out{copy}")
    g.connect(y, o)
    o2 = g.add(OUTPUT, name=f"done{copy}")
    g.connect(done, o2)


# ---------------------------------------------------------------------------
# sparse app builders (SAM-style, ready-valid)
# ---------------------------------------------------------------------------

def _fifo(g: DFG, src: str, dst: str, port: int = 0):
    f = g.add(FIFO, depth=2)
    g.connect(src, f)
    g.connect(f, dst, port=port)


def _sparse_pe(g: DFG, op: str, *srcs: str) -> str:
    """Compute unit with a FIFO on every input (sparse default)."""
    n = g.add(PE, op=op)
    for i, s in enumerate(srcs):
        _fifo(g, s, n, port=i)
    return n


def _scanner(g: DFG, ref: str, name: str) -> str:
    """Compressed-level scanner: MEM that turns refs into crd/val streams."""
    m = g.add(MEM, name=name, op="rom", latency=1,
              meta={"table": [(3 * i + 1) % 97 for i in range(64)]})
    g.connect(ref, m)
    return m


def build_vecadd(copy: int, g: DFG, width: int):
    """Vector elementwise add: two compressed streams -> union -> add."""
    ra = g.add(INPUT, name=f"refA{copy}")
    rb = g.add(INPUT, name=f"refB{copy}")
    sa1 = _scanner(g, ra, f"v{copy}_scanA")
    sb1 = _scanner(g, rb, f"v{copy}_scanB")
    union = _sparse_pe(g, "max", sa1, sb1)          # crd union
    va = _scanner(g, sa1, f"v{copy}_valA")
    vb = _scanner(g, sb1, f"v{copy}_valB")
    summed = _sparse_pe(g, "add", va, vb)
    gated = _sparse_pe(g, "and", summed, union)
    o = g.add(OUTPUT, name=f"out{copy}")
    _fifo(g, gated, o)


def build_elemmul(copy: int, g: DFG, width: int):
    """Matrix elementwise multiply: two-level intersect, then value mul."""
    ra = g.add(INPUT, name=f"refA{copy}")
    rb = g.add(INPUT, name=f"refB{copy}")
    # level 0 (rows)
    sa0 = _scanner(g, ra, f"e{copy}_scanA0")
    sb0 = _scanner(g, rb, f"e{copy}_scanB0")
    isect0 = _sparse_pe(g, "min", sa0, sb0)
    # level 1 (cols)
    sa1 = _scanner(g, isect0, f"e{copy}_scanA1")
    sb1 = _scanner(g, isect0, f"e{copy}_scanB1")
    isect1 = _sparse_pe(g, "min", sa1, sb1)
    va = _scanner(g, sa1, f"e{copy}_valA")
    vb = _scanner(g, sb1, f"e{copy}_valB")
    prod = _sparse_pe(g, "mul", va, vb)
    gated = _sparse_pe(g, "and", prod, isect1)
    o = g.add(OUTPUT, name=f"out{copy}")
    _fifo(g, gated, o)


def build_mttkrp(copy: int, g: DFG, width: int):
    """A(i,j) = sum_k sum_l B(i,k,l) * C(k,j) * D(l,j)."""
    rb_ = g.add(INPUT, name=f"refB{copy}")
    rc = g.add(INPUT, name=f"refC{copy}")
    rd = g.add(INPUT, name=f"refD{copy}")
    b_i = _scanner(g, rb_, f"m{copy}_Bi")
    b_k = _scanner(g, b_i, f"m{copy}_Bk")
    b_l = _scanner(g, b_k, f"m{copy}_Bl")
    c_k = _scanner(g, rc, f"m{copy}_Ck")
    c_j = _scanner(g, c_k, f"m{copy}_Cj")
    d_l = _scanner(g, rd, f"m{copy}_Dl")
    d_j = _scanner(g, d_l, f"m{copy}_Dj")
    isect_k = _sparse_pe(g, "min", b_k, c_k)
    isect_l = _sparse_pe(g, "min", b_l, d_l)
    vb = _scanner(g, isect_l, f"m{copy}_valB")
    vc = _scanner(g, c_j, f"m{copy}_valC")
    vd = _scanner(g, d_j, f"m{copy}_valD")
    m1 = _sparse_pe(g, "mul", vb, vc)
    m2 = _sparse_pe(g, "mul", m1, vd)
    gate = _sparse_pe(g, "and", m2, isect_k)
    red = g.add(MEM, name=f"m{copy}_reduce", op="accum", latency=1)
    _fifo(g, gate, red)
    o = g.add(OUTPUT, name=f"out{copy}")
    _fifo(g, red, o)


def build_ttv(copy: int, g: DFG, width: int):
    """A(i,j) = sum_k B(i,j,k) * c(k)."""
    rb_ = g.add(INPUT, name=f"refB{copy}")
    rc = g.add(INPUT, name=f"refC{copy}")
    b_i = _scanner(g, rb_, f"t{copy}_Bi")
    b_j = _scanner(g, b_i, f"t{copy}_Bj")
    b_k = _scanner(g, b_j, f"t{copy}_Bk")
    c_k = _scanner(g, rc, f"t{copy}_ck")
    isect = _sparse_pe(g, "min", b_k, c_k)
    vb = _scanner(g, b_k, f"t{copy}_valB")
    vc = _scanner(g, c_k, f"t{copy}_valc")
    prod = _sparse_pe(g, "mul", vb, vc)
    gate = _sparse_pe(g, "and", prod, isect)
    red = g.add(MEM, name=f"t{copy}_reduce", op="accum", latency=1)
    _fifo(g, gate, red)
    o = g.add(OUTPUT, name=f"out{copy}")
    _fifo(g, red, o)


# ---------------------------------------------------------------------------
# application specs
# ---------------------------------------------------------------------------

@dataclass
class AppSpec:
    name: str
    builder: Callable[[int, DFG, int], None]     # (copy idx, graph, line width)
    sparse: bool = False
    frame: tuple = (0, 0)                        # dense: H x W pixels
    unroll: int = 1                              # pipelined-flow unroll
    unroll_baseline: Optional[int] = None        # unpipelined-flow unroll
    work_per_output: int = 1                     # cycles per output per copy
    work_tokens: int = 0                         # sparse workload size
    line_width: int = 16                         # functional line-buffer depth

    def build(self, copies: int) -> DFG:
        g = DFG(f"{self.name}_x{copies}", sparse=self.sparse)
        for c in range(copies):
            self.builder(c, g, self.line_width)
        return g.validate()

    @property
    def iterations(self) -> int:
        if self.sparse:
            return self.work_tokens
        h, w = self.frame
        return h * w * self.work_per_output

    def iterations_for(self, copies: int) -> int:
        return max(1, self.iterations // max(1, copies))


DENSE_APPS: Dict[str, AppSpec] = {
    "gaussian": AppSpec("gaussian", build_gaussian, frame=(4800, 6400), unroll=12),
    "unsharp": AppSpec("unsharp", build_unsharp, frame=(1536, 2560), unroll=4),
    "camera": AppSpec("camera", build_camera, frame=(1920, 2560), unroll=4),
    "harris": AppSpec("harris", build_harris, frame=(1530, 2554), unroll=4,
                      unroll_baseline=2),
    "resnet": AppSpec("resnet", build_resnet, frame=(7, 7), unroll=4,
                      work_per_output=512 * 512 * 9 // 16),
}

SPARSE_APPS: Dict[str, AppSpec] = {
    "vecadd": AppSpec("vecadd", build_vecadd, sparse=True, work_tokens=250),
    "elemmul": AppSpec("elemmul", build_elemmul, sparse=True, work_tokens=600),
    "mttkrp": AppSpec("mttkrp", build_mttkrp, sparse=True, work_tokens=10200),
    "ttv": AppSpec("ttv", build_ttv, sparse=True, work_tokens=2600),
}

#: Predicated control-flow workloads.  Kept out of ``DENSE_APPS``
#: so the paper-table benchmarks and their pinned bands are untouched;
#: compiled/simulated by ``tests/test_predication.py`` and
#: ``benchmarks/control_flow.py`` (alongside straight-line baselines).
CONTROL_APPS: Dict[str, AppSpec] = {
    "thresh_conv": AppSpec("thresh_conv", build_thresh_conv,
                           frame=(1536, 2560), unroll=4),
    "clip_pipe": AppSpec("clip_pipe", build_clip_pipe,
                         frame=(1536, 2560), unroll=4),
    "refine": AppSpec("refine", build_refine, frame=(512, 512), unroll=2),
}

ALL_APPS = {**DENSE_APPS, **SPARSE_APPS, **CONTROL_APPS}
