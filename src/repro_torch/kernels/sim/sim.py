"""Wrappers of the two CUDA simulator kernels (``csrc/sim_dense.cu``,
``csrc/sim_sparse.cu``).

``sim_dense`` runs all cycles of a lowered dense DFG and ``sim_sparse`` the
ready-valid fire-vector fixpoint of a lowered sparse one, each as one
launch of one warp. They replace the jitted ``lax.scan`` and
``lax.while_loop`` of the JAX package's vectorized simulator; the sources'
headers give the bound and the design. CPU tensors go to the plain
versions (``ref.py``); a CUDA tensor launches the kernel or raises.

The program goes to the card as one int32 blob, packed here on the host,
which the kernel copies to shared memory. Its core is a lane-major
schedule: the work of a cycle (dense) or a round (sparse) cut into rounds
of 32 items, one a lane, each item a fixed-size descriptor that the lane
loads ahead of the round that runs it. Every opcode is rewritten here into
one of the kernels' 14 micro-ops (``UOPS``) over permuted operands, which
the kernels evaluate without a branch. A header of sizes and word offsets
(``DENSE_FIELDS``, ``SPARSE_FIELDS``, the kernels' header structs field for
field) travels as launch arguments.

A program whose blob and state do not fit a block's shared memory, or the
descriptors' 16-bit fields, takes the kernels' global route instead: the
same kernel keeps blob and state in a workspace in device memory, with
32-bit descriptor fields. ``dense_plan`` and ``sparse_plan`` pick the route
on the host, from the packed sizes, before any launch; each wrapper counts
its launches (``launches``) and each route's (``shared_launches``,
``global_launches``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ...core.sim_vec import _OPS
from .ref import SparseResult, sim_dense_plain, sim_sparse_plain

__all__ = ["sim_dense", "sim_sparse", "stage_plan", "SparseResult",
           "pack_dense", "pack_sparse", "dense_plan", "sparse_plan",
           "dense_launcher", "sparse_launcher", "rom_magic"]

DENSE_FIELDS = (
    "n_nodes", "n_in", "n_out", "n_const", "n_light", "n_heavy", "n_rom",
    "cycles", "stride", "blob_words", "global_route",
    "o_desc", "o_const", "o_rom", "o_table",
    "s_val", "s_ring", "s_ptr", "s_in", "s_out", "s_words")
SPARSE_FIELDS = (
    "n_buf", "n_in", "n_out", "n_rows", "n_rounds", "desc_words", "fan",
    "max_feed", "window", "refill", "max_cycles", "blob_words",
    "global_route", "o_desc", "o_binfo", "o_rom", "o_table",
    "s_p", "s_q", "s_rpa", "s_wpa", "s_data", "s_accv", "s_ocnt", "s_trash",
    "s_words")

LANES = 32
#: cycles of input (and of output) staged in shared memory at a time; the
#: kernel's kChunk
CHUNK = 32
#: sparse feeds of up to this many words are staged whole; longer ones
#: through a ring of ``2 * FEED_REFILL`` tokens a row, refilled every
#: ``FEED_REFILL`` rounds
FEED_WHOLE_WORDS = 16384
FEED_REFILL = 64
#: slot and buffer indices are 16-bit fields of the descriptors
NONE16 = 0xFFFF

#: the kernels' micro-ops (sim_ops.cuh ``Uop``): what each computes over
#: (x, y, z), masked to 16 bits
UOPS = ("add", "sub", "mul", "and", "or", "xor", "shr", "shl", "minmax",
        "abs", "gtz", "nez", "sel", "accp")
_UOP = {name: i for i, name in enumerate(UOPS)}
#: dense descriptor flags (sim_dense.cu), bits 18-23 of word 3 (of word 7
#: on the global route): x from the input staging, the result to the next
#: cycle's bank or to the output staging, a latency ring longer than one, a
#: ROM
DENSE_FLAGS = {"XIn": 1, "DNext": 2, "DOut": 4, "Ring": 8, "Rom": 16}
D_SHIFT, D_UOP_SHIFT = 18, 24
#: sparse descriptor flags (sim_sparse.cu), bits 4-11 of word 0; the ROM row
#: sits in bits 12-31
SPARSE_FLAGS = {"Rom": 1, "Acc": 2, "Valid": 4}
ROM_SHIFT = 12


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("sim")
    ptr = ctypes.c_void_p
    lib.sim_dense_launch.argtypes = [ptr] * 5
    lib.sim_dense_launch.restype = ctypes.c_int
    lib.sim_sparse_launch.argtypes = [ptr] * 7
    lib.sim_sparse_launch.restype = ctypes.c_int
    for fn, fields in (("sim_dense_header_ints", DENSE_FIELDS),
                       ("sim_sparse_header_ints", SPARSE_FIELDS)):
        got = getattr(lib, fn)()
        if got != len(fields):
            raise RuntimeError(f"{fn}() is {got}, the wrapper packs "
                               f"{len(fields)} fields")
    return lib


def _blob(sections: Sequence[Tuple[str, np.ndarray]]
          ) -> Tuple[np.ndarray, Dict[str, int]]:
    """Concatenate int32 sections, each starting on a 4-word boundary (the
    kernels load descriptors 16 bytes at a time); returns the blob and each
    section's offset."""
    offs, parts, at = {}, [], 0
    for name, arr in sections:
        arr = np.asarray(arr, dtype=np.int64).ravel()
        arr = np.concatenate([arr, np.zeros(-arr.size % 4, np.int64)])
        offs[name] = at
        parts.append(arr)
        at += arr.size
    return np.concatenate(parts).astype(np.uint32).view(np.int32), offs


def _state(at: int, sizes: Sequence[Tuple[str, int]]) -> Dict[str, int]:
    """Offsets of the shared-memory state sections that follow the blob."""
    offs = {}
    for name, n in sizes:
        offs[name] = at
        at += n
    offs["s_words"] = at
    return offs


def _header(fields, values: Dict[str, int]) -> "ctypes.Array":
    return (ctypes.c_int * len(fields))(*(int(values[f]) for f in fields))


def _smem_limit(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def _check_16(kind: str, n: int, what: str, name: str) -> None:
    """The shared route's 16-bit descriptor fields: past them, the state
    alone would need more shared memory (2**16 words: 256 KB) than a block
    has, and the plan takes the global route."""
    if n >= NONE16:
        raise ValueError(f"{name}: {n} {what} overflow the {kind} kernel's "
                         f"16-bit descriptor fields; pack it with wide=True "
                         f"(the global route)")


def _workspace(values: Dict[str, int], blob: np.ndarray,
               dev: torch.device, what: str) -> torch.Tensor:
    """The program on the card: the blob alone on the shared route; on the
    global route a workspace of ``s_words`` words that starts with it (the
    kernel zeroes the state behind it at every launch)."""
    if not values["global_route"]:
        return torch.from_numpy(blob).to(dev)
    need, free = 4 * values["s_words"], torch.cuda.mem_get_info(dev)[0]
    if need > free:
        raise ValueError(f"{what}: the program and its state need {need} "
                         f"bytes of device memory, more than the {free} "
                         f"free on this card; simulate it with "
                         f"backend='numpy'")
    ws = np.zeros(values["s_words"], np.int32)
    ws[:blob.size] = blob
    return torch.from_numpy(ws).to(dev)


def _count(fn, values: Dict[str, int]) -> None:
    fn.launches += 1
    if values["global_route"]:
        fn.global_launches += 1
    else:
        fn.shared_launches += 1


# ---------------------------------------------------------------------------
# opcodes and ROMs
# ---------------------------------------------------------------------------


def canon_op(op: int, a: Sequence[int], zero: int, one: int
             ) -> Tuple[int, int, int, int]:
    """Opcode ``op`` of ``_OPS`` over arguments ``a`` (three operand
    references) as a micro-op over permuted operands: ``(uop, x, y, z)``.
    ``zero`` and ``one`` are references that read 0 and 1. Every op is the
    interpreter's formula: ``min``/``max`` are ``z & 1 ? max : min``,
    ``gt``/``ge`` are ``x + (z & 1) > y`` and ``lt``/``le`` the same with x
    and y swapped, ``eq``/``ne`` are ``(x != y) ^ z``, and ``mux``, ``sel``,
    ``phi`` and ``steer`` one select ``z & 1 ? x : y``. A ROM is an ``add``
    of its address and zero (the kernel replaces the sum by the lookup)."""
    name = _OPS[op]
    a0, a1, a2 = a
    if name in ("zero",):
        return _UOP["add"], zero, zero, zero
    if name in ("pass", "rom"):
        return _UOP["add"], a0, zero, zero
    if name in ("add", "sub", "mul", "and", "or", "xor", "shr", "shl"):
        return _UOP[name], a0, a1, zero
    if name in ("min", "max"):
        return _UOP["minmax"], a0, a1, one if name == "max" else zero
    if name == "abs":
        return _UOP["abs"], a0, zero, zero
    if name in ("gt", "ge"):
        return _UOP["gtz"], a0, a1, one if name == "ge" else zero
    if name in ("lt", "le"):
        return _UOP["gtz"], a1, a0, one if name == "le" else zero
    if name in ("eq", "ne"):
        return _UOP["nez"], a0, a1, one if name == "eq" else zero
    if name == "mux":
        return _UOP["sel"], a1, a2, a0
    if name in ("sel", "phi"):
        return _UOP["sel"], a0, a1, a2
    if name == "steer":
        return _UOP["sel"], a0, zero, a1
    raise ValueError(f"opcode {name!r} has no dense micro-op")


def rom_magic(tab_len: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(d, m)`` of each ROM row for the kernels' modulo-free lookup: the
    entry of a 16-bit address ``a`` is ``umulhi((m * a) mod 2**32, d)``,
    which equals ``a % tab_len`` (a direct remainder by a precomputed
    reciprocal, exact for 16-bit ``a`` and ``d <= 2**16``; Lemire, Kaser
    and Kurz, "Faster remainder by direct computation", 2019). A row
    longer than 2**16 keeps ``d = 2**16``: no 16-bit address reaches past
    it, and ``a % 2**16 == a``. ``m = ceil(2**32 / d) mod 2**32``."""
    d = np.minimum(np.asarray(tab_len, dtype=np.int64), 1 << 16)
    if (d < 1).any():
        raise ValueError("a ROM row has no entries")
    m = (-(-(1 << 32) // d)) % (1 << 32)
    return d, m


def rom_index(a: np.ndarray, d: np.ndarray, m: np.ndarray) -> np.ndarray:
    """The kernels' ROM index arithmetic, in uint64 numpy."""
    a, d, m = (np.asarray(v, dtype=np.uint64) for v in (a, d, m))
    return (((m * a) & np.uint64(0xFFFFFFFF)) * d) >> np.uint64(32)


def _rom_section(table_mat: np.ndarray, tab_len: np.ndarray) -> np.ndarray:
    """[n_rom, 4]: (first table word, d, m, 0) of each ROM row."""
    d, m = rom_magic(tab_len)
    base = np.arange(len(tab_len), dtype=np.int64) * table_mat.shape[1]
    return np.column_stack([base, d, m, np.zeros_like(d)])


def _flags_word(uop: int, flags: int, rom: int) -> int:
    return uop | flags << 4 | rom << ROM_SHIFT


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------


def stage_plan(prog) -> List[Tuple[int, int]]:
    """The combinational groups of a ``DenseProgram`` cut into stages:
    ``(first, end)`` group indices of each. Groups are level-ordered; a
    stage ends before the first group that reads a slot an earlier group of
    the stage wrote, so a stage's groups may run at once."""
    stages, written, first = [], set(), 0
    for i, g in enumerate(prog.comb_groups):
        if i > first and not written.isdisjoint(g.args.ravel().tolist()):
            stages.append((first, i))
            first, written = i, set()
        written.update(g.out.tolist())
    if prog.comb_groups:
        stages.append((first, len(prog.comb_groups)))
    return stages


def pack_dense(prog, cycles: int, wide: bool = False
               ) -> Tuple[Dict[str, int], np.ndarray]:
    """Header values and int32 blob of a ``DenseProgram`` for ``sim_dense``,
    on the shared route or (``wide``) the global route.

    A cycle runs a list of rounds, one 8-word descriptor a lane: x, y and z
    as byte offsets into this cycle's bank of values (x into the input
    staging for an input), the destination's byte offset ``| flags << 18 |
    micro-op << 24``, then a ROM row, a ring word, a ring length and 0; on
    the global route word 3 is the destination's byte offset alone and
    word 7 ``flags << 18 | micro-op << 24``. Light
    rounds come first: each combinational stage of ``stage_plan`` cut into
    rounds of 32 nodes, each round followed by a ``__syncwarp()``; their
    idle lanes take the items that need no ring and no ROM, each in the
    first round after its operands are final: the next cycle's inputs, this
    cycle's outputs (to the output staging), the accumulators and the
    latency-1 nodes (to the next cycle's bank). Heavy rounds follow, one
    item a lane: the latency rings longer than one, the ROMs and whatever
    found no idle lane. Slots index a bank of ``stride`` words: the
    lowering's ``n_nodes + 1`` (the last reads 0), then a slot that reads 1
    and one that takes the writes of idle lanes. The light rounds end with
    a copy of the first, which the last prefetches for the next cycle.
    Checks that the lowering has the canonical slot layout (inputs, seq
    heads, accumulators, constants, then the groups in order)."""
    return _pack_dense(prog, cycles, lambda words, fits16: wide)


def dense_plan(prog, cycles: int, smem_limit: int
               ) -> Tuple[Dict[str, int], np.ndarray]:
    """``pack_dense`` on the route the program fits, packed once: the shared
    route if its slots fit the 16-bit fields and its blob and state
    ``smem_limit`` bytes of shared memory, else the global route."""
    return _pack_dense(prog, cycles, lambda words, fits16: (
        not fits16 or 4 * words > smem_limit))


def _pack_dense(prog, cycles: int, route) -> Tuple[Dict[str, int],
                                                   np.ndarray]:
    """``pack_dense``'s work; ``route(s_words, fits16)`` picks the global
    route from the program's words of blob and state (the same on both
    routes) and whether its slots fit the shared route's 16-bit fields."""
    n = prog.n_nodes
    n_in, n_seq, n_acc = (len(prog.input_pos), len(prog.seq_pos),
                          len(prog.accum_pos))
    n_out, n_const = len(prog.output_pos), len(prog.const_pos)
    comb_out = (np.concatenate([g.out for g in prog.comb_groups])
                if prog.comb_groups else np.zeros(0, np.int64))
    comb_base = n_in + n_seq + n_acc + n_const
    canonical = (
        np.array_equal(prog.input_pos, np.arange(n_in))
        and np.array_equal(prog.seq_pos, n_in + np.arange(n_seq))
        and np.array_equal(prog.accum_pos, n_in + n_seq + np.arange(n_acc))
        and np.array_equal(comb_out, comb_base + np.arange(len(comb_out))))
    if not canonical:
        raise ValueError(f"{prog.name}: the lowering's slot layout is not "
                         f"canonical; sim_dense cannot run it")
    zero, one, idle = n, n + 1, n + 2
    stride = n + 3
    ring_off = np.concatenate([[0], np.cumsum(prog.seq_lat)])
    ring_words = int(ring_off[-1])
    fits16 = stride < NONE16 and ring_words + LANES < NONE16
    # an item: (uop, x, y, z, dest, flags, rom row, ring word, ring length)
    light: List[List] = []
    ready: Dict[int, int] = {}          # comb slot -> first round it is final
    for a, b in stage_plan(prog):
        nodes = [(g.op, g.args[i], int(g.out[i]))
                 for g in prog.comb_groups[a:b] for i in range(len(g.out))]
        for at in range(0, len(nodes), LANES):
            light.append([(*canon_op(op, [int(v) for v in args], zero, one),
                           dest, 0, 0, 0, 1)
                          for op, args, dest in nodes[at:at + LANES]])
        for _, _, dest in nodes:
            ready[dest] = len(light)

    def earliest(*slots) -> int:
        return max([ready.get(int(v), 0) for v in slots] + [0])

    flexible, heavy = [], []   # (earliest round, item); heavy-round items
    for i in range(n_in):
        flexible.append((0, (_UOP["add"], i * CHUNK, zero, zero, i,
                             DENSE_FLAGS["XIn"] | DENSE_FLAGS["DNext"], 0, 0,
                             1)))
    for o in range(n_out):
        pos = int(prog.output_pos[o])
        flexible.append((earliest(pos), (_UOP["add"], pos, zero, zero,
                                         o * CHUNK, DENSE_FLAGS["DOut"], 0,
                                         0, 1)))
    seq_items = {}
    for g in prog.seq_groups:
        for i in range(len(g.out)):
            seq_items[int(g.out[i])] = (g.op, [int(v) for v in g.args[i]],
                                        max(int(g.rom_rows[i]), 0))
    for j in range(n_seq):
        op, args, rom = seq_items[j]
        lat = int(prog.seq_lat[j])
        flags = DENSE_FLAGS["DNext"]
        if _OPS[op] == "rom":
            flags |= DENSE_FLAGS["Rom"]
        ring, length = 0, 1
        if lat > 1:
            flags |= DENSE_FLAGS["Ring"]
            ring, length = int(ring_off[j]), lat
        it = (*canon_op(op, args, zero, one), n_in + j, flags, rom, ring,
              length)
        if flags & (DENSE_FLAGS["Rom"] | DENSE_FLAGS["Ring"]):
            heavy.append(it)
        else:
            flexible.append((earliest(*args), it))
    for k in range(n_acc):
        cur, src = int(prog.accum_pos[k]), int(prog.accum_src[k])
        if prog.accum_pmask[k]:
            pred = int(prog.accum_pred[k])
            it = (_UOP["accp"], cur, src, pred)
        else:
            pred, it = zero, (_UOP["add"], cur, src, zero)
        flexible.append((earliest(src, pred),
                         (*it, cur, DENSE_FLAGS["DNext"], 0, 0, 1)))
    for first, it in flexible:          # the first idle lane from `first`
        spot = next((r for r in range(first, len(light))
                     if len(light[r]) < LANES), None)
        if spot is None:
            heavy.append(it)
        else:
            light[spot].append(it)
    heavy_rounds = [heavy[at:at + LANES]
                    for at in range(0, len(heavy), LANES)]

    def fields(rounds):
        """(x, y, z, dest, flags << 18 | micro-op << 24, rom, ring word,
        ring length) of each lane of each round."""
        out = []
        for rnd in rounds:
            for lane, it in enumerate(rnd + [None] * (LANES - len(rnd))):
                uop, x, y, z, dest, flags, rom, ring, length = it or (
                    _UOP["add"], zero, zero, zero, idle, 0, 0, 0, 1)
                if not flags & DENSE_FLAGS["Ring"]:
                    ring, length = ring_words + lane, 1   # a word a lane
                out.append((x, y, z, dest,
                            flags << D_SHIFT | uop << D_UOP_SHIFT, rom,
                            ring, length))
        return out

    # the light rounds' list ends with a copy of its first round, which the
    # last one prefetches for the next cycle
    raw = np.array(fields(light + light[:1]) + fields(heavy_rounds),
                   dtype=np.int64).reshape(-1, 8)
    const = (np.column_stack([prog.const_pos, prog.const_vals])
             if n_const else np.zeros(0))

    def blob_of(wide):
        desc = np.zeros_like(raw)
        desc[:, :4] = 4 * raw[:, :4]          # byte offsets
        desc[:, 4:7] = raw[:, 5:]
        if wide:
            desc[:, 7] = raw[:, 4]
        else:
            desc[:, 3] |= raw[:, 4]
        return _blob([("o_desc", desc), ("o_const", const),
                      ("o_rom", _rom_section(prog.table_mat, prog.tab_len)),
                      ("o_table", prog.table_mat)])

    blob, offs = blob_of(False)          # sizes are the same on both routes
    state = _state(blob.size, [
        ("s_val", 2 * stride), ("s_ring", ring_words + LANES),
        ("s_ptr", LANES * len(heavy_rounds)), ("s_in", 2 * n_in * CHUNK),
        ("s_out", 2 * n_out * CHUNK)])
    wide = bool(route(state["s_words"], fits16))
    if wide:
        blob, _ = blob_of(True)
    else:
        _check_16("sim_dense", stride, "value slots", prog.name)
        _check_16("sim_dense", ring_words + LANES, "ring words", prog.name)
    values = dict(
        n_nodes=n, n_in=n_in, n_out=n_out, n_const=n_const,
        n_light=len(light), n_heavy=len(heavy_rounds),
        n_rom=sum(bool(it[5] & DENSE_FLAGS["Rom"]) for it in heavy),
        cycles=cycles, stride=stride, blob_words=blob.size,
        global_route=int(wide), **offs, **state)
    return values, blob


def dense_launcher(prog, in_mat: torch.Tensor, cycles: int):
    """Pack and upload a ``DenseProgram`` for ``sim_dense`` on ``in_mat``'s
    card, on the route ``dense_plan`` picks: returns ``(out, launch)``,
    where each ``launch()`` runs the kernel once into ``out`` [n_out,
    cycles] (so a timing loop launches with no host work between the
    kernels)."""
    dev = in_mat.device
    values, blob = dense_plan(prog, cycles, _smem_limit(dev))
    blob_t = _workspace(values, blob, dev, prog.name)
    out = torch.empty((len(prog.output_pos), cycles), dtype=torch.int64,
                      device=dev)
    in_t = in_mat.to(torch.int64).contiguous()
    hdr = _header(DENSE_FIELDS, values)
    lib = _kernel_lib()

    def launch():
        err = lib.sim_dense_launch(
            hdr, blob_t.data_ptr(), in_t.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"sim_dense launch failed with CUDA error "
                               f"{err}")
        _count(sim_dense, values)

    return out, launch


def sim_dense(prog, in_mat: torch.Tensor, cycles: int) -> torch.Tensor:
    """All ``cycles`` of a ``DenseProgram`` (``repro_torch.core.sim_vec.
    lower_dense``): ``in_mat`` [n_in, cycles] of values in [0, 0xFFFF] ->
    the outputs [n_out, cycles], int64 on ``in_mat``'s device.

    CPU tensors go to the plain version. A CUDA ``in_mat`` launches the
    kernel (one launch, one warp), on the global route where the program
    does not fit a block's shared memory or the 16-bit fields; a program
    larger than the card's free memory raises ``ValueError``.
    """
    if tuple(in_mat.shape) != (len(prog.input_pos), cycles):
        raise ValueError(f"in_mat {tuple(in_mat.shape)}, want "
                         f"{(len(prog.input_pos), cycles)}")
    if in_mat.device.type == "cpu":
        return sim_dense_plain(prog, in_mat, cycles)
    if in_mat.device.type != "cuda":
        raise ValueError(f"sim_dense runs on cuda or cpu, not {in_mat.device}")
    out, launch = dense_launcher(prog, in_mat, cycles)
    launch()
    return out


sim_dense.launches = sim_dense.shared_launches = 0
sim_dense.global_launches = 0


# ---------------------------------------------------------------------------
# sparse
# ---------------------------------------------------------------------------


def _selector(src: int) -> int:
    """``__byte_perm`` selector that moves operand source ``src`` (0-2: the
    head of input slot 0-2, 3: the item's constant) to the low half."""
    return (2 * src) | (2 * src + 1) << 4


def _sparse_fits16(prog) -> bool:
    n_tot = prog.n_buf + len(prog.input_names)
    return (n_tot + 2 < NONE16 and len(prog.output_names) < NONE16
            and int(np.max(prog.cap, initial=1)) < NONE16)


def pack_sparse(prog, feed_shape: Tuple[int, int], max_cycles: int,
                wide: bool = False) -> Tuple[Dict[str, int], np.ndarray]:
    """Header values and int32 blob of a ``SparseProgram`` for
    ``sim_sparse``, on the shared route or (``wide``) the global route.

    Buffers are the lowering's ``n_buf``, one a feed row (``n_buf + j``
    for input ``j``, its tokens staged in shared memory), and two dummies:
    an absent input reads buffer ``n_tot`` (never empty, its head 0) and an
    absent output buffer ``n_tot + 1`` (never full); nothing writes either.
    Items are the evaluable nodes that have inputs (the others never fire),
    the OUTPUTs, the INPUTs and one a CONST-fed buffer, cut into rounds of
    32, one a lane; each round every item decides, evaluates and pops and
    pushes its own buffers. Descriptor (``desc_words`` words): ``uop |
    flags << 4 | rom << 12``; ``in0 | in1 << 16``; ``in2 | sink << 16``
    (the OUTPUT's index, ``n_out`` for none); the ``__byte_perm`` selectors
    of x and y; z's selector ``| k << 16`` (the item's constant: 1, a
    CONST's value, 0; an accumulator's state replaces it); then ``fan``
    (at least 4) output words ``buffer | limit << 16`` (the capacity, 1 for
    a CONST's refill of an empty buffer). The global route's wide
    descriptor gives each field a word: the flags word, in0, in1, in2, the
    sink, the selectors of x and y, z's selector ``| k << 16``, 0, then
    ``fan`` buffers and ``fan`` limits. ``binfo`` holds each buffer's first
    data word and capacity."""
    n_ev, n_in = len(prog.ev_names), len(prog.input_names)
    n_out, n_buf = len(prog.output_names), prog.n_buf
    rows, max_feed = feed_shape
    n_tot = n_buf + n_in
    d_in, d_out = n_tot, n_tot + 1
    if not wide:
        _check_16("sim_sparse", n_tot + 2, "buffers", prog.name)
    fan = max(4, prog.ev_out.shape[1], prog.in_out.shape[1])
    head = 8 + fan if wide else 5
    desc_words = head + fan + (-(head + fan) % 4)
    # feed rows staged whole, or through a ring refilled ahead of fptr
    if n_in * max_feed <= FEED_WHOLE_WORDS:
        window, refill = max_feed, 0
    else:
        window, refill = 2 * FEED_REFILL, FEED_REFILL
    flag = SPARSE_FLAGS

    def encode(w0, ins, sink, selxy, selzk, outs):
        outs = list(outs) + [(d_out, 1)] * (fan - len(outs))
        if wide:
            words = ([w0, *ins, sink, selxy, selzk, 0]
                     + [b for b, _ in outs] + [lim for _, lim in outs])
        else:
            words = ([w0, ins[0] | ins[1] << 16, ins[2] | sink << 16, selxy,
                      selzk] + [b | lim << 16 for b, lim in outs])
        return words + [0] * (desc_words - len(words))

    def item(uop, srcs, ins, outs, kval, flags, sink=n_out, rom=0):
        """srcs: x, y, z sources (0-2 an input slot, 3 the constant, 'z'
        a zero: an absent input slot, else the constant set to 0)."""
        ins = list(ins) + [d_in] * (3 - len(ins))
        if "z" in srcs:
            free = [k for k in range(3) if ins[k] == d_in]
            if free:
                zero_src = free[0]
            else:
                assert 3 not in srcs and not flags & flag["Acc"], \
                    "no zero source"
                zero_src, kval = 3, 0
            srcs = [zero_src if v == "z" else v for v in srcs]
        sel = [_selector(v) for v in srcs]
        return encode(_flags_word(uop, flags | flag["Valid"], rom), ins,
                      sink, sel[0] | sel[1] << 16, sel[2] | kval << 16, outs)

    items = []
    cap = prog.cap
    for i in range(n_ev):
        ins = [int(b) for b, m in zip(prog.ev_in[i], prog.ev_in_mask[i]) if m]
        if not ins:
            continue
        outs = [(int(b), int(cap[b])) for b, m in
                zip(prog.ev_out[i], prog.ev_out_mask[i]) if m]
        name = _OPS[int(prog.ev_op[i])]
        flags, rom = 0, 0
        if name == "acc":           # state + a0
            uop, srcs, kval, flags = _UOP["add"], [3, 0, "z"], 0, flag["Acc"]
        elif name == "accp":        # a1 & 1 ? state + a0 : state
            uop, srcs, kval, flags = _UOP["accp"], [3, 0, 1], 0, flag["Acc"]
        else:
            uop, *srcs = canon_op(int(prog.ev_op[i]), [0, 1, 2], "z", 3)
            kval = 1
            if name == "rom":
                flags, rom = flag["Rom"], int(prog.ev_rom[i])
        # slots past a node's inputs read 0 in the plain version
        srcs = ["z" if isinstance(v, int) and v < 3 and v >= len(ins)
                else v for v in srcs]
        items.append(item(uop, srcs, ins, outs, kval, flags, rom=rom))
    for o in range(n_out):
        items.append(item(_UOP["add"], [0, "z", "z"], [int(prog.out_buf[o])],
                          [], 1, 0, sink=o))
    for j in range(n_in):
        outs = [(int(b), int(cap[b])) for b, m in
                zip(prog.in_out[j], prog.in_out_mask[j]) if m]
        items.append(item(_UOP["add"], [0, "z", "z"], [n_buf + j], outs, 1,
                          0))
    for b, v in zip(prog.const_buf, prog.const_val):
        items.append(item(_UOP["add"], [3, "z", "z"], [], [(int(b), 1)],
                          int(v), 0))
    n_rounds = -(-len(items) // LANES)
    idle = encode(0, [d_in] * 3, n_out, 0, 0, [])
    items += [idle] * (n_rounds * LANES - len(items))
    max_cap = prog.max_cap
    zero_word = n_buf * max_cap + n_in * window      # the dummies' data
    binfo = [(b * max_cap, int(cap[b])) for b in range(n_buf)]
    binfo += [(n_buf * max_cap + j * window, window) for j in range(n_in)]
    binfo += [(zero_word, 1), (zero_word, 1)]
    blob, offs = _blob([
        ("o_desc", np.array(items, dtype=np.int64)),
        ("o_binfo", np.array(binfo, dtype=np.int64)),
        ("o_rom", _rom_section(prog.table_mat, prog.tab_len)),
        ("o_table", prog.table_mat)])
    state = _state(blob.size, [
        ("s_p", 2 * (n_tot + 2)), ("s_q", 2 * (n_tot + 2)),
        ("s_rpa", n_tot + 2), ("s_wpa", n_tot + 2),
        ("s_data", zero_word + 1), ("s_accv", n_rounds * LANES),
        ("s_ocnt", n_out + 1), ("s_trash", LANES)])
    values = dict(
        n_buf=n_buf, n_in=n_in, n_out=n_out, n_rows=rows, n_rounds=n_rounds,
        desc_words=desc_words, fan=fan, max_feed=max_feed, window=window,
        refill=refill, max_cycles=max_cycles, blob_words=blob.size,
        global_route=int(wide), **offs, **state)
    return values, blob


def sparse_plan(prog, feed_shape: Tuple[int, int], max_cycles: int,
                smem_limit: int) -> Tuple[Dict[str, int], np.ndarray]:
    """``pack_sparse`` on the route the program fits: the shared route if
    its buffers fit the 16-bit fields and its blob and state ``smem_limit``
    bytes of shared memory, else the global route (its wide descriptors
    make it a second pack)."""
    if _sparse_fits16(prog):
        values, blob = pack_sparse(prog, feed_shape, max_cycles)
        if 4 * values["s_words"] <= smem_limit:
            return values, blob
    return pack_sparse(prog, feed_shape, max_cycles, wide=True)


def sparse_launcher(prog, feed: torch.Tensor, frem: torch.Tensor,
                    max_cycles: int):
    """Pack and upload a ``SparseProgram`` for ``sim_sparse`` on ``feed``'s
    card, on the route ``sparse_plan`` picks: returns ``(result,
    launch)``, where each ``launch()`` runs the kernel once into
    ``result``, a :class:`SparseResult`."""
    dev = feed.device
    rows, n_out = feed.shape[0], max(1, len(prog.output_names))
    values, blob = sparse_plan(prog, tuple(feed.shape), max_cycles,
                               _smem_limit(dev))
    blob_t = _workspace(values, blob, dev, prog.name)
    feed_t = feed.to(torch.int64).contiguous()
    frem_t = frem.to(device=dev, dtype=torch.int64).contiguous()
    outm = torch.empty((n_out, max_cycles), dtype=torch.int64, device=dev)
    state = torch.empty(prog.n_buf + rows + n_out + 2, dtype=torch.int64,
                        device=dev)
    blen, frem_out, ocnt, flags = state.split([prog.n_buf, rows, n_out, 2])
    result = SparseResult(blen, frem_out, outm, ocnt, flags[0], flags[1])
    hdr = _header(SPARSE_FIELDS, values)
    lib = _kernel_lib()

    def launch():
        err = lib.sim_sparse_launch(
            hdr, blob_t.data_ptr(), feed_t.data_ptr(), frem_t.data_ptr(),
            outm.data_ptr(), state.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"sim_sparse launch failed with CUDA error "
                               f"{err}")
        _count(sim_sparse, values)

    return result, launch


def sim_sparse(prog, feed: torch.Tensor, frem: torch.Tensor,
               max_cycles: int) -> SparseResult:
    """The fire-vector fixpoint of a ``SparseProgram`` (``repro_torch.core.
    sim_vec.lower_sparse``) from ``feed`` [n_in (at least 1), max_feed] and
    ``frem`` (tokens of each feed row), to quiescence or ``max_cycles``
    rounds. Returns a :class:`SparseResult` of int64 tensors on ``feed``'s
    device.

    CPU tensors go to the plain version. A CUDA ``feed`` launches the kernel
    (one launch, one warp), on the global route where the program does not
    fit a block's shared memory or the 16-bit fields; a program larger than
    the card's free memory raises ``ValueError``.
    """
    if feed.dim() != 2 or frem.shape != (feed.shape[0],):
        raise ValueError(f"feed {tuple(feed.shape)}, frem "
                         f"{tuple(frem.shape)}")
    if feed.shape[0] < len(prog.input_names):
        raise ValueError(f"feed has {feed.shape[0]} rows for "
                         f"{len(prog.input_names)} inputs")
    if feed.device.type == "cpu":
        return sim_sparse_plain(prog, feed, frem, max_cycles)
    if feed.device.type != "cuda":
        raise ValueError(f"sim_sparse runs on cuda or cpu, not {feed.device}")
    result, launch = sparse_launcher(prog, feed, frem, max_cycles)
    launch()
    return result


sim_sparse.launches = sim_sparse.shared_launches = 0
sim_sparse.global_launches = 0
