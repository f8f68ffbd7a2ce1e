"""Wrappers of the two CUDA simulator kernels (``csrc/sim_dense.cu``,
``csrc/sim_sparse.cu``).

``sim_dense`` runs all cycles of a lowered dense DFG and ``sim_sparse`` the
ready-valid fire-vector fixpoint of a lowered sparse one, each as one
launch of one thread block. They replace the jitted ``lax.scan`` and
``lax.while_loop`` of the JAX package's vectorized simulator; the sources'
headers give the bound and the design. CPU tensors go to the plain
versions (``ref.py``); a CUDA tensor launches the kernel or raises.

The program goes to the card as one int32 blob: its index tables, packed
here on the host, which the kernel copies to shared memory. A header of
sizes and word offsets (``DENSE_FIELDS``, ``SPARSE_FIELDS``, the kernels'
header structs field for field) travels as launch arguments.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from .ref import SparseResult, sim_dense_plain, sim_sparse_plain

__all__ = ["sim_dense", "sim_sparse", "stage_plan", "SparseResult",
           "pack_dense", "pack_sparse"]

DENSE_FIELDS = (
    "n_nodes", "n_in", "n_out", "n_seq", "n_acc", "n_const", "n_comb",
    "comb_base", "n_stages", "max_tab", "cycles", "chunk", "threads",
    "blob_words",
    "o_comb", "o_stage", "o_seq", "o_seq_lat", "o_ring_off", "o_acc",
    "o_out_pos", "o_const", "o_table", "o_tab_len",
    "s_val", "s_ring", "s_ptr", "s_acc", "s_in", "s_words")
SPARSE_FIELDS = (
    "n_buf", "max_cap", "n_ev", "fan", "n_in", "fan_in", "n_out", "max_tab",
    "n_rows", "max_feed", "max_cycles", "threads", "blob_words",
    "o_cap", "o_ev", "o_ev_out", "o_in_out", "o_out_buf", "o_buf_src_ev",
    "o_buf_src_in", "o_buf_cons_ev", "o_buf_cons_out", "o_buf_const",
    "o_table", "o_tab_len",
    "s_buf", "s_blen", "s_brp", "s_fire", "s_v", "s_accv", "s_tok",
    "s_fptr", "s_frem", "s_ocnt", "s_words")

#: cycles of input staged in shared memory at a time
CHUNK = 32
MAX_THREADS = 512


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


def _threads(width: int) -> int:
    return min(MAX_THREADS, 32 * max(1, -(-width // 32)))


def _blob(sections: Sequence[Tuple[str, np.ndarray]]
          ) -> Tuple[np.ndarray, Dict[str, int]]:
    """Concatenate int32 sections; returns the blob and each one's offset."""
    offs, parts, at = {}, [], 0
    for name, arr in sections:
        arr = np.asarray(arr, dtype=np.int64).ravel()
        offs[name] = at
        parts.append(arr)
        at += arr.size
    return np.concatenate(parts).astype(np.int32), offs


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


def _check_smem(kind: str, words: int, dev: torch.device, what: str) -> None:
    need = 4 * words
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if need > limit:
        raise ValueError(
            f"{what}: the {kind} kernel needs {need} bytes of shared memory "
            f"for its program and state, more than the {limit} a block of "
            f"this card can have; simulate it with backend='numpy'")


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


def _node_rows(groups) -> np.ndarray:
    """[nodes, 4] descriptors, in group order: op | rom row << 8, 3 slots."""
    rows = [np.column_stack([g.op + (np.maximum(g.rom_rows, 0) << 8),
                             g.args]) for g in groups if len(g.out)]
    return (np.concatenate(rows) if rows
            else np.zeros((0, 4), dtype=np.int64))


def pack_dense(prog, cycles: int) -> Tuple[Dict[str, int], np.ndarray]:
    """Header values and int32 blob of a ``DenseProgram`` for ``sim_dense``.
    Checks that the lowering has the canonical slot layout the kernel's
    present phase writes (inputs, seq heads, accumulators, constants, then
    the groups, each a contiguous range in order)."""
    n_in, n_seq, n_acc = (len(prog.input_pos), len(prog.seq_pos),
                          len(prog.accum_pos))
    n_const = len(prog.const_pos)
    comb_base = n_in + n_seq + n_acc + n_const
    comb_out = (np.concatenate([g.out for g in prog.comb_groups])
                if prog.comb_groups else np.zeros(0, np.int64))
    canonical = (
        np.array_equal(prog.input_pos, np.arange(n_in))
        and np.array_equal(prog.seq_pos, n_in + np.arange(n_seq))
        and np.array_equal(prog.accum_pos, n_in + n_seq + np.arange(n_acc))
        and np.array_equal(comb_out, comb_base + np.arange(len(comb_out))))
    if not canonical:
        raise ValueError(f"{prog.name}: the lowering's slot layout is not "
                         f"canonical; sim_dense cannot run it")
    seq_rows = np.zeros((n_seq, 4), dtype=np.int64)
    for g in prog.seq_groups:
        seq_rows[g.out] = _node_rows([g])
    sizes = np.cumsum([0] + [len(g.out) for g in prog.comb_groups])
    bounds = [int(sizes[a]) for a, _ in stage_plan(prog)] + [len(comb_out)]
    ring_off = np.concatenate([[0], np.cumsum(prog.seq_lat)])
    blob, offs = _blob([
        ("o_comb", _node_rows(prog.comb_groups)),
        ("o_stage", bounds),
        ("o_seq", seq_rows),
        ("o_seq_lat", prog.seq_lat),
        ("o_ring_off", ring_off[:n_seq]),
        ("o_acc", np.column_stack([prog.accum_src, prog.accum_pred,
                                   prog.accum_pmask.astype(np.int64)])
         if n_acc else np.zeros(0)),
        ("o_out_pos", prog.output_pos),
        ("o_const", np.column_stack([prog.const_pos, prog.const_vals])
         if n_const else np.zeros(0)),
        ("o_table", prog.table_mat),
        ("o_tab_len", prog.tab_len)])
    state = _state(blob.size, [
        ("s_val", prog.n_nodes + 1), ("s_ring", int(ring_off[-1])),
        ("s_ptr", n_seq), ("s_acc", n_acc), ("s_in", n_in * CHUNK)])
    stage_width = max((b - a for a, b in zip(bounds, bounds[1:])), default=0)
    width = max(n_in + n_seq + n_acc, stage_width, len(prog.output_pos))
    values = dict(
        n_nodes=prog.n_nodes, n_in=n_in, n_out=len(prog.output_pos),
        n_seq=n_seq, n_acc=n_acc, n_const=n_const, n_comb=len(comb_out),
        comb_base=comb_base, n_stages=len(bounds) - 1,
        max_tab=prog.table_mat.shape[1], cycles=cycles, chunk=CHUNK,
        threads=_threads(width), blob_words=blob.size, **offs, **state)
    return values, blob


def sim_dense(prog, in_mat: torch.Tensor, cycles: int) -> torch.Tensor:
    """All ``cycles`` of a ``DenseProgram`` (``repro_torch.core.sim_vec.
    lower_dense``): ``in_mat`` [n_in, cycles] of values in [0, 0xFFFF] ->
    the outputs [n_out, cycles], int64 on ``in_mat``'s device.

    CPU tensors go to the plain version. A CUDA ``in_mat`` launches the
    kernel (one launch, one block); a program whose state does not fit a
    block's shared memory raises ``ValueError``.
    """
    if tuple(in_mat.shape) != (len(prog.input_pos), cycles):
        raise ValueError(f"in_mat {tuple(in_mat.shape)}, want "
                         f"{(len(prog.input_pos), cycles)}")
    if in_mat.device.type == "cpu":
        return sim_dense_plain(prog, in_mat, cycles)
    if in_mat.device.type != "cuda":
        raise ValueError(f"sim_dense runs on cuda or cpu, not {in_mat.device}")
    dev = in_mat.device
    out = torch.empty((len(prog.output_pos), cycles), dtype=torch.int64,
                      device=dev)
    values, blob = pack_dense(prog, cycles)
    _check_smem("sim_dense", values["s_words"], dev, prog.name)
    blob_t = torch.from_numpy(blob).to(dev)
    in_t = in_mat.to(torch.int64).contiguous()
    err = _kernel_lib().sim_dense_launch(
        _header(DENSE_FIELDS, values), blob_t.data_ptr(), in_t.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sim_dense launch failed with CUDA error {err}")
    sim_dense.launches += 1
    return out


sim_dense.launches = 0


# ---------------------------------------------------------------------------
# sparse
# ---------------------------------------------------------------------------


def _masked(idx: np.ndarray, mask: np.ndarray) -> np.ndarray:
    return np.where(mask, idx, -1)


def pack_sparse(prog, feed_shape: Tuple[int, int], max_cycles: int
                ) -> Tuple[Dict[str, int], np.ndarray]:
    """Header values and int32 blob of a ``SparseProgram`` for
    ``sim_sparse``; masked index entries become -1."""
    n_ev, n_in = len(prog.ev_names), len(prog.input_names)
    n_out, n_buf = len(prog.output_names), prog.n_buf
    ev = np.column_stack([prog.ev_op + (prog.ev_rom << 8),
                          _masked(prog.ev_in, prog.ev_in_mask)])[:n_ev]
    buf_const = np.full(n_buf, -1, dtype=np.int64)
    buf_const[prog.const_buf] = prog.const_val
    blob, offs = _blob([
        ("o_cap", prog.cap),
        ("o_ev", ev),
        ("o_ev_out", _masked(prog.ev_out, prog.ev_out_mask)[:n_ev]),
        ("o_in_out", _masked(prog.in_out, prog.in_out_mask)[:n_in]),
        ("o_out_buf", prog.out_buf[:n_out]),
        ("o_buf_src_ev", prog.buf_src_ev),
        ("o_buf_src_in", prog.buf_src_in),
        ("o_buf_cons_ev", prog.buf_cons_ev),
        ("o_buf_cons_out", prog.buf_cons_out),
        ("o_buf_const", buf_const),
        ("o_table", prog.table_mat),
        ("o_tab_len", prog.tab_len)])
    state = _state(blob.size, [
        ("s_buf", n_buf * prog.max_cap), ("s_blen", n_buf),
        ("s_brp", n_buf), ("s_fire", n_ev + n_out + n_in), ("s_v", n_ev),
        ("s_accv", n_ev), ("s_tok", n_in), ("s_fptr", n_in),
        ("s_frem", n_in), ("s_ocnt", n_out)])
    values = dict(
        n_buf=n_buf, max_cap=prog.max_cap, n_ev=n_ev,
        fan=prog.ev_out.shape[1], n_in=n_in, fan_in=prog.in_out.shape[1],
        n_out=n_out, max_tab=prog.table_mat.shape[1], n_rows=feed_shape[0],
        max_feed=feed_shape[1], max_cycles=max_cycles,
        threads=_threads(n_ev + n_out + n_in + n_buf),
        blob_words=blob.size, **offs, **state)
    return values, blob


def sim_sparse(prog, feed: torch.Tensor, frem: torch.Tensor,
               max_cycles: int) -> SparseResult:
    """The fire-vector fixpoint of a ``SparseProgram`` (``repro_torch.core.
    sim_vec.lower_sparse``) from ``feed`` [n_in (at least 1), max_feed] and
    ``frem`` (tokens of each feed row), to quiescence or ``max_cycles``
    rounds. Returns a :class:`SparseResult` of int64 tensors on ``feed``'s
    device.

    CPU tensors go to the plain version. A CUDA ``feed`` launches the kernel
    (one launch, one block).
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
    dev = feed.device
    rows, n_out = feed.shape[0], max(1, len(prog.output_names))
    values, blob = pack_sparse(prog, tuple(feed.shape), max_cycles)
    _check_smem("sim_sparse", values["s_words"], dev, prog.name)
    blob_t = torch.from_numpy(blob).to(dev)
    feed_t = feed.to(torch.int64).contiguous()
    frem_t = frem.to(device=dev, dtype=torch.int64).contiguous()
    outm = torch.empty((n_out, max_cycles), dtype=torch.int64, device=dev)
    state = torch.empty(prog.n_buf + rows + n_out + 2, dtype=torch.int64,
                        device=dev)
    err = _kernel_lib().sim_sparse_launch(
        _header(SPARSE_FIELDS, values), blob_t.data_ptr(), feed_t.data_ptr(),
        frem_t.data_ptr(), outm.data_ptr(), state.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sim_sparse launch failed with CUDA error {err}")
    sim_sparse.launches += 1
    blen, frem_out, ocnt, flags = state.split(
        [prog.n_buf, rows, n_out, 2])
    return SparseResult(blen, frem_out, outm, ocnt, flags[0], flags[1])


sim_sparse.launches = 0
