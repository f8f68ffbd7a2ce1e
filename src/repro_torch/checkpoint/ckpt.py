"""Checkpointing: manifest + one ``.npy`` per leaf, atomic publish,
reshard-on-restore.

The JAX package's on-disk layout, so either side can read the other's
checkpoints:

    <dir>/step_000123.tmp-<nonce>/   (written, then atomically renamed)
    <dir>/step_000123/
        MANIFEST.json     {step, leaves: [{path, file, shape, dtype}]}
        <leaf>.npy        one file per leaf at its global shape; bf16 stored
                          as its uint16 bits

Leaf paths join the tree's keys with ``__`` in the order jax flattens a
pytree: dict keys sorted, NamedTuple fields in order, None skipped. Restore
copies each leaf into the matching tensor of ``like``, in place, where the
reference builds new arrays: the trainer restores into its live state, so a
second copy of the train state is never held beside it.

State on a device mesh (DTensor leaves): a save gathers each leaf whole, one
leaf at a time, on the calling thread of every rank in the same order (the
gathers are collectives); rank 0 alone writes, and every rank waits for the
write at a barrier, so ``latest_step`` agrees on every rank. A restore reads
each rank's own slice of each file into the rank's shard. With
``shardings`` (a tree of ``(mesh, placements)``) every leaf comes back laid
out by its sharding, whatever mesh or layout wrote it: the reference's
elastic reshard. Every rank reads the same directory.

Fault-tolerance contract: a checkpoint directory either exists completely
(rename is atomic) or not at all; ``latest_step`` never sees partial state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

Tree = Any

_SEP = "__"


def _flatten(tree: Tree, prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in jax's flattening order (a ``(mesh, placements)``
    pair is one leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for name in tree._fields
                for item in _flatten(getattr(tree, name), prefix + (name,))]
    return [(_SEP.join(prefix), tree)]


def _unflatten(like: Tree, leaves: dict, prefix: Tuple[str, ...] = ()
               ) -> Tree:
    """``like``'s structure with each leaf replaced from ``leaves[path]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, n), leaves,
                                       prefix + (n,)) for n in like._fields))
    return leaves[_SEP.join(prefix)]


@dataclasses.dataclass
class _Host:
    """A leaf copied to the host: its array (bf16 as uint16 bits) and the
    name of its dtype."""
    arr: np.ndarray
    dtype: str


def _host(x: torch.Tensor) -> _Host:
    t = x.detach().cpu()
    dtype = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:          # npy has no bf16: store raw bits
        t = t.view(torch.int16)
    arr = t.numpy().copy()                 # a CPU tensor would share memory
    return _Host(arr.view(np.uint16) if dtype == "bfloat16" else arr, dtype)


@torch.no_grad()
def _gather(tree: Tree) -> Tuple[Optional[List[Tuple[str, _Host]]], bool]:
    """(the leaves on the host, or None on a rank that does not write;
    whether the tree lies on a mesh).

    A DTensor leaf is gathered whole, a leaf at a time (the whole leaf is
    dropped before the next gather); every rank takes part in each gather,
    and rank 0 alone writes."""
    leaves = _flatten(tree)
    on_mesh = any(isinstance(x, DTensor) for _, x in leaves)
    out = [] if not on_mesh or dist.get_rank() == 0 else None
    for p, x in leaves:
        if isinstance(x, DTensor):
            x = x.full_tensor()
        if out is not None:
            out.append((p, _host(x)))
    return out, on_mesh


def _barrier() -> None:
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _write(directory: str, step: int, leaves: List[Tuple[str, _Host]]
           ) -> None:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=directory)
    manifest = {"step": step, "leaves": []}
    for path, host in leaves:
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", path) + ".npy"
        np.save(os.path.join(tmp, fname), host.arr)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": list(host.arr.shape),
                                   "dtype": host.dtype})
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish


def save_checkpoint(directory: str, step: int, tree: Tree) -> str:
    """Write ``tree`` as ``<directory>/step_<step>``; on a mesh every rank
    calls this, and it returns once rank 0 has written."""
    leaves, on_mesh = _gather(tree)
    if leaves is not None:
        _write(directory, step, leaves)
    if on_mesh:
        _barrier()
    return os.path.join(directory, f"step_{step:08d}")


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _local_slice(shape: Tuple[int, ...], mesh: DeviceMesh, placements
                 ) -> Tuple[slice, ...]:
    """This rank's part of a ``shape`` leaf laid out by ``placements``:
    each ``Shard(d)`` cuts dim ``d`` in ``torch.chunk``'s pieces, mesh dims
    in order (a dim sharded on two mesh dims is cut by the first, then each
    piece by the second), as DTensor lays out its shards."""
    bounds = [[0, n] for n in shape]
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            lo, hi = bounds[p.dim]
            piece = -(-(hi - lo) // mesh.size(i))
            start = min(lo + coord[i] * piece, hi)
            bounds[p.dim] = [start, min(start + piece, hi)]
    return tuple(slice(a, b) for a, b in bounds)


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@torch.no_grad()
def restore_checkpoint(directory: str, step: int, like: Tree,
                       shardings: Optional[Tree] = None) -> Tree:
    """Restore into the structure of ``like`` and return it.

    A plain leaf of ``like`` is filled in place (it keeps its dtype and
    device); a DTensor leaf gets its own rank's slice of the file in its
    shard, in place. ``shardings``, a tree of ``(mesh, placements)`` with
    ``like``'s paths, lays each leaf out anew where its sharding differs
    from the leaf's (another mesh or layout, a plain or meta leaf): a new
    DTensor of ``like``'s dtype whose shard is read from the file, and the
    tree comes back rebuilt around it. Every rank reads the same
    directory."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    targets = dict(_flatten(shardings))
    out, rebuilt = {}, False
    for p, leaf in _flatten(like):
        entry = by_path[p]
        arr = np.load(os.path.join(path, entry["file"]), mmap_mode="r")
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{p}: checkpoint shape {arr.shape} != {want}")
        if entry["dtype"] == "bfloat16":
            arr = arr.view(np.int16)

        def read(sl):
            t = torch.from_numpy(np.array(arr[sl]))
            return t.view(torch.bfloat16) if entry["dtype"] == "bfloat16" \
                else t

        target = targets.get(p)
        if target is None and isinstance(leaf, DTensor):
            target = (leaf.device_mesh, leaf.placements)
        if target is None:
            if leaf.is_meta:
                raise ValueError(f"{p}: a meta leaf needs a sharding")
            leaf.copy_(read(...))
            out[p] = leaf
        elif isinstance(leaf, DTensor) and leaf.device_mesh == target[0] \
                and tuple(leaf.placements) == tuple(target[1]):
            leaf.to_local().copy_(read(_local_slice(want, *target)))
            out[p] = leaf
        else:
            mesh, placements = target
            local = read(_local_slice(want, mesh, placements)).to(
                _mesh_device(mesh), leaf.dtype)
            out[p] = DTensor.from_local(
                local, mesh, placements, run_check=False,
                shape=torch.Size(want),
                stride=torch.empty(want, device="meta").stride())
            rebuilt = True
        del arr
    return _unflatten(like, out) if rebuilt else like


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async (background-thread)
    saves so the training loop overlaps I/O with the next step. The state is
    copied to the host before ``save`` returns, so the loop may go on
    updating it in place. On a mesh the gathers run in ``save``, on the
    calling thread; the thread only writes, on rank 0, and every rank waits
    for it at a barrier in ``wait`` (and so in the next ``save`` and in
    ``restore_latest``)."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._on_mesh = False

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._on_mesh:
            self._on_mesh = False
            _barrier()

    def save(self, step: int, tree: Tree):
        leaves, on_mesh = _gather(tree)
        self.wait()
        self._on_mesh = on_mesh
        if leaves is None:
            return

        def run():
            _write(self.directory, step, leaves)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            run()

    def _gc(self):
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like: Tree, shardings: Optional[Tree] = None
                       ) -> Tuple[Optional[int], Optional[Tree]]:
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like, shardings)
