"""Checkpointing: manifest + one ``.npy`` per leaf, atomic publish.

The JAX package's on-disk layout, so either side can read the other's
checkpoints:

    <dir>/step_000123.tmp-<nonce>/   (written, then atomically renamed)
    <dir>/step_000123/
        MANIFEST.json     {step, leaves: [{path, file, shape, dtype}]}
        <leaf>.npy        one file per leaf; bf16 stored as its uint16 bits

Leaf paths join the tree's keys with ``__`` in the order jax flattens a
pytree: dict keys sorted, NamedTuple fields in order, None skipped. Restore
copies each leaf into the matching tensor of ``like``, in place, where the
reference builds new arrays: the trainer restores into its live state, so a
second copy of the train state is never held beside it. One device: no
shardings argument.

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

Tree = Any

_SEP = "__"


def _flatten(tree: Tree, prefix: Tuple[str, ...] = ()
             ) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in jax's flattening order."""
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


def _host_tree(tree: Tree) -> Tree:
    return _unflatten(tree, {p: _host(x) for p, x in _flatten(tree)})


def save_checkpoint(directory: str, step: int, tree: Tree) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=directory)
    manifest = {"step": step, "leaves": []}
    for path, leaf in _flatten(tree):
        host = leaf if isinstance(leaf, _Host) else _host(leaf)
        arr, dtype = host.arr, host.dtype
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", path) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({"path": path, "file": fname,
                                   "shape": list(arr.shape),
                                   "dtype": dtype})
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(directory: str, step: int, like: Tree) -> Tree:
    """Copy the checkpoint into ``like``'s tensors, in place (each keeps its
    dtype and device), and return ``like``."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    for p, leaf in _flatten(like):
        entry = by_path[p]
        arr = np.load(os.path.join(path, entry["file"]))
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"{p}: checkpoint shape {arr.shape} != {want}")
        if entry["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        leaf.copy_(t)
    return like


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async (background-thread)
    saves so the training loop overlaps I/O with the next step. The state is
    copied to the host before ``save`` returns, so the loop may go on
    updating it in place."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Tree):
        tree = _host_tree(tree)
        self.wait()

        def run():
            save_checkpoint(self.directory, step, tree)
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

    def restore_latest(self, like: Tree) -> Tuple[Optional[int], Optional[Tree]]:
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like)
