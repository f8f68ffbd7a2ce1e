"""Logical-axis sharding rules for the (pod, data, model) production mesh.

Every tensor of the LM stack (weights, optimizer state, KV caches, batches)
is annotated with *logical* axis names; this module resolves them against
the active ``DeviceMesh`` to a spec, and a spec to DTensor placements.
Hillclimb levers (sequence parallelism, FSDP/ZeRO weight sharding, cache
layout) are rule edits here; model code never names a physical mesh axis.

torch has no ambient mesh, so ``use_mesh(mesh)`` (thread-local) stands in
for jax's ``with mesh:``. A spec is a tuple with one entry a tensor dim:
``None``, a mesh-axis name, or a tuple of names; ``placements`` turns it
into DTensor placements, a dim named on several mesh axes sharded on each,
in mesh order (the first named axis outermost, as in jax).

Resolution is defensive by construction, as in the reference:

* a rule that names a mesh axis absent from the current mesh drops it
  (the same model code resolves on the single-pod and multi-pod meshes);
* a mesh axis whose size does not divide the tensor dimension is dropped
  for that tensor (e.g. 8 KV heads on a 16-way model axis fall back to
  replication exactly like Megatron does);
* one physical axis is never assigned twice in a spec.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

Axes = Tuple[Optional[str], ...]
PhysAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[PhysAxes, ...]

# ---------------------------------------------------------------------------
# rule sets

#: baseline rules — Megatron-style TP over "model", batch over ("pod","data").
BASE_RULES: Dict[str, PhysAxes] = {
    "batch": ("pod", "data"),
    "seq": None,                 # sequence-parallel residual: set to "model"
    "embed": None,               # residual d_model
    "vocab": "model",
    "vocab_rep": None,           # input-embedding vocab rows (gather stays local)
    "embed_shard": "model",      # input-embedding feature dim
    "qkv": "model",              # flattened heads*head_dim projection axis
    "heads": "model",
    "head_dim": None,
    "mlp": "model",              # d_ff
    "expert": "model",
    "capacity": None,
    "layers": None,
    "ssm_inner": "model",        # mamba d_inner / rwkv projection axis
    "ssm_state": None,
    "ssm_heads": "model",
    "conv": None,
    "lora": None,
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
    "cache_heads": None,
    "cache_hd": "model",         # decode KV cache sharded over head_dim
    "frames": None,
    "fsdp": None,                # weights' largest axis: set to "data" for ZeRO-3
}


def rules_with(**edits: PhysAxes) -> Dict[str, PhysAxes]:
    r = dict(BASE_RULES)
    r.update(edits)
    return r


#: sequence-parallel variant (activations' seq axis sharded over "model")
SP_RULES = rules_with(seq="model")
#: ZeRO-3 / FSDP variant (weight "fsdp"-tagged axes sharded over "data")
FSDP_RULES = rules_with(fsdp="data")

# ---------------------------------------------------------------------------
# active rules and mesh (thread-local)

_state = threading.local()


def set_rules(rules: Dict[str, PhysAxes]):
    _state.rules = dict(rules)


def get_rules() -> Dict[str, PhysAxes]:
    return getattr(_state, "rules", BASE_RULES)


@contextlib.contextmanager
def use_rules(rules: Dict[str, PhysAxes]):
    prev = get_rules()
    set_rules(rules)
    try:
        yield
    finally:
        set_rules(prev)


def get_mesh() -> Optional[DeviceMesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    """Make ``mesh`` the one ``resolve_spec`` and ``shard`` read (jax's
    ``with mesh:``)."""
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh needs mesh_dim_names")
    prev = get_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def _mesh_axis_sizes(mesh: Optional[DeviceMesh] = None) -> Dict[str, int]:
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def resolve_spec(axes: Axes, rules: Optional[Dict[str, PhysAxes]] = None,
                 dims: Optional[Sequence[int]] = None) -> Spec:
    """Logical axes -> spec under the active mesh and rules.

    When two dims of one tensor map to the same mesh axis, the first dim
    wins by default. A rule set with ``"__reverse__": True`` resolves the
    LAST dim first instead — used by the zero3cp profile so weight matrices
    shard their OUTPUT dim (gather-at-use ZeRO-3) rather than their
    contraction dim (which would force output all-reduces).
    """
    rules = rules or get_rules()
    sizes = _mesh_axis_sizes()
    used: set = set()
    order = range(len(axes))
    if rules.get("__reverse__"):
        order = reversed(order)
    out: list = [None] * len(axes)
    for i in order:
        name = axes[i]
        phys = rules.get(name) if name else None
        cand = (phys,) if isinstance(phys, str) else (phys or ())
        keep = []
        prod = 1
        for ax in cand:
            if ax is None or ax in used or ax not in sizes:
                continue
            keep.append(ax)
            prod *= sizes[ax]
        if dims is not None and keep and prod and dims[i] % prod != 0:
            keep = []                      # indivisible -> replicate this dim
        used.update(keep)
        out[i] = tuple(keep) if len(keep) > 1 else (keep[0] if keep else None)
    return tuple(out)


def _names(entry: PhysAxes) -> Tuple[str, ...]:
    return () if entry is None else ((entry,) if isinstance(entry, str)
                                     else tuple(entry))


def placements(spec: Spec, mesh: Optional[DeviceMesh] = None) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (default: the active one):
    ``Shard(d)`` on each mesh dim that tensor dim d names, ``Replicate()``
    on the rest."""
    mesh = mesh if mesh is not None else get_mesh()
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is sharded over {entry}, not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to its logical axes' placements on its own
    mesh; any other tensor comes back unchanged (the reference's
    ``with_sharding_constraint`` is a no-op outside a mesh)."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    with use_mesh(mesh):
        spec = resolve_spec(tuple(axes), dims=x.shape)
    return x.redistribute(mesh, placements(spec, mesh))


def gather_weight(w: torch.Tensor) -> torch.Tensor:
    """ZeRO-3 explicit weight gather (active under rules with
    ``__gather_weights__``, e.g. the zero3cp profile): a sharded DTensor
    weight is replicated for its use, so its gradient comes back to the
    shard as a reduce-scatter. Other tensors, or other rules: unchanged."""
    if not get_rules().get("__gather_weights__") or \
            not isinstance(w, DTensor):
        return w
    return w.redistribute(w.device_mesh,
                          [Replicate()] * w.device_mesh.ndim)


# ---------------------------------------------------------------------------
# trees: nested dicts, NamedTuples (the optimizer state), None (no subtree)


def is_axes(x) -> bool:
    """A logical-axes tuple (not a NamedTuple of subtrees)."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] = is_axes) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same paths of ``rest``)."""
    if tree is None:
        return None
    if is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest),
                                     is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def specs_for_tree(logical_tree: Any, shapes_tree: Any = None,
                   rules: Optional[Dict[str, PhysAxes]] = None) -> Any:
    """Map a tree of logical-axes tuples to specs (with ``shapes_tree``, a
    tree of meta tensors of the same paths, dropping indivisible axes)."""
    if shapes_tree is None:
        return tree_map(lambda a: resolve_spec(a, rules), logical_tree)
    return tree_map(lambda a, s: resolve_spec(a, rules, dims=s.shape),
                    logical_tree, shapes_tree)


def named_shardings(mesh: DeviceMesh, specs_tree: Any) -> Any:
    """``(mesh, placements)`` for each spec of the tree: what
    ``distribute_tensor(x, mesh, placements)`` takes."""
    return tree_map(lambda s: (mesh, placements(s, mesh)), specs_tree,
                    is_leaf=lambda x: isinstance(x, tuple)
                    and not hasattr(x, "_fields"))
