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
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

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


class _Constrain(torch.autograd.Function):
    """Redistribute to ``placements``, the gradient too: the transpose of
    jax's ``with_sharding_constraint`` is the same constraint, where a
    DTensor's own ``redistribute`` hands a partial-sum gradient back as it
    is (and the product before it may then gather its weight whole rather
    than reduce the gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, pl):
        ctx.sharding = (mesh, pl)
        return x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.sharding), None, None


class _Pin(torch.autograd.Function):
    """The identity, its gradient redistributed to the input's placements
    (a partial sum's gradient whole)."""

    @staticmethod
    def forward(ctx, x):
        ctx.sharding = (x.device_mesh, [Replicate() if p.is_partial() else p
                                        for p in x.placements])
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.sharding)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to its logical axes' placements on its own
    mesh, and its gradient to the same (``_Constrain``); any other tensor
    comes back unchanged (the reference's ``with_sharding_constraint`` is a
    no-op outside a mesh)."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    with use_mesh(mesh):
        spec = resolve_spec(tuple(axes), dims=x.shape)
    return _Constrain.apply(x, mesh, tuple(placements(spec, mesh)))


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A tensor the model makes itself (positions, rope tables, masks,
    iotas, zero states) placed beside ``like``: replicated on ``like``'s
    mesh when ``like`` is a DTensor, else ``t`` unchanged. Each rank then
    holds the whole of ``t``, which is what it costs in memory."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _moved(x: DTensor, dims: Sequence[int], spill: Optional[int]
           ) -> DTensor:
    """``x`` with the shards of ``dims`` moved to dim ``spill`` where it
    splits evenly there (an all-to-all), else gathered (an all-gather)."""
    mesh, pl = x.device_mesh, list(x.placements)
    on = [i for i, p in enumerate(pl) if any(p.is_shard(d) for d in dims)]
    if not on:
        return x
    n = math.prod(mesh.size(i) for i in on)
    k = math.prod(mesh.size(i) for i, p in enumerate(pl)
                  if spill is not None and p.is_shard(spill))
    to = Shard(spill) if spill is not None and spill not in dims and \
        x.shape[spill] % (k * n) == 0 else Replicate()
    for i in on:
        pl[i] = to
    return x.redistribute(mesh, pl)


def _even(x: DTensor) -> DTensor:
    """``x`` with every shard that does not split its dim evenly gathered:
    some versions of DTensor refuse to reshape around one (5 token-shift
    mixes over 4 ranks, in a gradient DTensor sharded so)."""
    mesh, pl = x.device_mesh, list(x.placements)
    odd = [i for i, p in enumerate(pl) if p.is_shard()
           and x.shape[p.dim] % mesh.size(i)]
    if not odd:
        return x
    for i in odd:
        pl[i] = Replicate()
    return x.redistribute(mesh, pl)


class _Unflatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, sizes, spill):
        ctx.args = (dim, len(sizes), spill)
        # a reshape: DTensor hands ``unflatten``'s global sizes to the
        # local shard as they are
        return x.reshape(x.shape[:dim] + tuple(sizes) + x.shape[dim + 1:])

    @staticmethod
    def backward(ctx, g):
        return flatten(g, *ctx.args), None, None, None


class _Flatten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n, spill):
        ctx.args = (dim, tuple(x.shape[dim:dim + n]), spill)
        return x.reshape(x.shape[:dim] + (-1,) + x.shape[dim + n:])

    @staticmethod
    def backward(ctx, g):
        return unflatten(g, *ctx.args), None, None, None


def unflatten(x: torch.Tensor, dim: int, sizes: Sequence[int],
              spill: Optional[int] = None) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``. A DTensor keeps a shard of ``dim`` on
    the first new dim, which needs ``sizes[0]`` to split evenly over the
    mesh dims sharding it (8 kv heads do not over a 16-way "model" axis).
    Where it does not, those mesh dims move their shard to dim ``spill``
    first (an all-to-all) if it splits evenly there, else gather (an
    all-gather); the gradient takes the same way back (``flatten``). Plain
    tensors: ``unflatten`` alone."""
    if not isinstance(x, DTensor):
        return x.unflatten(dim, sizes)
    x = _even(x)
    dim = dim % x.ndim
    n = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                  if p.is_shard(dim))
    if sizes[0] % n:
        x = _moved(x, [dim], spill)
    return _Unflatten.apply(x, dim, tuple(sizes), spill)


def flatten(x: torch.Tensor, dim: int, n: int,
            spill: Optional[int] = None) -> torch.Tensor:
    """``x.flatten(dim, dim + n - 1)``. A DTensor can keep a shard of the
    first merged dim only: shards of the others move to ``spill`` or are
    gathered first, as in ``unflatten``, which is the gradient's way back.
    Plain tensors: ``flatten`` alone."""
    if not isinstance(x, DTensor):
        return x.flatten(dim, dim + n - 1)
    dim = dim % x.ndim
    x = _moved(_even(x), range(dim + 1, dim + n), spill)
    return _Flatten.apply(x, dim, n, spill)


def pinned(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient redistributed to x's placements (as
    ``shard``'s): the op before it then takes its gradient as it gave its
    output. Plain tensors come back as they are."""
    if not isinstance(x, DTensor):
        return x
    return _Pin.apply(x)


def unsharded(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with every shard of ``dims`` gathered (an all-gather): what an
    op needs that walks those dims (a chunked recurrence over time, an
    ``unbind``). Plain tensors come back as they are."""
    if not isinstance(x, DTensor):
        return x
    return _moved(x, [d % x.ndim for d in dims], None)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: x [..., K], w [K, N]. On DTensors the product runs on
    each rank's shards (``local_map``), its placements a mesh dim by x's:

    * a shard of x's leading dims (the batch, the sequence) stays, w is
      gathered, and w's gradient is a partial sum;
    * a shard of x's K meets w's K: the product is a partial sum;
    * a partial x gives a partial product;
    * a whole x keeps a shard of w's N (the product's last dim; x's
      gradient a partial sum) or of w's K (x is cut to meet it).

    DTensor's own product flattens x's leading dims into one first, which
    some of its versions refuse when a dim past the first is sharded, in
    the forward or in the gradient."""
    if not isinstance(x, DTensor):
        return x @ w
    last = x.ndim - 1
    spec = []          # (x, w, the product, x's gradient, w's gradient)
    for i, p in enumerate(x.placements):
        q = w.placements[i] if isinstance(w, DTensor) else Replicate()
        if p.is_shard() and p.dim < last:
            spec.append((p, Replicate(), p, p, Partial()))
        elif p.is_shard():
            spec.append((p, Shard(0), Partial(), p, Shard(0)))
        elif p.is_partial():
            spec.append((p, Replicate(), p, Replicate(), Partial()))
        elif q.is_shard(1):
            spec.append((p, q, Shard(last), Partial(), q))
        elif q.is_shard(0):
            spec.append((Shard(last), q, Partial(), Shard(last), q))
        else:
            spec.append((p, p, p, p, p))
    px, pw, po, gx, gw = (list(t) for t in zip(*spec))
    return local_map(torch.matmul, out_placements=po, in_placements=(px, pw),
                     in_grad_placements=(gx, gw), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x, w)


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
