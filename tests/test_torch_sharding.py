"""The port's logical axes and sharding rules against the JAX package's.

The reference resolves its specs on the production meshes without devices,
under ``jax.sharding.use_abstract_mesh``; the port resolves them on a
``DeviceMesh`` of a fake world of 256 or 512 ranks (the ``"fake"`` process
group: shapes and placements without collectives), set up and destroyed by
a module fixture. Every comparison is exact: shapes, axis names, specs,
rules, per-device shapes and bytes.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import distribute_tensor  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.data.pipeline import batch_logical_axes as ref_batch_axes  # noqa: E402
from repro.data.pipeline import batch_specs as ref_batch_specs  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.data import batch_logical_axes, batch_specs  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_smoke_mesh)
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.params import ParamDef  # noqa: E402

# the profiles rules_for makes, as config edits
PROFILES = {"tp": dict(sharding_profile="tp"),
            "dp": dict(sharding_profile="dp"),
            "zero3cp": dict(sharding_profile="zero3cp"),
            "sp": dict(sequence_parallel=True),
            "fsdp": dict(fsdp=True),
            "cache_seq": dict(decode_cache_shard="seq")}
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


def _key(k):
    return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))


def ref_flat(tree, is_leaf=None):
    """{path: leaf} of a reference tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {".".join(_key(k) for k in path): leaf for path, leaf in leaves}


def port_flat(tree, pre=""):
    """{path: leaf} of a port tree: dicts and NamedTuples are nodes, None
    has no leaf, anything else (a tensor, an axes tuple, a spec, a (mesh,
    placements) pair) is a leaf."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return {pre[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(port_flat(v, f"{pre}{k}."))
    return out


def ref_is_axes(x):
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str) for a in x)


def is_spec(x):
    return isinstance(x, P)


def local_shape(shape, spec, sizes):
    """One device's shape of a ``shape`` tensor laid out by ``spec`` on a
    mesh of these axis sizes."""
    out = []
    for dim, entry in zip(tuple(shape), tuple(spec)):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        out.append(dim // math.prod(sizes[a] for a in names))
    return tuple(out)


def device_bytes(shapes, specs, sizes, itemsize):
    """Bytes on one device: each leaf's shape cut by its spec's axes."""
    return sum(math.prod(local_shape(s.shape, specs[path], sizes))
               * itemsize(s) for path, s in shapes.items())


# ---------------------------------------------------------------------------
# shape and axis trees, batch specs


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_cache_trees_match_reference(arch):
    """Shapes, dtypes and logical axes of the parameters and of the caches
    at every serving shape, leaf for leaf; nothing is allocated."""
    ref, port = RefLM(REF_ARCHS[arch]), LM(ARCHS[arch])
    trees = [(ref.shapes(), ref.logical_axes(), port.shapes(),
              port.logical_axes())]
    for name in SERVE_SHAPES:
        sh = SHAPES[name]
        b, s = sh.global_batch, sh.seq_len
        trees.append((ref.cache_shapes(b, s), ref.cache_logical_axes(b, s),
                      port.cache_shapes(b, s), port.cache_logical_axes(b, s)))
    for rs, ra, ps, pa in trees:
        rs, ra = ref_flat(rs), ref_flat(ra, is_leaf=ref_is_axes)
        ps, pa = port_flat(ps), port_flat(pa)
        assert sorted(rs) == sorted(ps) == sorted(pa)
        for path, want in rs.items():
            got = ps[path]
            assert got.device.type == "meta", path
            assert tuple(got.shape) == tuple(want.shape), path
            assert str(got.dtype).split(".")[-1] == str(want.dtype), path
            assert pa[path] == ra[path], path


def test_param_def_checks_axes_against_shape():
    ParamDef((4, 8), ("embed", "mlp"))
    with pytest.raises(ValueError, match="do not match"):
        ParamDef((4, 8), ("embed",))


@pytest.mark.parametrize("shape", sorted(REF_SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_specs_cover_all_cells(arch, shape):
    """The reference's test_batch_specs_cover_all_cells, replayed against
    the port, and its shapes and axes leaf for leaf. The port's token leaves
    are int64 where the reference's are int32 (torch's embedding and gather
    take int64); the embeddings are bf16 in both."""
    cfg, sh = ARCHS[arch], SHAPES[shape]
    got, want = batch_specs(cfg, sh), ref_batch_specs(REF_ARCHS[arch],
                                                      REF_SHAPES[shape])
    assert "tokens" in got
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.device.type == "meta" and v.shape[0] == sh.global_batch
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert v.dtype == (torch.int64 if k in ("tokens", "labels")
                           else torch.bfloat16), k
    assert batch_logical_axes(cfg, sh) == ref_batch_axes(REF_ARCHS[arch],
                                                         REF_SHAPES[shape])


# ---------------------------------------------------------------------------
# the reference's sharding-rule tests (tests/test_distributed.py), replayed


@pytest.fixture
def smoke_mesh():
    mesh = make_smoke_mesh("cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_resolve_spec_divisibility_fallback(smoke_mesh):
    with shd.use_mesh(smoke_mesh):
        # "model" axis size 1 always divides; 17 % 1 == 0 -> kept
        spec = shd.resolve_spec(("embed", "vocab"), dims=(17, 32))
        assert isinstance(spec, tuple) and spec == (None, "model")


def test_resolve_spec_drops_missing_axes(smoke_mesh):
    with shd.use_mesh(smoke_mesh):       # no "pod" axis
        spec = shd.resolve_spec(("batch", "seq"), dims=(8, 16))
        flat = []
        for entry in spec:
            if isinstance(entry, tuple):
                flat += list(entry)
            elif entry:
                flat.append(entry)
        assert "pod" not in flat and flat == ["data"]


def test_resolve_spec_never_reuses_axis(smoke_mesh):
    rules = shd.rules_with(embed="model", mlp="model")
    with shd.use_mesh(smoke_mesh):
        spec = shd.resolve_spec(("embed", "mlp"), rules=rules, dims=(16, 16))
        used = [a for a in spec if a]
        assert len(used) == len(set(used)) and spec == ("model", None)


def test_rules_context():
    shd.set_rules(shd.BASE_RULES)
    with shd.use_rules(shd.SP_RULES):
        assert shd.get_rules()["seq"] == "model"
    assert shd.get_rules()["seq"] is None


def test_rule_sets_equal_reference():
    assert shd.BASE_RULES == ref_shd.BASE_RULES
    assert shd.SP_RULES == ref_shd.SP_RULES
    assert shd.FSDP_RULES == ref_shd.FSDP_RULES
    assert shd.rules_with(seq="model", cache_hd=None) == \
        ref_shd.rules_with(seq="model", cache_hd=None)


def test_no_mesh_resolves_to_replication_and_shard_passes_tensors():
    """Outside ``use_mesh`` every axis is dropped (the reference outside a
    mesh), and ``shard`` / ``gather_weight`` return a plain tensor as it
    is."""
    assert shd.resolve_spec(("batch", "mlp"), dims=(8, 64)) == (None, None)
    x = torch.ones(8, 64)
    assert shd.shard(x, "batch", "mlp") is x
    with shd.use_rules(S.rules_for(ARCHS["llama3-8b"].replace(
            sharding_profile="zero3cp"))):
        assert shd.gather_weight(x) is x


def test_shard_and_gather_weight_redistribute_a_dtensor(smoke_mesh):
    """On the (1, 1) gloo mesh: ``shard`` lays a DTensor out by its logical
    axes on its own mesh, ``gather_weight`` replicates it under rules that
    gather at use, and the values never change."""
    from torch.distributed.tensor import Replicate, Shard
    x = torch.arange(32.0).reshape(4, 8)
    d = distribute_tensor(x, smoke_mesh, [Replicate(), Replicate()])
    y = shd.shard(d, "batch", "mlp")
    assert list(y.placements) == [Shard(0), Shard(1)]
    torch.testing.assert_close(y.full_tensor(), x)
    assert shd.gather_weight(y) is y                  # tp: no gather
    with shd.use_rules(S.rules_for(ARCHS["llama3-8b"].replace(
            sharding_profile="zero3cp"))):
        g = shd.gather_weight(y)
    assert list(g.placements) == [Replicate(), Replicate()]
    torch.testing.assert_close(g.full_tensor(), x)


def test_placements_follow_the_mesh_order(prod_mesh):
    """A dim named on two mesh axes is sharded on both, outermost first in
    the mesh's order; a spec naming them out of that order raises."""
    from torch.distributed.tensor import Replicate, Shard
    multi, mesh, _ = prod_mesh
    if multi:
        assert shd.placements((("pod", "data"), "model"), mesh) == [
            Shard(0), Shard(0), Shard(1)]
        with pytest.raises(ValueError, match="order"):
            shd.placements((("data", "pod"), None), mesh)
    else:
        assert shd.placements((None, ("data", "model")), mesh) == [
            Shard(1), Shard(1)]
        assert shd.placements((None, None), mesh) == [Replicate()] * 2


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_for_equals_reference(arch, profile):
    cfg = ARCHS[arch].replace(**PROFILES[profile])
    rcfg = REF_ARCHS[arch].replace(**PROFILES[profile])
    for params in (False, True):
        assert S.rules_for(cfg, params=params) == RS.rules_for(
            rcfg, params=params)


# ---------------------------------------------------------------------------
# every leaf on the production meshes


@pytest.fixture(scope="module", params=[False, True],
                ids=["mesh16x16", "mesh2x16x16"])
def prod_mesh(request):
    """(multi_pod, the port's production mesh on a fake world, the
    reference's abstract mesh)."""
    multi = request.param
    n = 512 if multi else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi else \
            ((16, 16), ("data", "model"))
        yield multi, make_production_mesh(multi_pod=multi), \
            AbstractMesh(shape, axes)
    finally:
        dist.destroy_process_group()


def _itemsize(s):
    return s.element_size() if isinstance(s, torch.Tensor) else \
        np.dtype(s.dtype).itemsize


def _cell_trees(arch, profile):
    """[(what, reference (axes, shapes, rules), port (axes, shapes, rules))]
    for the train state, the train batch and each serving cell's cache and
    batch."""
    cfg = ARCHS[arch].replace(**PROFILES[profile])
    rcfg = REF_ARCHS[arch].replace(**PROFILES[profile])
    port, ref = LM(cfg), RefLM(rcfg)
    oc, roc = S.make_optimizer_config(cfg), RS.make_optimizer_config(rcfg)
    out = [("state",
            (RS.train_state_axes(ref, roc), RS.train_state_shapes(ref, roc),
             RS.rules_for(rcfg, params=True)),
            (S.train_state_axes(port, oc), S.train_state_shapes(port, oc),
             S.rules_for(cfg, params=True)))]
    for name in ("train_4k",) + SERVE_SHAPES:
        sh, rsh = SHAPES[name], REF_SHAPES[name]
        out.append((f"batch {name}",
                    (ref_batch_axes(rcfg, rsh), ref_batch_specs(rcfg, rsh),
                     RS.rules_for(rcfg)),
                    (batch_logical_axes(cfg, sh), batch_specs(cfg, sh),
                     S.rules_for(cfg))))
        if sh.kind != "train":
            b, s = sh.global_batch, sh.seq_len
            out.append((f"cache {name}",
                        (ref.cache_logical_axes(b, s), ref.cache_shapes(b, s),
                         RS.rules_for(rcfg)),
                        (port.cache_logical_axes(b, s),
                         port.cache_shapes(b, s), S.rules_for(cfg))))
    return out


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_leaf_spec_and_device_bytes_equal_reference(prod_mesh, arch,
                                                          profile):
    """Every parameter, AdamW-state, cache and batch leaf's spec equals the
    reference's ``resolve_spec`` under its abstract mesh, and so do the
    bytes one device holds (the batch's per-device elements: its token
    leaves are int64 in the port)."""
    multi, mesh, amesh = prod_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for what, (rax, rsh, rrules), (pax, psh, prules) in _cell_trees(
            arch, profile):
        with jax.sharding.use_abstract_mesh(amesh):
            want = ref_shd.specs_for_tree(rax, rsh, rules=rrules)
        with shd.use_mesh(mesh):
            got = shd.specs_for_tree(pax, psh, rules=prules)
        want, got = ref_flat(want, is_leaf=is_spec), port_flat(got)
        rshapes, pshapes = ref_flat(rsh), port_flat(psh)
        assert sorted(want) == sorted(got) == sorted(pshapes), what
        for path, spec in want.items():
            assert got[path] == tuple(spec), (what, path)
        if what.startswith("batch"):
            one = lambda s: 1                                  # noqa: E731
            assert device_bytes(pshapes, got, sizes, one) == device_bytes(
                rshapes, want, sizes, one), what
        else:
            assert device_bytes(pshapes, got, sizes, _itemsize) == \
                device_bytes(rshapes, want, sizes, _itemsize), what


@pytest.mark.parametrize("arch,profile", [("llama3-8b", "tp"),
                                          ("llama3-8b", "zero3cp"),
                                          ("llama4-maverick-400b-a17b", "tp"),
                                          ("zamba2-2.7b", "dp")])
def test_distribute_tensor_gives_the_per_device_shapes(prod_mesh, arch,
                                                       profile):
    """``distribute_tensor`` of every meta leaf of the train state under the
    port's ``train_shardings`` gives the shape its spec cuts on this mesh,
    and the serve shardings' params equal the state's."""
    multi, mesh, _ = prod_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    cfg = ARCHS[arch].replace(**PROFILES[profile])
    model, oc = LM(cfg), S.make_optimizer_config(cfg)
    st_sh, b_sh = S.train_shardings(model, oc, mesh, SHAPES["train_4k"])
    p_sh, _, c_sh = S.serve_shardings(model, mesh, SHAPES["decode_32k"])
    with shd.use_mesh(mesh):
        specs = port_flat(shd.specs_for_tree(
            S.train_state_axes(model, oc), S.train_state_shapes(model, oc),
            rules=S.rules_for(cfg, params=True)))
    shapes = port_flat(S.train_state_shapes(model, oc))
    shardings = port_flat(st_sh)
    for path, x in shapes.items():
        m, pl = shardings[path]
        assert m is mesh and pl == shd.placements(specs[path], mesh), path
        local = distribute_tensor(x, m, pl).to_local()
        assert tuple(local.shape) == local_shape(x.shape, specs[path],
                                                 sizes), path
        assert local.device.type == "meta"
    for path, (m, pl) in port_flat(p_sh).items():
        assert pl == shardings["params." + path][1], path
    assert port_flat(b_sh) and port_flat(c_sh)
