"""The port's meshes: shapes and axis names of the production meshes on a
fake world, the one-rank smoke mesh, and the elastic mesh's arithmetic
against the reference's ``make_mesh_for``. Each test that starts a process
group destroys it."""

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro.launch import mesh as ref_mesh  # noqa: E402
from repro_torch.launch.mesh import (make_mesh_for,  # noqa: E402
                                     make_production_mesh, make_smoke_mesh,
                                     mesh_shape_for)


@pytest.fixture
def fake_world():
    """Start a fake world of n ranks (this process is rank 0)."""
    def start(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod,shape,names", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_production_mesh_shapes_and_names(fake_world, multi_pod, shape,
                                          names):
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
    assert mesh.device_type == "cpu"


@pytest.mark.parametrize("world", [None, 128, 512])
def test_production_mesh_refuses_a_world_of_the_wrong_size(fake_world, world):
    """Without a group, or with one of another size than 256, the
    single-pod mesh raises and says what it needs."""
    if world:
        fake_world(world)
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()


def test_smoke_mesh_is_one_rank_on_the_cpu():
    mesh = make_smoke_mesh("cpu")
    try:
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh.device_type == "cpu" and dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1
        assert make_smoke_mesh("cpu").shape == mesh.shape   # reuses the group
    finally:
        dist.destroy_process_group()


def test_smoke_mesh_raises_without_a_card_unless_the_cpu_is_asked(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_smoke_mesh()
    assert not dist.is_initialized()


@pytest.mark.parametrize("n,mp", [(1, 16), (8, 16), (24, 16), (256, 16),
                                  (512, 16), (96, 8), (7, 4), (30, 16)])
def test_mesh_shape_for_keeps_the_reference_arithmetic(monkeypatch, n, mp):
    """The reference's ``make_mesh_for`` (its jax.make_mesh call captured)
    and the port's give the same (data, model) shape."""
    monkeypatch.setattr(ref_mesh.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    want = ref_mesh.make_mesh_for(n, model_parallel=mp)
    assert (mesh_shape_for(n, mp), ("data", "model")) == want


def test_make_mesh_for_spans_the_world(fake_world):
    fake_world(24)
    mesh = make_mesh_for()
    assert tuple(mesh.shape) == (2, 12)
    assert mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(RuntimeError, match="ranks"):
        make_mesh_for(16)
