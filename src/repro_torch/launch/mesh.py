"""Mesh construction on ``torch.distributed``.

Functions, never module-level constants, so importing this module touches
no process group.

Mesh shapes, as in the reference:
  single-pod : (16, 16)    axes ("data", "model")          — 256 ranks
  multi-pod  : (2, 16, 16) axes ("pod", "data", "model")   — 512 ranks

The "model" axis carries tensor/expert parallelism, "data" and "pod" data
parallelism. A ``DeviceMesh`` spans the whole default process group, so the
world must have exactly the mesh's ranks: on one machine that is the
``"fake"`` backend (``torch.testing._internal.distributed.fake_pg``), which
gives a rank its shards' shapes without running a collective.
``mesh_for_flag`` is the entry points' ``--mesh`` choice.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _mesh_device_type() -> str:
    """Where an existing group's ranks keep their tensors: the card under
    nccl, the host under gloo or the fake backend."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> DeviceMesh:
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != n:
        raise RuntimeError(
            f"a {shape} mesh {axes} needs a default process group of {n} "
            f"ranks, found {'none' if world is None else world}: start "
            f"{n} processes, or init_process_group('fake', store="
            f"FakeStore(), rank=0, world_size={n}) to resolve shapes on "
            f"one machine")
    return init_device_mesh(_mesh_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape, axes = PRODUCTION[multi_pod]
    return _mesh(shape, axes)


def make_smoke_mesh(device: Optional[Union[str, torch.device]] = None
                    ) -> DeviceMesh:
    """A (1, 1) mesh with the production axis names on the caller's device
    (default: the card). Without a process group it starts a one-rank one
    in memory (a ``HashStore``, no network): gloo on the CPU, nccl on the
    card, the backend a multi-card run of DTensors uses."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"the smoke mesh is one rank; the default group "
                           f"has {dist.get_world_size()}")
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def start_world(device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """Join the world that ``torchrun`` started (its ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; one process a card)
    unless a default group already runs, and return this rank's device:
    ``cuda:<LOCAL_RANK>`` under nccl, the CPU under gloo (``device="cpu"``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dev


def mesh_shape_for(n: int, model_parallel: int = 16) -> Tuple[int, int]:
    """(data, model) for ``n`` ranks: the largest model-parallel degree up to
    ``model_parallel`` that divides ``n``."""
    mp = min(model_parallel, n)
    while n % mp:
        mp -= 1
    return n // mp, mp


def make_mesh_for(devices: Optional[int] = None, model_parallel: int = 16
                  ) -> DeviceMesh:
    """Elastic variant: a (data, model) mesh over ``devices`` ranks (default:
    the whole world), used by the elastic-rescale path."""
    n = devices or (dist.get_world_size() if dist.is_initialized() else 1)
    return _mesh(mesh_shape_for(n, model_parallel), ("data", "model"))


MESH_FLAGS = ("none", "smoke", "auto", "production")


def mesh_for_flag(flag: str, device: Optional[Union[str, torch.device]] = None,
                  *, multi_pod: bool = False
                  ) -> Tuple[Optional[Union[str, torch.device]],
                             Optional[DeviceMesh]]:
    """(this rank's device, the mesh) for the entry points' ``--mesh``:
    ``none`` no mesh; ``smoke`` ``make_smoke_mesh(device)``; ``auto``
    ``make_mesh_for()`` and ``production`` ``make_production_mesh(
    multi_pod=)`` over the world that ``start_world`` joins (the latter
    raises, naming the ranks it needs, in a world of another size). The
    caller destroys a process group started here."""
    if flag not in MESH_FLAGS:
        raise ValueError(f"--mesh {flag!r}: one of {MESH_FLAGS}")
    if flag == "none":
        return device, None
    if flag == "smoke":
        return device, make_smoke_mesh(device)
    device = start_world(device)
    if flag == "auto":
        return device, make_mesh_for()
    return device, make_production_mesh(multi_pod=multi_pod)
