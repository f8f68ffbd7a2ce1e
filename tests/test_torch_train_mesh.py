"""Training on a device mesh, on the CPU: checkpoints of DTensor state
(saved from a mesh, restored in place, resharded on restore, read by the
reference) on ``make_smoke_mesh("cpu")`` (one gloo rank), and ``train
--mesh``. Each test that starts a process group destroys it (``mesh``
fixture). The train step on that mesh against the reference's unsharded
steps is a case of ``test_three_train_steps_match_unsharded_reference``
(``tests/test_torch_train.py``); the same paths on 4 ranks are cases of
``tests/test_torch_multirank.py``."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Shard  # noqa: E402

from repro.checkpoint import ckpt as ref_ckpt  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.optim import adamw as port_adamw  # noqa: E402
from _torch_multirank import _close_states  # noqa: E402
from test_torch_train import (B, S_LEN, _assert_tree_close, _cfgs,  # noqa: E402
                              _ref_params)

SHAPE = ShapeSpec("x", S_LEN, B, "train")


@pytest.fixture
def mesh():
    m = make_smoke_mesh("cpu")
    yield m
    if dist.is_initialized():
        dist.destroy_process_group()


def _state(compress: bool = True, seed: int = 3):
    """A small train state (the error feedback too) and its model and
    optimizer config."""
    _, cfg = _cfgs()
    model = LM(cfg)
    opt = S.make_optimizer_config(cfg.replace(grad_compress=compress), 4)
    state = S.init_train_state(model, opt, torch.Generator().manual_seed(seed),
                               "cpu")
    for i, (_, x) in enumerate(_flatten(state["opt"])):
        x.add_(i)                     # moments and error feedback not 0
    return model, opt, state


# ---------------------------------------------------------------------------
# checkpoints of DTensor state


@pytest.mark.parametrize("how", ["function", "manager"])
def test_dtensor_state_round_trips_in_place(mesh, tmp_path, how):
    """A state laid out by ``train_shardings`` saves (each leaf gathered
    whole) and restores into DTensor leaves, each rank's shard in place."""
    model, opt, state = _state()
    state["opt"].step.fill_(7)
    want = [(p, x.clone()) for p, x in _flatten(state)]
    st_sh, _ = S.train_shardings(model, opt, mesh, SHAPE)
    state = S.place_tree(state, st_sh)
    assert all(isinstance(x, DTensor) for _, x in _flatten(state))
    if how == "function":
        save_checkpoint(str(tmp_path), 7, state)
    else:
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (5, 6, 7):
            mgr.save(s, state)
        mgr.wait()
        assert sorted(os.listdir(tmp_path)) == ["step_00000006",
                                                "step_00000007"]
    assert latest_step(str(tmp_path)) == 7

    _, _, like = _state(seed=9)
    like = S.place_tree(like, st_sh)
    ptrs = [x.to_local().data_ptr() for _, x in _flatten(like)]
    if how == "function":
        got = restore_checkpoint(str(tmp_path), 7, like)
    else:
        step, got = CheckpointManager(str(tmp_path)).restore_latest(
            like, shardings=st_sh)
        assert step == 7
    assert got is like and type(got["opt"]) is port_adamw.AdamWState
    assert [x.to_local().data_ptr() for _, x in _flatten(got)] == ptrs
    for (p, a), (_, b) in zip(_flatten(got), want):
        assert tuple(a.placements) == tuple(dict(_flatten(st_sh))[p][1])
        assert a.dtype == b.dtype and torch.equal(a.full_tensor(), b), p
    assert int(got["opt"].step.full_tensor()) == 7


@pytest.mark.parametrize("like_kind", ["plain", "meta"])
def test_plain_checkpoint_restores_resharded(mesh, tmp_path, like_kind):
    """The counterpart of the reference's ``test_checkpoint_elastic_reshard``:
    a checkpoint of plain tensors restored with ``shardings=`` comes back
    as DTensors with those placements and the saved values, from plain
    leaves of another state or from meta shapes."""
    model, opt, state = _state()
    save_checkpoint(str(tmp_path), 3, state)
    st_sh, _ = S.train_shardings(model, opt, mesh, SHAPE)
    if like_kind == "plain":
        like = _state(seed=9)[2]
    else:
        like = S.train_state_shapes(model, opt)
    got = restore_checkpoint(str(tmp_path), 3, like, shardings=st_sh)
    sh = dict(_flatten(st_sh))
    for p, x in _flatten(got):
        assert isinstance(x, DTensor) and x.device_mesh == mesh
        assert tuple(x.placements) == tuple(sh[p][1]), p
    assert any(pl.is_shard() for _, (_, pls) in sh.items() for pl in pls)
    _close_states(got, state, "resharded restore", rtol=0)
    # another layout of one leaf than the state's: every dim sharded
    x = state["params"]["embed"]["tok"]
    one = restore_checkpoint(
        str(tmp_path), 3, {"params": {"embed": {"tok": x}}},
        shardings={"params": {"embed": {"tok": (mesh, [Shard(1),
                                                       Shard(0)])}}})
    d = one["params"]["embed"]["tok"]
    assert tuple(d.placements) == (Shard(1), Shard(0))
    assert torch.equal(d.full_tensor(), x)


def test_mesh_checkpoint_is_read_by_the_reference_and_plain_tensors(
        mesh, tmp_path):
    """A checkpoint saved from the mesh is the reference's layout: its
    ``restore_checkpoint`` reads back the same bytes, and so does a restore
    into plain tensors."""
    rcfg, cfg = _cfgs()
    rparams = _ref_params(rcfg)
    ropt = ref_adamw.AdamWConfig()
    rstate = {"params": jax.tree.map(jnp.asarray, rparams),
              "opt": ref_adamw.adamw_init(rparams, ropt)}
    model = LM(cfg)
    opt = port_adamw.AdamWConfig()
    params = params_from_reference(rparams, "cpu")
    state = {"params": params, "opt": port_adamw.adamw_init(params, opt)}
    st_sh, _ = S.train_shardings(model, opt, mesh, SHAPE)
    save_checkpoint(str(tmp_path), 4, S.place_tree(state, st_sh))

    back = ref_ckpt.restore_checkpoint(str(tmp_path), 4, rstate)
    for (p, a), (_, b) in zip(_flatten(back["params"]),
                              _flatten(rparams)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), p
    assert int(back["opt"].step) == 0

    plain = {"params": params_from_reference(
        jax.tree.map(np.zeros_like, rparams), "cpu")}
    plain["opt"] = port_adamw.adamw_init(plain["params"], opt)
    got = restore_checkpoint(str(tmp_path), 4, plain)
    _assert_tree_close(got["params"], rparams, 0)


# ---------------------------------------------------------------------------
# the train step and the driver on the mesh


def test_train_cli_on_the_smoke_mesh():
    """``train --smoke --steps 2 --mesh smoke --device cpu`` trains
    DTensor state on one gloo rank, gives the plain run's losses within the
    bf16 bar, and destroys the process group it started."""
    argv = ["--smoke", "--steps", "2", "--device", "cpu"]
    r = T.main(argv + ["--mesh", "smoke"])
    assert not dist.is_initialized()
    assert len(r.losses) == 2 and r.end_step == 2
    assert all(isinstance(x, DTensor) for _, x in _flatten(r.state))
    plain = T.main(argv)
    np.testing.assert_allclose(r.losses, plain.losses, rtol=5e-2)


@pytest.mark.parametrize("multi_pod,ranks", [(False, 256), (True, 512)])
def test_production_mesh_in_a_one_process_world_raises(monkeypatch,
                                                        multi_pod, ranks):
    """``--mesh production`` joins the world (here one gloo rank on this
    machine) and raises, naming the ranks the mesh needs; the driver
    destroys the group it started."""
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    argv = ["--smoke", "--steps", "1", "--device", "cpu", "--mesh",
            "production"] + ["--multi-pod"] * multi_pod
    with pytest.raises(RuntimeError, match=f"{ranks} ranks, found 1"):
        T.main(argv)
    assert not dist.is_initialized()


def test_multi_pod_needs_the_production_mesh():
    with pytest.raises(SystemExit):
        T.main(["--smoke", "--device", "cpu", "--mesh", "smoke",
                "--multi-pod"])
    assert not dist.is_initialized()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
