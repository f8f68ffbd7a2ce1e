"""The port's model on DTensors: every family's train, prefill and decode
steps run on meta DTensors under every sharding profile, and on a one-rank
CPU mesh its loss and gradients on DTensors equal those on plain tensors.

The meta steps run on a (4, 4) mesh with the production axis names over a
``"fake"`` world of 16 ranks, whose axes divide the smoke configs' widths
(4 heads, d_model 64) as the production (16, 16) mesh divides the shipped
configs'; the production meshes run the full-size cells
(``python -m repro_torch.launch.dryrun --all``). Each test starts and
destroys its own process group. This file runs the dense, MoE and vision
families; ``test_torch_dryrun_models_ssm.py`` the RWKV6 and hybrid ones,
``test_torch_dryrun_models_audio.py`` whisper (``tests/_torch_dryrun.py``
holds the shared set-up).
"""

import math

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, distribute_tensor  # noqa: E402

from _torch_dryrun import (FAMILIES, PROFILES, SEQ, check_steps,  # noqa: E402
                           fake_mesh)
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def fresh_sharding_cache():
    D.clear_sharding_cache()


@pytest.fixture
def mesh():
    yield from fake_mesh()


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_steps_run_on_meta_dtensors(mesh, family, profile):
    check_steps(mesh, family, profile)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_rank_dtensors_equal_plain_tensors(family):
    """On ``make_smoke_mesh("cpu")`` (one gloo rank) the loss and every
    gradient of the smoke config at one unit of depth, in f32, on DTensors
    laid out by ``train_shardings`` equal those on plain tensors."""
    cfg = D.make_probe_cfg(ARCHS[FAMILIES[family]].smoke(), 1).replace(
        attn_impl="auto")
    model = LM(cfg)
    shape = ShapeSpec("train", SEQ, 2, "train")
    params = tree_map(lambda t: t.float(),
                      model.init(torch.Generator().manual_seed(0), "cpu"))
    batch = SyntheticLMData(cfg, shape, seed=0, device="cpu").batch(0)
    # f32, and whisper's 1500 stub frames cut to 16 (the encoder takes any)
    batch = {k: v[:, :16].float() if v.is_floating_point() else v
             for k, v in batch.items()}
    loss0, g0 = S.loss_and_grads(model, params, batch)
    mesh = make_smoke_mesh("cpu")
    try:
        st_sh, b_sh = S.train_shardings(model, S.make_optimizer_config(cfg),
                                        mesh, shape)
        dparams = tree_map(lambda t, sh: distribute_tensor(t, *sh), params,
                           st_sh["params"])
        dbatch = {k: distribute_tensor(v, *b_sh[k]) for k, v in
                  batch.items()}
        with shd.use_rules(S.rules_for(cfg)):
            loss1, g1 = S.loss_and_grads(model, dparams, dbatch)
        assert isinstance(loss1, DTensor)
        assert math.isfinite(float(loss0))
        torch.testing.assert_close(loss1.full_tensor(), loss0, rtol=1e-6,
                                   atol=1e-6)
        for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
            assert isinstance(a, DTensor)
            torch.testing.assert_close(a.full_tensor(), b, rtol=1e-5,
                                       atol=1e-6)
    finally:
        dist.destroy_process_group()
