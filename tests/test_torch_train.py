"""The port's training path against the JAX package's, on the CPU.

Reference parameters are converted with ``params_from_reference`` and both
sides see the same numpy batches. f32 is held at 1e-4 (the same arithmetic
in another summation order); bf16 at the reference's own bars. The
reference's train step is run unsharded (jit, no mesh): its sharded step
does not run under the installed jax (ROADMAP, section 3).
"""

import contextlib
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro.checkpoint import ckpt as ref_ckpt  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as RefShape  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RefData  # noqa: E402
from repro.launch import steps as RS  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import schedules as ref_sched  # noqa: E402
from repro.runtime import fault_tolerance as ref_ft  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.distributed.sharding import use_rules  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.launch.mesh import make_smoke_mesh  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.optim import adamw as port_adamw  # noqa: E402
from repro_torch.optim import schedules as port_sched  # noqa: E402
from repro_torch.runtime import fault_tolerance as port_ft  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FA_MOD = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
KW = dict(num_kv_heads=2)          # GQA with G = 2 on the smoke config
B, S_LEN = 2, 16


def _cfgs(**kw):
    kw = {**KW, **kw}
    return (ref_get_config("llama3-8b").smoke().replace(**kw),
            get_config("llama3-8b").smoke().replace(**kw))


def _ref_params(rcfg, dtype=None):
    params = jax.tree.map(np.asarray, RefLM(rcfg).init(jax.random.PRNGKey(0)))
    if dtype is not None:
        params = jax.tree.map(lambda a: a.astype(dtype), params)
    return params


def _batch(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S_LEN + 1)).astype("int32")
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{pre}{k}.")
        else:
            yield f"{pre}{k}", v


def _assert_tree_close(got, want, tol):
    want = dict(_flat(want))
    got = dict(_flat(got))
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(
            got[n].detach().float().numpy(), np.asarray(want[n], np.float32),
            rtol=tol, atol=tol, err_msg=n)


# ---------------------------------------------------------------------------
# loss and forward


@pytest.mark.parametrize("ref_impl,port_kw", [
    ("einsum", dict(attn_impl="einsum")),
    ("blockwise", dict(attn_impl="blockwise")),
    ("einsum", dict(use_flash=True)),        # the port trains so
])
def test_loss_and_grads_match_reference(ref_impl, port_kw):
    rcfg, _ = _cfgs(attn_impl=ref_impl)
    _, cfg = _cfgs(**port_kw)
    rparams = _ref_params(rcfg, np.float32)
    batch = _batch(cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(RefLM(rcfg).loss))(
        rparams, batch)

    params = params_from_reference(rparams, "cpu")
    leaves = [p.requires_grad_() for _, p in _flat(params)]
    loss = LM(cfg).loss(params, _tbatch(batch))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    got = dict(zip([n for n, _ in _flat(params)], grads))
    for n, g in _flat(want_grads):
        np.testing.assert_allclose(got[n].numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-4, err_msg=n)


@pytest.mark.parametrize("dt,tol", [("float32", 2e-3), ("bfloat16", 6e-2)])
def test_flash_forward_matches_reference_flash_forward(dt, tol):
    """The port's use_flash forward against the reference's Pallas flash
    forward (interpret mode), as tests/test_models.py holds the reference."""
    rcfg, cfg = _cfgs(attn_impl="flash")
    rparams = _ref_params(rcfg, getattr(jnp, dt))
    batch = _batch(cfg, seed=1)
    want, _ = jax.jit(RefLM(rcfg).forward)(rparams, batch)
    got, _ = LM(cfg.replace(attn_impl="auto", use_flash=True)).forward(
        params_from_reference(rparams, "cpu"), _tbatch(batch))
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_remat_policies():
    _, cfg = _cfgs()
    params = params_from_reference(_ref_params(_cfgs()[0], np.float32), "cpu")
    batch = _tbatch(_batch(cfg))
    out = {}
    for remat in ("full", "dots", "none"):
        leaves = [p.requires_grad_() for _, p in _flat(params)]
        loss = LM(cfg.replace(remat=remat)).loss(params, batch)
        out[remat] = (loss, torch.autograd.grad(loss, leaves))
    for remat in ("dots", "none"):
        torch.testing.assert_close(out["full"][0], out[remat][0])
        for a, b in zip(out["full"][1], out[remat][1]):
            torch.testing.assert_close(a, b)
    with pytest.raises(ValueError, match="remat"):
        LM(cfg.replace(remat="some")).loss(params, batch)


@pytest.fixture
def fake_kernel(monkeypatch):
    """Route CPU tensors through the autograd Function, its launch replaced by
    the plain version and counted (the CUDA kernel cannot run here)."""
    def launch(q, k, v, causal, q_off=0):
        flash_attention.launches += 1
        return flash_attention_plain(q, k, v, causal=causal, q_off=q_off)
    monkeypatch.setattr(FA_MOD, "_launch", launch)
    # the model reaches the kernel through ops.gqa_attention
    ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, causal=True, q_off=0:
                        FA_MOD._FlashAttention.apply(q, k, v, causal, q_off))
    monkeypatch.setattr(flash_attention, "launches", 0)


@pytest.mark.parametrize("remat,per_layer", [("full", 2), ("dots", 2),
                                             ("none", 1)])
def test_train_step_launch_count_under_remat(fake_kernel, remat, per_layer):
    """Under remat="full" each layer's forward runs twice a step (the
    forward, then its recompute in backward), so the kernel launches
    2 x layers a step; under "dots" too (the kernel is no product, so it is
    recomputed); without remat, once."""
    rcfg, cfg = _cfgs(remat=remat)
    model = LM(cfg.replace(use_flash=True))
    opt_cfg = S.make_optimizer_config(cfg, total_steps=4)
    state = {"params": params_from_reference(_ref_params(rcfg), "cpu")}
    state["opt"] = port_adamw.adamw_init(state["params"], opt_cfg)
    step = S.make_train_step(model, opt_cfg)
    for i in range(2):
        state, loss = step(state, _tbatch(_batch(cfg, seed=i)))
        assert torch.isfinite(loss)
    assert flash_attention.launches == per_layer * cfg.num_layers * 2


# ---------------------------------------------------------------------------
# optimizer, schedules, data


def _opt_trees(rng):
    shapes = {"w": ((8, 6), np.float32), "b": ((6,), np.float32),
              "e": ((5, 4), jnp.bfloat16)}
    params = {n: rng.normal(size=s).astype(d) for n, (s, d) in shapes.items()}
    grads = [{n: (0.5 * rng.normal(size=s)).astype(d)
              for n, (s, d) in shapes.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("compress", [False, True])
def test_adamw_update_matches_reference_over_3_steps(compress):
    rng = np.random.default_rng(2)
    params, grads = _opt_trees(rng)
    rcfg = ref_adamw.make_optimizer("adamw", total_steps=10,
                                    grad_compress=compress)
    pcfg = port_adamw.make_optimizer("adamw", total_steps=10,
                                     grad_compress=compress)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_adamw.adamw_init(rp, rcfg)
    tp = params_from_reference(params, "cpu")
    ts = port_adamw.adamw_init(tp, pcfg)
    for g in grads:
        rp, rs = jax.jit(ref_adamw.adamw_update, static_argnums=(3,))(
            rp, jax.tree.map(jnp.asarray, g), rs, rcfg)
        tp, ts = port_adamw.adamw_update(tp, params_from_reference(g, "cpu"),
                                         ts, pcfg)
    assert int(ts.step) == int(rs.step) == 3
    assert tp["e"].dtype == torch.bfloat16
    _assert_tree_close(tp, rp, 1e-6)
    _assert_tree_close(ts.mu, rs.mu, 1e-6)
    _assert_tree_close(ts.nu, rs.nu, 1e-6)
    if compress:
        _assert_tree_close(ts.error, rs.error, 1e-6)
    else:
        assert ts.error is None


def test_params_from_reference_copies_so_updates_stay_in_the_port():
    """The port updates in place; the arrays it was converted from (which a
    jax CPU array may share) must not change."""
    params, grads = _opt_trees(np.random.default_rng(2))
    keep = {n: a.copy() for n, a in params.items()}
    tp = params_from_reference(params, "cpu")
    cfg = port_adamw.make_optimizer("adamw", total_steps=10)
    port_adamw.adamw_update(tp, params_from_reference(grads[0], "cpu"),
                            port_adamw.adamw_init(tp, cfg), cfg)
    assert not torch.equal(tp["w"], torch.from_numpy(keep["w"]))
    for n in params:
        assert np.array_equal(params[n], keep[n]), n


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    _, grads = _opt_trees(rng)
    want, wnorm = ref_adamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads[0]), 0.5)
    got, norm = port_adamw.clip_by_global_norm(
        params_from_reference(grads[0], "cpu"), 0.5)
    np.testing.assert_allclose(norm.item(), float(wnorm), rtol=1e-6)
    _assert_tree_close(got, want, 1e-6)


@pytest.mark.parametrize("name", ["cosine_schedule", "wsd_schedule"])
def test_schedules_match_reference(name):
    for total in (7, 100, 1000):
        want = getattr(ref_sched, name)(3e-4, total)
        got = getattr(port_sched, name)(3e-4, total)
        steps = np.arange(total + 2, dtype=np.int32)
        w = np.asarray(jax.vmap(want)(jnp.asarray(steps)))
        g = np.array([got(torch.tensor(s)).item() for s in steps])
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_synthetic_data_is_byte_identical(kind):
    rcfg, cfg = _cfgs()
    want = RefData(rcfg, RefShape("x", 33, 3, kind), seed=5)
    got = SyntheticLMData(cfg, ShapeSpec("x", 33, 3, kind), seed=5,
                          device="cpu")
    for step in (0, 1, 17):
        w, g = want.batch(step), got.batch(step)
        assert w.keys() == g.keys()
        for k in w:
            assert g[k].dtype == torch.int64
            assert (g[k].numpy().astype(np.int32).tobytes()
                    == np.asarray(w[k]).tobytes())
    h = got.host_batch(1, 1, 3)
    assert torch.equal(h["tokens"], got.batch(1)["tokens"][1:2])


# ---------------------------------------------------------------------------
# the train step against the reference's unsharded train step


@pytest.mark.parametrize("dt,tol,on_mesh", [
    pytest.param(dt, tol, on_mesh, id=f"{dt}-{tol}" + "-mesh" * on_mesh)
    for on_mesh in (False, True)
    for dt, tol in (("float32", 1e-4), ("bfloat16", 5e-2))])
def test_three_train_steps_match_unsharded_reference(dt, tol, on_mesh):
    """``-mesh``: on ``make_smoke_mesh("cpu")`` (one gloo rank), state and
    batches laid out by ``train_shardings``, gradients synced by
    ``grad_specs``, under ``rules_for(cfg)``, the loss read replicated."""
    rcfg, cfg = _cfgs()
    rparams = _ref_params(rcfg, None if dt == "bfloat16" else np.float32)
    ropt = RS.make_optimizer_config(rcfg, total_steps=3)
    rstate = {"params": jax.tree.map(jnp.asarray, rparams),
              "opt": ref_adamw.adamw_init(rparams, ropt)}
    rstep = jax.jit(RS.make_train_step(RefLM(rcfg), ropt))

    model = LM(cfg.replace(use_flash=True))      # as the port trains
    popt = S.make_optimizer_config(cfg, total_steps=3)
    params = params_from_reference(rparams, "cpu")
    state = {"params": params, "opt": port_adamw.adamw_init(params, popt)}
    place, rules, grad_specs = (lambda t: t), contextlib.nullcontext(), None
    if on_mesh:
        mesh = make_smoke_mesh("cpu")
        st_sh, b_sh = S.train_shardings(model, popt, mesh,
                                        ShapeSpec("x", S_LEN, B, "train"))
        state = S.place_tree(state, st_sh)
        place = lambda t: S.place_tree(t, b_sh)  # noqa: E731
        rules, grad_specs = use_rules(S.rules_for(cfg)), st_sh["params"]
    step = S.make_train_step(model, popt, grad_specs=grad_specs)

    data = RefData(rcfg, RefShape("x", S_LEN, B, "train"))
    try:
        with rules:
            for i in range(3):
                batch = jax.tree.map(np.asarray, data.batch(i))
                rstate, want = rstep(rstate, batch)
                state, got = step(state, place(_tbatch(batch)))
                assert isinstance(got, DTensor) == on_mesh
                np.testing.assert_allclose(T._replicated(got).item(),
                                           float(want), rtol=tol, atol=tol)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert all(isinstance(x, DTensor) == on_mesh for _, x in _flatten(state))
    whole = (lambda x: x.full_tensor()) if on_mesh else (lambda x: x)
    assert int(whole(state["opt"].step)) == 3
    if dt == "float32":
        _assert_tree_close(port_adamw.tree_map(whole, state["params"]),
                           rstate["params"], 1e-4)


def test_four_steps_at_width_2048_match_reference_and_rise():
    """llama3-8b's 4-step schedule (one warm-up step, so step 1 runs the
    peak lr) at d_model 2048, 2 layers, 2 x 64 tokens, in bf16: the port's
    losses follow the reference's, and both rise. A rise over these steps
    is the reference's behaviour at width, not a fault of the port."""
    kw = dict(num_layers=2, d_model=2048, num_heads=16, num_kv_heads=4,
              head_dim=128, d_ff=7168, vocab_size=4096)
    rcfg, cfg = _cfgs(**kw)
    rparams = _ref_params(rcfg)
    ropt = RS.make_optimizer_config(rcfg, total_steps=4)
    rstate = {"params": jax.tree.map(jnp.asarray, rparams),
              "opt": ref_adamw.adamw_init(rparams, ropt)}
    rstep = jax.jit(RS.make_train_step(RefLM(rcfg), ropt))
    popt = S.make_optimizer_config(cfg, total_steps=4)
    params = params_from_reference(rparams, "cpu")
    state = {"params": params, "opt": port_adamw.adamw_init(params, popt)}
    step = S.make_train_step(LM(cfg.replace(use_flash=True)), popt)
    data = RefData(rcfg, RefShape("x", 64, 2, "train"))
    want, got = [], []
    for i in range(4):
        batch = jax.tree.map(np.asarray, data.batch(i))
        rstate, loss = rstep(rstate, batch)
        want.append(float(loss))
        state, loss = step(state, _tbatch(batch))
        got.append(loss.item())
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
    assert max(want[1:]) > want[0] + 0.1 and max(got[1:]) > got[0] + 0.1


# ---------------------------------------------------------------------------
# checkpoints and the fault-tolerant loop


def _small_state():
    _, cfg = _cfgs()
    model = LM(cfg)
    opt = S.make_optimizer_config(cfg.replace(grad_compress=True), 4)
    return S.init_train_state(model, opt, torch.Generator().manual_seed(3),
                              "cpu")


def test_checkpoint_round_trip(tmp_path):
    state = _small_state()
    state["opt"].step.fill_(7)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state)
    mgr.wait()
    assert latest_step(str(tmp_path)) == 3
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    like = _small_state()
    step, restored = mgr.restore_latest(like)
    assert step == 3 and int(restored["opt"].step) == 7
    assert type(restored["opt"]) is type(state["opt"])
    a, b = dict(_flat(state["params"])), dict(_flat(restored["params"]))
    for n in a:
        assert b[n].dtype == a[n].dtype and torch.equal(a[n], b[n])
    for x, y in zip(state["opt"].error.values(), restored["opt"].error.values()):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


def test_restore_fills_like_in_place(tmp_path):
    """Restore writes into ``like``'s tensors, so the trainer never holds
    a second train state beside the one it restores into."""
    state = _small_state()
    state["opt"].step.fill_(2)
    save_checkpoint(str(tmp_path), 2, state)
    like = _small_state()
    for x in _flatten_leaves(like):
        x.zero_()
    ptrs = [x.data_ptr() for x in _flatten_leaves(like)]
    got = restore_checkpoint(str(tmp_path), 2, like)
    assert got is like
    assert [x.data_ptr() for x in _flatten_leaves(got)] == ptrs
    for a, b in zip(_flatten_leaves(got), _flatten_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _flatten_leaves(state):
    opt = state["opt"]
    return ([v for _, v in _flat(state["params"])] + [opt.step]
            + [v for t in (opt.mu, opt.nu, opt.error) for _, v in _flat(t)])


def test_checkpoints_are_readable_across_packages(tmp_path):
    """The port writes the reference's layout and reads what it writes."""
    rcfg, _ = _cfgs()
    rparams = jax.tree.map(jnp.asarray, _ref_params(rcfg))
    ropt = ref_adamw.AdamWConfig()
    rstate = {"params": rparams, "opt": ref_adamw.adamw_init(rparams, ropt)}
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, rstate)

    params = params_from_reference(jax.tree.map(np.asarray, rparams), "cpu")
    like = {"params": params,
            "opt": port_adamw.adamw_init(params, port_adamw.AdamWConfig())}
    got = restore_checkpoint(str(tmp_path / "ref"), 5, like)
    _assert_tree_close(got["params"], rparams, 0)

    save_checkpoint(str(tmp_path / "port"), 6, got)
    back = ref_ckpt.restore_checkpoint(str(tmp_path / "port"), 6, rstate)
    for (n, a), (_, b) in zip(_flat(back["params"]), _flat(rparams)):
        assert a.dtype == b.dtype and np.array_equal(
            np.asarray(a, np.float32), np.asarray(b, np.float32)), n


@pytest.mark.parametrize("ft", [ref_ft, port_ft], ids=["reference", "port"])
def test_fault_tolerant_loop_recovers_from_injected_failure(ft):
    """The same scripted run through both copies of the loop: a failure at
    step 3 restores the step-2 checkpoint and replays steps 2 and 3."""
    saved, seen = {}, []

    def step_fn(state, batch):
        seen.append(batch)
        return state + batch

    loop = ft.FaultTolerantLoop(
        step_fn=step_fn, batch_fn=lambda s: s,
        ckpt_save=lambda s, st: saved.__setitem__(s, st),
        ckpt_restore=lambda: max(saved.items()) if saved else (None, None),
        checkpoint_every=2,
        injector=ft.FailureInjector(fail_at={3: "injected"}),
        straggler=ft.StragglerPolicy())
    state, end, history = loop.run(0, 0, 5)
    assert (state, end) == (sum(range(5)), 5)
    assert seen == [0, 1, 2, 2, 3, 4]
    assert history == ["failure@3:injected", "restored@2"]


# ---------------------------------------------------------------------------
# the entry point


@pytest.mark.parametrize("extra", [[], ["--fail-at", "2", "--ckpt-every",
                                        "1"]], ids=["plain", "fail_at"])
def test_train_cli_runs_on_cpu(extra, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    if extra:
        extra = extra + ["--ckpt-dir", str(tmp_path)]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "4", "--device", "cpu", "--batch", "2", "--seq", "32",
         *extra], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] llama3-8b llama3-8b-smoke: 4 steps" in out.stdout
    if extra:
        assert "failure@2:injected" in out.stdout
        assert "restored@2" in out.stdout
        assert latest_step(str(tmp_path)) == 4


def test_train_returns_losses_and_state():
    _, cfg = _cfgs()
    r = T.train(cfg, ShapeSpec("x", 16, 2, "train"), steps=3, device="cpu",
                log=lambda s: None)
    assert len(r.losses) == len(r.step_times) == 3 and r.end_step == 3
    assert all(np.isfinite(r.losses))
    assert int(r.state["opt"].step) == 3
    assert r.model.cfg.use_flash


def test_train_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.main(["--smoke", "--steps", "1"])


def test_smoke_cli_trains_head_dim_16_through_flash(fake_kernel, monkeypatch):
    """``train --smoke --steps 4 --device cpu``: the smoke config has head
    dim 16 and its 128-token sequences take the "flash" branch; every call
    passes the CUDA kernels' launch checks (d = 16 is a head dim they take)
    and is counted, 2 x layers a step under remat="full"."""
    def launch(q, k, v, causal, q_off=0):
        FA_MOD._check_launch(q, k, v)
        FA_MOD._check_launch(*(x.bfloat16() for x in (q, k, v)))
        flash_attention.launches += 1
        return flash_attention_plain(q, k, v, causal=causal, q_off=q_off)
    monkeypatch.setattr(FA_MOD, "_launch", launch)
    r = T.main(["--smoke", "--steps", "4", "--device", "cpu"])
    cfg = r.model.cfg
    assert cfg.head_dim == 16 and r.model._impl(128) == "flash"
    assert len(r.losses) == 4 and all(np.isfinite(r.losses))
    per_step = (2 if cfg.remat == "full" else 1) * cfg.num_layers
    assert flash_attention.launches == 4 * per_step
