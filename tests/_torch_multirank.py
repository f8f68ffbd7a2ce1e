"""The port's model on a real world of 4 gloo ranks on the CPU, held to the
same steps on plain tensors.

One ``torch.multiprocessing.spawn`` starts the world (a ``FileStore``, no
network) with a (2, 2) ``("data", "model")`` mesh, and runs every case in
it; rank 0 writes each case's verdict to a JSON file that the tests read.
It imports torch and the port only, so ``chip_smoke.py`` runs its cheapest
case on the card host's torch as well.

Cases (``CASES``):

* ``write-*``: a bare DTensor cache ``[2, 2, T, 4]`` written through
  ``layers.write_slots`` at slots 6 to 9, across two ranks' shards (``even``:
  16 slots on the model axis; ``uneven``: 15 slots, ``torch.chunk``'s 8 and
  7; ``nested``: 16 slots split over both mesh axes);
* ``serve-<family>-<profile>``: the smoke config at one unit of depth, in
  f32, laid out by ``serve_shardings``: a prefill of 8 tokens into a
  16-slot cache, then 4 decode steps, the logits and the whole cache held
  to plain tensors; profiles ``tp`` (the default rules: the cache sharded
  on its head dim), ``sp`` (sequence parallelism) and ``cache_seq``
  (``decode_cache_shard="seq"``: the cache sharded on its slots);
* ``train-<family>-sp``: one train step's loss and every gradient under
  sequence parallelism, laid out by ``train_shardings``;
* ``flash-<family>-<profile>`` and ``flash-train-dense-sp``: the same under
  ``use_flash``, held to the same run on plain tensors: every decode step
  through ``flash_decode`` on each rank's shards (the partial form and a
  merge over the ranks where the slots are sharded, a gather of the head
  dim under ``tp``), and the train step's attention through
  ``flash_attention`` on each rank's rows with their offset (on the CPU
  both wrappers run their plain versions);
* ``train-driver``: ``launch.train.train(mesh=)`` for 3 steps in f32 (the
  default rules, every layer's attention through ``flash_attention``),
  its losses and final parameters held to the plain one-process run;
* ``ckpt-reshard``: a train state saved from the (2, 2) mesh through
  ``CheckpointManager``, restored in place on (2, 2), onto a (1, 4) mesh
  (its layout from ``train_shardings`` there) and into plain tensors, each
  equal to the saved whole values;
* ``train-fault``: the driver on the mesh with checkpoints every 2 steps
  and a failure injected at step 3: it restores step 2, and its losses
  after the restore and its final state equal the clean mesh run's (the
  reference's faulty == clean bar).
"""

from __future__ import annotations

import datetime
import json
import os
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

ARCH = {"dense": "llama3-8b", "hybrid": "zamba2-2.7b"}
PROFILES = {"tp": {}, "sp": dict(sequence_parallel=True),
            "cache_seq": dict(decode_cache_shard="seq")}
CASES = (["write-even", "write-uneven", "write-nested"]
         + [f"serve-{f}-{p}" for f in ARCH for p in PROFILES]
         + [f"train-{f}-sp" for f in ARCH]
         + [f"flash-{f}-{p}" for f in ARCH for p in PROFILES]
         + ["flash-train-dense-sp", "train-driver", "ckpt-reshard",
            "train-fault"])
#: the card host's phase: the cases that the faults broke, at their cheapest
CHEAPEST = ["write-uneven", "serve-dense-cache_seq", "flash-dense-cache_seq",
            "ckpt-reshard"]
WORLD, MESH = 4, (2, 2)
BATCH, PROMPT, SLOTS, STEPS = 2, 8, 16, 4
RTOL = ATOL = 1e-4


def run_world(cases, out_path: str, store_path: str) -> dict:
    """Spawn the world, run ``cases`` in it, and return rank 0's verdicts:
    ``{case: None or the mismatch's message}`` and ``"torch"``."""
    torch.multiprocessing.spawn(_rank, args=(list(cases), out_path,
                                             store_path),
                                nprocs=WORLD, join=True)
    with open(out_path) as f:
        return json.load(f)


def _rank(rank: int, cases, out_path: str, store_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
        # DTensor's cached sharding decisions leave out `topk`'s k, which
        # these families do not call: cleared once, then shared by the cases
        from repro_torch.launch.dryrun import clear_sharding_cache
        clear_sharding_cache()
        out = {"torch": torch.__version__}
        for case in cases:
            try:
                _run(case, mesh, os.path.dirname(out_path))
                out[case] = None
            except AssertionError as e:
                out[case] = str(e)
            except Exception:
                out[case] = traceback.format_exc()
            dist.barrier()
        if rank == 0:
            tmp = out_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(out, f, indent=1)
            os.replace(tmp, out_path)
    finally:
        dist.destroy_process_group()


def _run(case: str, mesh, work: str) -> None:
    kind, *rest = case.split("-")
    if case == "train-driver":
        _driver_case(mesh)
    elif case == "ckpt-reshard":
        _reshard_case(mesh, os.path.join(work, case))
    elif case == "train-fault":
        _fault_case(mesh, os.path.join(work, case))
    elif kind == "write":
        _write_case(rest[0], mesh)
    elif kind == "serve":
        _serve_case(*rest, mesh)
    elif kind == "flash" and rest[0] == "train":
        _train_case(rest[1], mesh, flash=True)
    elif kind == "flash":
        _serve_case(*rest, mesh, flash=True)
    else:
        _train_case(rest[0], mesh)


def _close(got, want, what: str, rtol: float = RTOL, atol: float = ATOL):
    if isinstance(got, DTensor):
        got = got.full_tensor()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")


def _write_case(layout: str, mesh) -> None:
    from repro_torch.models.layers import write_slots
    slots = 15 if layout == "uneven" else 16
    pl = ([Shard(2), Shard(2)] if layout == "nested"
          else [Replicate(), Shard(2)])
    g = torch.Generator().manual_seed(0)
    plain = torch.zeros(2, 2, slots, 4)
    new = torch.randn(2, 2, 4, 4, generator=g)
    cache = distribute_tensor(plain.clone(), mesh, pl)
    write_slots(cache, distribute_tensor(new, mesh, [Replicate()] * 2), 6)
    write_slots(plain, new, 6)
    _close(cache, plain, f"{layout} cache [2, 2, {slots}, 4] {pl}", 0, 0)


def _setup(family: str, profile: str, flash: bool = False):
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun as D
    from repro_torch.models import LM
    from repro_torch.optim.adamw import tree_map
    cfg = D.make_probe_cfg(ARCHS[ARCH[family]].smoke(), 1).replace(
        attn_impl="auto", use_flash=flash, **PROFILES[profile])
    model = LM(cfg)
    params = tree_map(lambda t: t.float(),
                      model.init(torch.Generator().manual_seed(0), "cpu"))
    return cfg, model, params


def _serve_case(family: str, profile: str, mesh, flash: bool = False
                ) -> None:
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg, model, params = _setup(family, profile, flash)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT + STEPS),
                           generator=torch.Generator().manual_seed(1))
    prefill, decode = S.make_prefill_step(model), S.make_decode_step(model)

    def run(params, cache, batch):
        logits = [prefill(params, batch(tokens[:, :PROMPT], "prefill"),
                          cache)[0]]
        for i in range(STEPS):
            pos = PROMPT + i
            logits.append(decode(params, batch(tokens[:, pos:pos + 1],
                                               "decode"), cache, pos)[0])
        return logits

    plain_cache = tree_map(lambda t: t.float(), model.init_cache(
        BATCH, SLOTS, "cpu"))
    want = run(params, plain_cache, lambda t, _: {"tokens": t})

    p_sh, pb_sh, _ = S.serve_shardings(
        model, mesh, ShapeSpec("prefill", PROMPT, BATCH, "prefill"))
    _, db_sh, c_sh = S.serve_shardings(
        model, mesh, ShapeSpec("decode", SLOTS, BATCH, "decode"))
    with torch.inference_mode():
        dparams = S.place_tree(params, p_sh)
        dcache = S.place_tree(tree_map(lambda t: t.float(), model.init_cache(
            BATCH, SLOTS, "cpu")), c_sh)

    def dbatch(t, kind):
        sh = (pb_sh if kind == "prefill" else db_sh)["tokens"]
        with torch.inference_mode():
            return {"tokens": distribute_tensor(t, *sh)}
    with shd.use_rules(S.rules_for(cfg)):
        got = run(dparams, dcache, dbatch)
    what = f"serve {family} under {profile}{' with use_flash' * flash}"
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"{what}: logits of step {i}")
    for i, (a, b) in enumerate(zip(tree_leaves(dcache),
                                   tree_leaves(plain_cache))):
        _close(a, b, f"{what}: cache leaf {i} {tuple(b.shape)}")


def _train_case(family: str, mesh, flash: bool = False) -> None:
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.optim.adamw import tree_leaves
    cfg, model, params = _setup(family, "sp", flash)
    if flash and model._impl(PROMPT) != "flash":
        raise AssertionError(f"train {family}: attention {model._impl(PROMPT)}"
                             f", not the flash branch")
    shape = ShapeSpec("train", PROMPT, BATCH, "train")
    batch = SyntheticLMData(cfg, shape, seed=0, device="cpu").batch(0)
    loss0, g0 = S.loss_and_grads(model, params, batch)
    st_sh, b_sh = S.train_shardings(model, S.make_optimizer_config(cfg),
                                    mesh, shape)
    dbatch = {k: distribute_tensor(v, *b_sh[k]) for k, v in batch.items()}
    with shd.use_rules(S.rules_for(cfg)):
        loss1, g1 = S.loss_and_grads(
            model, S.place_tree(params, st_sh["params"]), dbatch)
    what = f"train {family} under sp{' with use_flash' * flash}"
    _close(loss1, loss0, f"{what}: loss", RTOL, 0)
    for i, (a, b) in enumerate(zip(tree_leaves(g1), tree_leaves(g0))):
        # relative to the gradient's scale: entries near 0 sum in
        # another order on 4 ranks
        _close(a, b, f"{what}: gradient {i} {tuple(b.shape)}", RTOL,
               RTOL * float(b.abs().max()))


TRAIN_SHAPE = ("train", PROMPT, BATCH, "train")


def _f32_train_state(init):
    """``steps.init_train_state`` with f32 parameters: on 4 ranks the bf16
    partial sums of a sharded product round apart from one rank's sums by
    more than ``RTOL``."""
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_map

    def f32(model, opt_cfg, generator, device=None):
        params = tree_map(lambda t: t.float(),
                          init(model, opt_cfg, generator, device)["params"])
        return {"params": params, "opt": adamw_init(params, opt_cfg)}
    return f32


def _driver(**kw):
    """``train`` of llama3's smoke config at one unit of depth, in f32, for
    ``kw["steps"]`` steps of BATCH x PROMPT tokens."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as T
    cfg = D.make_probe_cfg(ARCHS["llama3-8b"].smoke(), 1).replace(
        attn_impl="auto")
    init = S.init_train_state
    S.init_train_state = _f32_train_state(init)
    try:
        r = T.train(cfg, ShapeSpec(*TRAIN_SHAPE), device="cpu",
                    log=lambda m: None, **kw)
    finally:
        S.init_train_state = init
    if r.model._impl(PROMPT) != "flash":
        raise AssertionError(f"train: attention {r.model._impl(PROMPT)}, "
                             f"not the flash branch")
    return r


def _close_states(got, want, what: str, rtol: float = RTOL) -> None:
    from repro_torch.checkpoint.ckpt import _flatten
    g, w = _flatten(got), _flatten(want)
    if [p for p, _ in g] != [p for p, _ in w]:
        raise AssertionError(f"{what}: leaves {[p for p, _ in g]}")
    for (p, a), (_, b) in zip(g, w):
        b = b.full_tensor() if isinstance(b, DTensor) else b
        _close(a, b, f"{what}: {p}", rtol, rtol * float(b.abs().max()))


def _driver_case(mesh) -> None:
    got = _driver(steps=3, mesh=mesh)
    want = _driver(steps=3)
    _close(torch.tensor(got.losses), torch.tensor(want.losses),
           "train(mesh=): losses", RTOL, 0)
    _close_states(got.state["params"], want.state["params"],
                  "train(mesh=): final parameters")


def _fault_case(mesh, work: str) -> None:
    clean = _driver(steps=5, mesh=mesh, ckpt_dir=os.path.join(work, "clean"),
                    ckpt_every=2)
    faulty = _driver(steps=5, mesh=mesh, ckpt_every=2, fail_at=[3],
                     ckpt_dir=os.path.join(work, "faulty"))
    if faulty.history != ["failure@3:injected", "restored@2"] or \
            faulty.end_step != 5 or len(faulty.losses) != 6:
        raise AssertionError(f"train with a failure at step 3: history "
                             f"{faulty.history}, end step {faulty.end_step},"
                             f" {len(faulty.losses)} losses")
    # steps 0-2, then 2-4 again from the step-2 checkpoint
    _close(torch.tensor(faulty.losses),
           torch.tensor(clean.losses[:3] + clean.losses[2:]),
           "faulty against clean: losses", RTOL, 0)
    _close_states(faulty.state, clean.state, "faulty against clean")


def _reshard_case(mesh, work: str) -> None:
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps as S
    from repro_torch.models import LM
    cfg = ARCHS["llama3-8b"].smoke().replace(grad_compress=True)
    model, shape = LM(cfg), ShapeSpec(*TRAIN_SHAPE)
    opt = S.make_optimizer_config(cfg, total_steps=4)

    def state(seed):
        st = S.init_train_state(model, opt, torch.Generator().manual_seed(
            seed), "cpu")
        for i, (_, x) in enumerate(_flatten(st["opt"])):
            x.add_(i)                 # moments and error feedback not 0
        return st
    whole = state(0)
    saved = state(0)
    st_sh, _ = S.train_shardings(model, opt, mesh, shape)
    mgr = CheckpointManager(work, keep=1)
    mgr.save(2, S.place_tree(saved, st_sh))
    mgr.wait()

    def check(got, what, sh=None):
        for p, x in _flatten(got):
            if sh is not None and (not isinstance(x, DTensor) or tuple(
                    x.placements) != tuple(sh[p][1])):
                raise AssertionError(f"{what}: {p} laid out "
                                     f"{getattr(x, 'placements', 'plain')}")
        _close_states(got, whole, what)

    like = S.place_tree(state(1), st_sh)
    step, got = mgr.restore_latest(like)
    if step != 2 or got is not like:
        raise AssertionError(f"restore in place: step {step}")
    check(got, "(2, 2) -> (2, 2) in place", dict(_flatten(st_sh)))
    mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    sh14, _ = S.train_shardings(model, opt, mesh14, shape)
    if not any(p.is_shard() and m.size(i) > 1 for m, pl in
               dict(_flatten(sh14)).values() for i, p in enumerate(pl)):
        raise AssertionError("the (1, 4) layout shards nothing")
    check(restore_checkpoint(work, 2, S.train_state_shapes(model, opt),
                             shardings=sh14),
          "(2, 2) -> (1, 4)", dict(_flatten(sh14)))
    plain = restore_checkpoint(work, 2, state(1))
    if any(isinstance(x, DTensor) for _, x in _flatten(plain)):
        raise AssertionError("(2, 2) -> plain tensors: a DTensor came back")
    check(plain, "(2, 2) -> plain tensors")
