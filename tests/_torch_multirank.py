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
  both wrappers run their plain versions).
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
         + ["flash-train-dense-sp"])
#: the card host's phase: the cases that the faults broke, at their cheapest
CHEAPEST = ["write-uneven", "serve-dense-cache_seq", "flash-dense-cache_seq"]
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
                _run(case, mesh)
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


def _run(case: str, mesh) -> None:
    kind, *rest = case.split("-")
    if kind == "write":
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


def _place(tree, shardings):
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda t, sh: distribute_tensor(t, *sh), tree, shardings)


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
        dparams = _place(params, p_sh)
        dcache = _place(tree_map(lambda t: t.float(), model.init_cache(
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
        loss1, g1 = S.loss_and_grads(model, _place(params, st_sh["params"]),
                                     dbatch)
    what = f"train {family} under sp{' with use_flash' * flash}"
    _close(loss1, loss0, f"{what}: loss", RTOL, 0)
    for i, (a, b) in enumerate(zip(tree_leaves(g1), tree_leaves(g0))):
        # relative to the gradient's scale: entries near 0 sum in
        # another order on 4 ranks
        _close(a, b, f"{what}: gradient {i} {tuple(b.shape)}", RTOL,
               RTOL * float(b.abs().max()))
