"""Training driver: the fault-tolerant loop over the train step of any arch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --shape train_4k --steps 100 [--smoke] [--ckpt-dir /path] \
        [--fail-at 30,60] [--resume] [--device cpu] \
        [--mesh none|smoke|auto|production] [--multi-pod]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --mesh auto

Any of the ten archs (``--arch``); runs on the card unless ``--device cpu``
is given; ``--smoke`` uses the reduced config at 4 x 128 tokens. The model
is trained as ``cfg.replace(use_flash=True)``, so every layer's forward
self-attention runs the ``flash_attention`` kernel (its backward goes
through the plain version; cross-attention stays the einsum, as in the
reference); the kernel takes head dims 16 to 128 in steps of 16. Weights
are random, drawn from a seeded generator on the device; batches come from
``SyntheticLMData`` (seed 0), with its ``image_embeds`` / ``frames`` for
vlm and audio models; the loss carries MoE models' router aux. ``--lr`` is
accepted and ignored, as in the JAX package's driver (the schedule's peak
is the optimizer's default).

``--mesh`` trains on a device mesh as the reference's driver does
(``src/repro/launch/train.py``): state and batches are DTensors laid out by
``train_shardings`` under ``rules_for(cfg)``, each gradient is synced to
its parameter's placements, the loss is reduced to one replicated value,
and checkpoints are saved from and restored onto the mesh. ``smoke`` is
``make_smoke_mesh()`` (one rank: gloo with ``--device cpu``, nccl on the
card); ``auto`` is ``make_mesh_for()`` over the world that ``torchrun``
started, one process a card (gloo on the CPU with ``--device cpu``);
``production`` is the reference's (16, 16) mesh, or (2, 16, 16) with
``--multi-pod``, which needs a world of 256 or 512 ranks. Rank 0 prints.
The default, ``none``, trains plain tensors on one card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Callable, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import MESH_FLAGS, mesh_for_flag
from repro_torch.models import LM
from repro_torch.models.params import Tree
from repro_torch.runtime import (FailureInjector, FaultTolerantLoop,
                                 StragglerPolicy)


@dataclasses.dataclass
class Trained:
    model: LM
    state: Tree
    losses: List[float]           # one per step run, restarts included
    step_times: List[float]       # seconds a step, host clock after a sync
    end_step: int
    history: List[str]            # the loop's failure / restore events
    seconds: float                # the whole loop


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _replicated(loss: torch.Tensor) -> torch.Tensor:
    """The loss as one value on every rank (the reference's replicated
    ``out_shardings``): a DTensor's partial or sharded placements reduced."""
    return loss.full_tensor() if isinstance(loss, DTensor) else loss


def train(cfg: ModelConfig, shape: ShapeSpec, *, steps: int, device=None,
          mesh: Optional[DeviceMesh] = None, ckpt_dir: str = "",
          ckpt_every: int = 50, fail_at: Iterable[int] = (),
          resume: bool = False, seed: int = 0,
          log: Callable[[str], None] = print) -> Trained:
    """Train ``cfg`` (random init from ``seed``) for ``steps`` steps of
    ``shape.global_batch`` x ``shape.seq_len`` tokens.

    With ``mesh``, the state and each batch are DTensors laid out by
    ``train_shardings`` and the steps run under ``rules_for(cfg)``, as the
    reference's driver runs them; checkpoints are restored onto the same
    layout. Every rank draws the whole state from ``seed`` before it is
    laid out."""
    dev = resolve_device(device)
    model = LM(cfg.replace(use_flash=True))
    opt_cfg = S.make_optimizer_config(cfg, total_steps=steps)
    data = SyntheticLMData(cfg, shape, seed=0, device=dev)
    state = S.init_train_state(
        model, opt_cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    st_sh, batch_fn, rules = None, data.batch, contextlib.nullcontext()
    if mesh is not None:
        st_sh, b_sh = S.train_shardings(model, opt_cfg, mesh, shape)
        state = S.place_tree(state, st_sh)
        batch_fn = lambda s: S.place_tree(data.batch(s), b_sh)  # noqa: E731
        rules = use_rules(S.rules_for(model.cfg))
    step_fn = S.make_train_step(
        model, opt_cfg, grad_specs=None if st_sh is None else st_sh["params"])

    mgr = None
    start = 0
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        if resume:
            st, restored = mgr.restore_latest(state, st_sh)
            if restored is not None:
                start, state = st, restored
                log(f"[train] resumed from step {start}")

    losses: List[float] = []
    times: List[float] = []

    def wrapped_step(st, batch):
        t0 = time.perf_counter()
        st2, loss = step_fn(st, batch)
        losses.append(float(_replicated(loss)))   # waits for the step's work
        _sync(dev)
        times.append(time.perf_counter() - t0)
        return st2

    loop = FaultTolerantLoop(
        step_fn=wrapped_step,
        batch_fn=batch_fn,
        ckpt_save=(lambda s, st: mgr.save(s, st)) if mgr else
        (lambda s, st: None),
        # the step and AdamW update ``state``'s tensors in place, and restore
        # copies into them (on a mesh, each rank's shard): after a restore
        # the loop goes on with the same tensors, and no second train state
        # is held
        ckpt_restore=(lambda: mgr.restore_latest(state, st_sh)) if mgr else
        (lambda: (None, None)),
        checkpoint_every=ckpt_every,
        injector=FailureInjector(fail_at={int(s): "injected"
                                          for s in fail_at}),
        straggler=StragglerPolicy(),
    )
    t0 = time.perf_counter()
    with rules:
        state, end_step, history = loop.run(state, start, steps)
    seconds = time.perf_counter() - t0
    if mgr:
        mgr.wait()
    return Trained(model, state, losses, times, end_step, history, seconds)


def main(argv: Optional[List[str]] = None) -> Trained:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="llama3-8b")
    ap.add_argument("--shape", choices=sorted(SHAPES), default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config at 4 x 128 tokens")
    ap.add_argument("--batch", type=int, default=0,
                    help="override global batch (smoke default 4)")
    ap.add_argument("--seq", type=int, default=0,
                    help="override sequence length (smoke default 128)")
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="accepted and ignored, as in the JAX package")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", default="",
                    help="comma-separated steps at which to inject failures")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", choices=MESH_FLAGS, default="none")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --mesh production: the (2, 16, 16) mesh "
                    "over pods")
    args = ap.parse_args(argv)
    if args.multi_pod and args.mesh != "production":
        ap.error("--multi-pod needs --mesh production")

    cfg = get_config(args.arch)
    shape = SHAPES[args.shape]
    if args.smoke:
        cfg = cfg.smoke()
        shape = ShapeSpec(shape.name, args.seq or 128, args.batch or 4,
                          shape.kind)
    elif args.batch or args.seq:
        shape = ShapeSpec(shape.name, args.seq or shape.seq_len,
                          args.batch or shape.global_batch, shape.kind)

    started = args.mesh != "none" and not dist.is_initialized()
    try:
        device, mesh = mesh_for_flag(args.mesh, args.device,
                                     multi_pod=args.multi_pod)
        r = train(cfg, shape, steps=args.steps, device=device, mesh=mesh,
                  ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                  fail_at=[int(s) for s in args.fail_at.split(",") if s],
                  resume=args.resume)
        rank = 0 if mesh is None else mesh.get_rank()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    if rank != 0:
        return r
    ls, dt = r.losses, r.seconds
    where = "" if mesh is None else f" on {mesh}"
    print(f"[train] {args.arch} {cfg.name}{where}: {len(ls)} steps in "
          f"{dt:.1f}s ({dt / max(1, len(ls)):.2f}s/step)")
    if ls:
        k = max(1, len(ls) // 10)
        print(f"[train] loss {ls[0]:.4f} -> {sum(ls[-k:]) / k:.4f} "
              f"(first -> mean of last {k})")
    if r.history:
        print(f"[train] events: {r.history}")
    return r


if __name__ == "__main__":
    main()
