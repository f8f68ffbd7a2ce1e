"""Serving driver: batched prefill + greedy decode loop with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --batch 4 --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --mesh smoke
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --mesh auto

``--mesh`` serves on a device mesh as the reference's driver does
(``src/repro/launch/serve.py``): parameters, batch and cache are DTensors
laid out by ``serve_shardings`` under ``rules_for(cfg)``, and the kernels
run on each rank's shards. ``smoke`` is ``make_smoke_mesh()`` (one rank,
nccl on the card); ``auto`` is ``make_mesh_for()`` over the world that
``torchrun`` started, one process a card. Rank 0 prints. The default,
``none``, serves plain tensors on one card.

Any of the ten archs (``--arch``); runs on the card unless ``--device cpu``
is given; ``--smoke`` uses the reduced config. The model is served as
``cfg.replace(use_flash=True)``, so every decode step runs its
self-attention through the ``flash_decode`` kernel (and whisper's encoder,
in prefill, through ``flash_attention``). Weights and prompts are random,
drawn from seeded generators on the device; vlm and audio prompts come with
the reference driver's stub inputs, ``0.1 * ones`` bf16 ``image_embeds``
[B, num_image_tokens, D] and ``frames`` [B, 1500, D]. Decoding is greedy;
``--temperature`` is accepted and ignored, as in the JAX package's driver.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import AUDIO_FRAMES, ModelConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import use_rules
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import mesh_for_flag
from repro_torch.models import LM
from repro_torch.models.params import Tree
from repro_torch.optim.adamw import tree_leaves


@dataclasses.dataclass
class Served:
    model: LM
    params: Tree                  # DTensors on a mesh
    cache: Tree                   # DTensors on a mesh
    prompts: torch.Tensor         # [B, prompt_len]
    tokens: torch.Tensor          # [B, gen] generated ids
    logits: torch.Tensor          # [gen, B, V] logits that chose each id
    next_pos: int                 # cache slot of the next (unfed) token
    prefill_s: float
    decode_s: float               # decode steps after the first, timed warm
    decode_steps: int             # how many steps decode_s covers


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_batch(model: LM, prompts: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """The prompts with the reference driver's stub inputs of vlm and audio
    models (``src/repro/launch/serve.py``)."""
    cfg = model.cfg
    b, dev = prompts.shape[0], prompts.device
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["image_embeds"] = 0.1 * torch.ones(
            (b, cfg.num_image_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
    if cfg.family == "audio":
        batch["frames"] = 0.1 * torch.ones(
            (b, AUDIO_FRAMES, cfg.d_model),
            dtype=torch.bfloat16, device=dev)
    return batch


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int,
          device=None, mesh: Optional[DeviceMesh] = None) -> Served:
    """Random-init ``cfg`` (seed 0), prefill ``batch`` random prompts (seed
    1), decode ``gen`` tokens greedily. The prefill is run once untimed
    first, and the first decode step is left out of ``decode_s``, so both
    times exclude one-time set-up (the kernel's build at first use
    included). The cache is zeroed before the timed prefill: prefill starts
    recurrent states from the cache's, as in the reference.

    With ``mesh``, parameters, batch and cache are DTensors laid out by
    ``serve_shardings`` and the steps run under ``rules_for(cfg)``, as the
    reference's driver runs them; the tokens and logits come back whole on
    every rank."""
    dev = resolve_device(device)
    model = LM(cfg.replace(use_flash=True))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    cache = model.init_cache(batch, prompt_len + gen, dev)
    prefill = S.make_prefill_step(model)
    decode = S.make_decode_step(model)
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    batch0 = prefill_batch(model, prompts)
    rules = contextlib.nullcontext()
    if mesh is not None:
        p_sh, pb_sh, _ = S.serve_shardings(
            model, mesh, ShapeSpec("prefill", prompt_len, batch, "prefill"))
        _, db_sh, c_sh = S.serve_shardings(
            model, mesh, ShapeSpec("decode", prompt_len + gen, batch,
                                   "decode"))
        with torch.inference_mode():
            params = S.place_tree(params, p_sh)
            cache = S.place_tree(cache, c_sh)
            batch0 = S.place_tree(batch0, pb_sh)
        rules = use_rules(S.rules_for(model.cfg))

    def place_tokens(t):
        if mesh is None:
            return t
        with torch.inference_mode():
            return distribute_tensor(t, *db_sh["tokens"])

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    with rules:
        prefill(params, batch0, cache)
        with torch.inference_mode():
            for t in tree_leaves(cache):
                t.zero_()
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch0, cache)
        logits = whole(logits)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        toks = torch.argmax(logits, -1)[:, None]
        out: List[torch.Tensor] = [toks]
        out_logits = [logits]
        t0 = None
        for i in range(gen - 1):
            logits, cache = decode(params, {"tokens": place_tokens(toks)},
                                   cache, prompt_len + i)
            logits = whole(logits)
            toks = torch.argmax(logits, -1)[:, None]
            out.append(toks)
            out_logits.append(logits)
            if i == 0:         # the first step carries one-time set-up
                _sync(dev)
                t0 = time.perf_counter()
        _sync(dev)
    t_decode = 0.0 if t0 is None else time.perf_counter() - t0
    return Served(model, params, cache, prompts, torch.cat(out, dim=1),
                  torch.stack(out_logits), prompt_len + gen - 1, t_prefill,
                  t_decode, max(gen - 2, 0))


def main(argv: Optional[List[str]] = None) -> Served:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", choices=("none", "smoke", "auto"),
                    default="none")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    b, plen, gen = args.batch, args.prompt_len, args.gen
    started = args.mesh != "none" and not dist.is_initialized()
    try:
        device, mesh = mesh_for_flag(args.mesh, args.device)
        r = serve(cfg, batch=b, prompt_len=plen, gen=gen, device=device,
                  mesh=mesh)
        rank = 0 if mesh is None else mesh.get_rank()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    if rank != 0:
        return r

    gen_toks = b * r.decode_steps
    where = args.device if mesh is None else f"{mesh}"
    print(f"[serve] {cfg.name} ({cfg.family}) on {where}: prefill "
          f"{b}x{plen} in {r.prefill_s:.3f}s "
          f"({b * plen / max(r.prefill_s, 1e-9):.0f} tok/s)")
    print(f"[serve] decode {gen_toks} tokens ({r.decode_steps} steps after the "
          f"first) in {r.decode_s:.3f}s "
          f"({gen_toks / max(r.decode_s, 1e-9):.1f} tok/s)")
    print(f"[serve] sample generated ids: {r.tokens[0][:16].tolist()}")
    return r


if __name__ == "__main__":
    main()
