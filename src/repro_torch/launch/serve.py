"""Serving driver: batched prefill + greedy decode loop with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --batch 4 --prompt-len 128 --gen 32

Runs on the card unless ``--device cpu`` is given; ``--smoke`` uses the
reduced config. The model is served as ``cfg.replace(use_flash=True)``, so
every decode step runs attention through the ``flash_decode`` kernel.
Weights and prompts are random, drawn from seeded generators on the device.
Decoding is greedy; ``--temperature`` is accepted and ignored, as in the JAX
package's driver.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models import LM
from repro_torch.models.params import Tree


@dataclasses.dataclass
class Served:
    model: LM
    params: Tree
    cache: Tree
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


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen: int,
          device=None) -> Served:
    """Random-init ``cfg`` (seed 0), prefill ``batch`` random prompts (seed
    1), decode ``gen`` tokens greedily. The prefill is run once untimed
    first, and the first decode step is left out of ``decode_s``, so both
    times exclude one-time set-up (the kernel's build at first use included)."""
    dev = resolve_device(device)
    model = LM(cfg.replace(use_flash=True))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    cache = model.init_cache(batch, prompt_len + gen, dev)
    prefill = S.make_prefill_step(model)
    decode = S.make_decode_step(model)
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))

    prefill(params, {"tokens": prompts}, cache)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts}, cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    toks = torch.argmax(logits, -1)[:, None]
    out: List[torch.Tensor] = [toks]
    out_logits = [logits]
    t0 = None
    for i in range(gen - 1):
        logits, cache = decode(params, {"tokens": toks}, cache, prompt_len + i)
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    b, plen, gen = args.batch, args.prompt_len, args.gen
    r = serve(cfg, batch=b, prompt_len=plen, gen=gen, device=args.device)

    gen_toks = b * r.decode_steps
    print(f"[serve] {cfg.name} on {args.device}: prefill {b}x{plen} in "
          f"{r.prefill_s:.3f}s ({b * plen / max(r.prefill_s, 1e-9):.0f} tok/s)")
    print(f"[serve] decode {gen_toks} tokens ({r.decode_steps} steps after the "
          f"first) in {r.decode_s:.3f}s "
          f"({gen_toks / max(r.decode_s, 1e-9):.1f} tok/s)")
    print(f"[serve] sample generated ids: {r.tokens[0][:16].tolist()}")
    return r


if __name__ == "__main__":
    main()
