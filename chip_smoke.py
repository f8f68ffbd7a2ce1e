"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only. Phases, each printing its own
lines:

1. device  — fails at once without CUDA; prints the card's name and power
             limit as nvidia-smi gives them.
2. build   — compiles every kernel of the port from the checkout's sources
             (one nvcc per kernel, started together).
3. kernels — flash_decode against its plain PyTorch version on the card, in
             bf16 and f32, at the serving shape, at odd cache lengths and at
             one layer's long cache; times the kernel, the plain version and
             one PyTorch library call computing the same function (device
             time per call, from a replayed CUDA graph of many calls).
3b. attention — flash_attention against its plain version in bf16 and f32,
             causal and not, at the reference test's shapes, S = 65 / 130 /
             200 / 4097, Sq != Skv, GQA groups of 1, 4 and 8, and in the
             model's strided layout, the training shape included; times
             the kernel, the plain version and SDPA at that shape.
4. serve   — llama3-8b at full width and depth (random weights from a seed)
             through ``repro_torch.launch.serve``: batch 4, prompt 128, 32
             generated tokens. Checks finite logits, the kernel's launch
             count, prefill against the no-cache forward, and one decode
             step through the kernel against the einsum cache branch.
5. profile — device time by kernel over two decode steps.
6. train   — llama3-8b at full width and 8 layers (random weights from a
             seed, synthetic data) through ``repro_torch.launch.train``:
             4 steps of 2 x 4096 tokens. Checks finite losses and the
             flash_attention launch count, profiles one more step, holds one
             in-place AdamW update of the live state against a plain
             out-of-place update from the same gradients, holds one bf16
             loss and layer 0's attention through the kernel against the
             plain (blockwise) branch, and an f32 loss and gradients at 2
             layers through both branches.

Then one JSON line of kernel results and, last, ``{"ok": true, ...}``. Any
failure raises and exits non-zero before the last line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,     # dense tensor-core bf16
              torch.float32: 67e12}       # f32 outside the tensor cores
TOL = {torch.float32: 2e-3, torch.bfloat16: 4e-2}   # tests/test_kernels.py
# A kernel against its plain version: both sum in f32 and round once, so in
# bf16 they differ by about one ulp. The reference's 4e-2 would pass a kernel
# that skipped tiles at a long cache, where outputs are about 1e-2.
KERNEL_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
              torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}

ARCH, BATCH, PROMPT, GEN = "llama3-8b", 4, 128, 32
# llama3-8b training: full width; 8 layers, batch 2 instead of 32 layers and
# 256 (train_4k), so that bf16 weights, f32 AdamW moments and the loss's
# [B, S, V] temporaries fit one 80 GB card
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 4096, 4


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# timing helpers


def time_ms(fn, arg_sets, iters: int) -> float:
    """Mean device time of ``fn`` per call: ``iters`` calls captured in one
    CUDA graph and replayed, so host dispatch is left out. The calls rotate
    through ``arg_sets`` so that inputs come from device memory, not L2."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm outside the capture
        for args in arg_sets[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def decode_bound(q, k, lengths):
    """(least ms, what bounds it) for one flash_decode call on these inputs:
    the K/V rows below each length read once, q and lengths read, out
    written, against the flops of QK and PV at the card's peak."""
    b, kv, g, hd = q.shape
    rows = int(lengths.clamp(max=k.shape[2]).sum())
    es = q.element_size()
    nbytes = 2 * kv * hd * rows * es + 2 * q.numel() * es + 4 * b
    flops = 4 * kv * g * hd * rows
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(q, k, causal):
    """(least ms, what bounds it) for one flash_attention call: the (query,
    key) pairs this mask keeps, 4 * d flops each (QK and PV) at the card's
    peak, against q, k, v read and o written once."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if causal:                      # top left: row r sees keys 0..r
        m = min(sq, skv)
        pairs = m * (m + 1) // 2 + (sq - m) * skv
    else:
        pairs = sq * skv
    flops = 4 * d * b * h * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_decode(q, k, v, mask):
    """The library yardstick: one scaled_dot_product_attention call."""
    b, kv, g, hd = q.shape
    o = F.scaled_dot_product_attention(q.reshape(b, kv * g, 1, hd), k, v,
                                       attn_mask=mask, enable_gqa=True)
    return o.reshape(b, kv, g, hd)


# ---------------------------------------------------------------------------
# phases


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log("device", f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s): {card}")
    return card


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    log("build", f"{len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'}"
        f" in {secs:.1f} s: {', '.join(p.name for p in libs.values())}")
    for path in libs.values():
        info = path.with_name(path.name + ".log")
        if info.exists():
            for line in info.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log("build", line.strip())


def phase_kernels(dev) -> dict:
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    gen = torch.Generator(device=dev).manual_seed(0)
    b, kv, g, hd = 4, 8, 4, 128

    def inputs(t, lens, dtype, sets=1):
        out = []
        for _ in range(sets):
            q, k, v = (torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.float32).to(dtype)
                       for shape in ((b, kv, g, hd), (b, kv, t, hd),
                                     (b, kv, t, hd)))
            out.append((q, k, v, torch.tensor(lens, dtype=torch.int32,
                                              device=dev)))
        return out

    # correctness: serve shape, odd cache lengths, one layer's long cache
    cases = [(160, [1, 37, 128, 160]), (255, [1, 100, 254, 255]),
             (257, [257, 3, 129, 256]), (32768, [32768, 32767, 16385, 1])]
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for t, lens in cases:
            q, k, v, ln = inputs(t, lens, dtype)[0]
            got = flash_decode(q, k, v, ln)
            want = flash_decode_ref(q, k, v, ln)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(),
                                       **KERNEL_TOL[dtype])
            max_err = max(max_err, err)
            log("kernels", f"flash_decode {str(dtype)[6:]} B={b} KV={kv} "
                f"G={g} hd={hd} T={t} lengths={lens}: max abs err {err:.3g} "
                f"(tol {KERNEL_TOL[dtype]})")
            del q, k, v, got, want

    def timed(t, lens, dtype, sets, iters):
        arg_sets = inputs(t, lens, dtype, sets)
        masks = [(torch.arange(t, device=dev)[None, :] < ln[:, None])
                 [:, None, None, :] for _, _, _, ln in arg_sets]
        lib_sets = [a[:3] + (m,) for a, m in zip(arg_sets, masks)]
        q, k, v, ln = arg_sets[0]
        torch.testing.assert_close(sdpa_decode(*lib_sets[0]).float(),
                                   flash_decode_ref(q, k, v, ln).float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        bound_ms, bound_by = decode_bound(q, k, ln)
        return {"ms": time_ms(flash_decode, arg_sets, iters),
                "plain_ms": time_ms(flash_decode_ref, arg_sets, iters),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": time_ms(sdpa_decode, lib_sets, iters)}

    # the main path's call: the serve cache (160 slots) at the mean length of
    # its 31 decode steps; 40 input sets (105 MB) rotate past the 50 MB L2
    main = timed(160, [144] * 4, torch.bfloat16, sets=40, iters=400)
    log("kernels", "flash_decode bf16 serve shape T=160 lengths=144: "
        + json.dumps(main))
    long = timed(32768, [32768] * 4, torch.bfloat16, sets=1, iters=20)
    log("kernels", "flash_decode bf16 long cache T=32768 (537 MB K/V): "
        + json.dumps(long) + f", {537 / long['ms']:.0f} GB/s achieved")
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode/flash_decode.py:29",
            "max_abs_err": max_err, **main}


def phase_flash_attention(dev) -> dict:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, h, kv, sq, skv, d, dtype, model_layout=False):
        """q [B,H,Sq,d], k/v [B,KV,Skv,d]; in the model's layout they are
        [B,S,H,d] storage seen through strides, as the train step passes."""
        def one(heads, s):
            shape = (b, s, heads, d) if model_layout else (b, heads, s, d)
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            return x.transpose(1, 2) if model_layout else x
        return one(h, sq), one(kv, skv), one(kv, skv)

    # (b, h, kv, sq, skv, d, causal, model layout)
    cases = [(b, h, h, s, s, d, c, False)                   # the reference's
             for b, h, s, d in ((1, 1, 128, 64), (2, 4, 200, 64),
                                (1, 2, 384, 128), (2, 1, 65, 32))
             for c in (True, False)]
    cases += [(1, 8, 2, s, s, 128, True, False)
              for s in (65, 130, 200, 4097)]
    cases += [(1, 2, 2, 64, 200, 32, False, False),          # Sq != Skv
              (1, 2, 2, 64, 200, 32, True, False),
              (1, 2, 2, 8, 20, 32, True, False),
              (1, 2, 2, 200, 65, 32, True, False)]
    cases += [(2, 8, kv, 96, 96, 32, True, False)           # G = 1, 4, 8
              for kv in (8, 2, 1)]
    cases += [(2, 4, 2, 200, 200, 64, c, True)              # strided
              for c in (True, False)]
    train = (TRAIN_BATCH, 32, 8, TRAIN_SEQ, TRAIN_SEQ, 128, True, True)
    cases.append(train)
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, kv, sq, skv, d, causal, ml in cases:
            q, k, v = inputs(b, h, kv, sq, skv, d, dtype, ml)
            got = flash_attention(q, k, v, causal=causal)
            want = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(),
                                       **KERNEL_TOL[dtype])
            max_err = max(max_err, err)
            log("attention", f"flash_attention {str(dtype)[6:]} B={b} H={h} "
                f"KV={kv} Sq={sq} Skv={skv} d={d} causal={causal}"
                f"{' strided' if ml else ''}: max abs err {err:.3g}")
            del q, k, v, got, want
        torch.cuda.empty_cache()
    log("attention", f"all {2 * len(cases)} cases within {KERNEL_TOL}")

    # the main path's call: one layer's forward attention in the train step
    b, h, kv, s, _, d = train[:6]
    q, k, v = inputs(b, h, kv, s, s, d, torch.bfloat16, model_layout=True)
    dense = [x.contiguous() for x in (q, k, v)]   # SDPA's own layout

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    torch.testing.assert_close(sdpa(*dense).float(),
                               flash_attention_plain(q, k, v).float(),
                               rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])
    bound_ms, bound_by = attention_bound(q, k, True)
    main = {"ms": time_ms(lambda *a: flash_attention(*a), [(q, k, v)], 20),
            "plain_ms": time_ms(flash_attention_plain, [(q, k, v)], 4),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(sdpa, [tuple(dense)], 20)}
    torch.cuda.empty_cache()
    log("attention", f"flash_attention bf16 train shape B={b} H={h} KV={kv} "
        f"S={s} d={d} causal: " + json.dumps(main) + f", roofline share "
        f"{main['bound_ms'] / main['ms']:.4f}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:32",
            "max_abs_err": max_err, **main}


def phase_serve(card: str) -> int:
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch import serve
    from repro_torch.models import LM

    torch.cuda.reset_peak_memory_stats()
    flash_decode.launches = 0
    r = serve.main(["--arch", ARCH, "--batch", str(BATCH),
                    "--prompt-len", str(PROMPT), "--gen", str(GEN)])
    launches = flash_decode.launches
    cfg = r.model.cfg
    want = cfg.num_layers * (GEN - 1)
    if launches != want:
        raise RuntimeError(f"flash_decode launched {launches} times, "
                           f"expected {want}")
    if r.tokens.shape != (BATCH, GEN) or not torch.isfinite(
            r.logits.float()).all():
        raise RuntimeError("serve produced non-finite logits or a bad shape")
    log("serve", f"{cfg.name} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}): flash_decode launches {launches} = "
        f"{cfg.num_layers} layers x {GEN - 1} decode steps")

    peak = torch.cuda.max_memory_allocated() / 2**30
    log("serve", f"prefill {BATCH * PROMPT / r.prefill_s:.1f} tok/s "
        f"({1e3 * r.prefill_s:.2f} ms), decode "
        f"{BATCH * r.decode_steps / r.decode_s:.1f} tok/s "
        f"({1e3 * r.decode_s / r.decode_steps:.2f} ms/step), peak memory "
        f"{peak:.2f} GiB, on {card}")

    with torch.inference_mode():
        # prefill against the no-cache forward (the reference's own bar)
        einsum_model = LM(cfg.replace(use_flash=False))
        full, _ = einsum_model.forward(r.params, {"tokens": r.prompts})
        err = (full[:, -1].float() - r.logits[0].float()).abs().max().item()
        torch.testing.assert_close(full[:, -1].float(), r.logits[0].float(),
                                   rtol=5e-2, atol=5e-2)
        log("serve", f"prefill logits vs no-cache forward: max abs err "
            f"{err:.3g} (tol 5e-2)")
        del full
        check_branches(r, einsum_model)
    phase_profile(r)
    return launches


def check_branches(r, einsum_model) -> None:
    """One decode step from the same cache through the flash_decode branch
    and the einsum cache branch. In bf16, layer 0's attention outputs are
    held to the kernel's bf16 bar: both branches sum in f32 and round once.
    Over 32 bf16 residual layers that rounding grows past the reference's
    2e-2 bar on the logits (set on a 4-layer model), so the bf16 logits are
    printed and the bar is held on an exact f32 widening of the same weights
    and cache, where only the kernel's summation order differs."""
    from repro_torch.models import layers as Lyr
    from repro_torch.models.model import layer_slice

    batch = {"tokens": r.tokens[:, -1:]}
    cfg = r.model.cfg
    # layer 0 alone: the same input through both branches
    p0 = layer_slice(r.params["blocks"], 0)
    h = Lyr.apply_norm(p0["ln1"], Lyr.embed(r.params["embed"], batch["tokens"]),
                       cfg.norm_eps)
    pos = torch.full((BATCH, 1), r.next_pos, dtype=torch.int32, device="cuda")
    c0 = {"k": r.cache["self"]["k"][0], "v": r.cache["self"]["v"][0]}
    af, _ = Lyr.attention(p0["attn"], h, cfg, positions=pos, cache=c0,
                          cache_pos=r.next_pos)
    ae, _ = Lyr.attention(p0["attn"], h, einsum_model.cfg, positions=pos,
                          cache=c0, cache_pos=r.next_pos)
    torch.testing.assert_close(af.float(), ae.float(),
                               **KERNEL_TOL[torch.bfloat16])
    log("serve", f"bf16 layer 0 attention, flash_decode vs einsum cache "
        f"branch: {(af != ae).sum().item()} of {af.numel()} outputs differ, "
        f"max abs diff {(af.float() - ae.float()).abs().max().item():.3g} "
        f"(tol {KERNEL_TOL[torch.bfloat16]})")
    lf, _ = r.model.decode_step(r.params, batch, r.cache, r.next_pos)
    le, _ = einsum_model.decode_step(r.params, batch, r.cache, r.next_pos)
    d = (lf.float() - le.float()).abs()
    log("serve", f"bf16 decode step, flash_decode vs einsum cache branch: "
        f"max abs diff {d.max().item():.3g}, mean {d.mean().item():.3g}, "
        f"logit std {le.float().std().item():.3g}")

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float()
                for k, v in tree.items()}
    params, cache = f32(r.params), f32(r.cache)
    lf, _ = r.model.decode_step(params, batch, cache, r.next_pos)
    le, _ = einsum_model.decode_step(params, batch, cache, r.next_pos)
    err = (lf - le).abs().max().item()
    torch.testing.assert_close(lf, le, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    log("serve", f"f32 decode step, flash_decode vs einsum cache branch: "
        f"max abs err {err:.3g} (tol {TOL[torch.float32]})")
    del params, cache
    torch.cuda.empty_cache()


def phase_profile(r) -> None:
    """Device kernels of two warm decode steps."""
    def step():
        with torch.inference_mode():
            r.model.decode_step(r.params, {"tokens": r.tokens[:, -1:]},
                                r.cache, r.next_pos)
    device_profile("profile", "2 decode steps", step, reps=2)


def device_profile(phase: str, what: str, step, reps: int) -> None:
    """Busy time of the device kernels of ``reps`` warm calls of ``step``,
    the device's idle share over the span from the first kernel's start to
    the last one's end, and the kernels that take the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(phase, "no device time recorded: not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    by_name: dict = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    log(phase, f"{what}: {len(kernels)} device kernels, busy "
        f"{busy:.3f} ms over a {span:.3f} ms device span (idle share "
        f"{1 - busy / span:.3f})")
    for name, (ms, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:8]:
        log(phase, f"{ms:8.3f} ms {100 * ms / busy:5.1f}%  x{n:<4d} "
            f"{name[:90]}")


def phase_train(card: str) -> int:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import steps as S
    from repro_torch.launch import train

    cfg = get_config(ARCH).replace(num_layers=TRAIN_LAYERS)
    shape = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    r = train.train(cfg, shape, steps=TRAIN_STEPS, device="cuda",
                    log=lambda m: log("train", m))
    launches = flash_attention.launches
    # remat="full" checkpoints each layer: its forward runs once in the
    # forward pass and once more when backward recomputes it, and each run
    # launches the kernel once (the backward itself is the plain version)
    if cfg.remat != "full":
        raise RuntimeError(f"expected remat='full', got {cfg.remat!r}")
    want = 2 * cfg.num_layers * TRAIN_STEPS
    if launches != want:
        raise RuntimeError(f"flash_attention launched {launches} times, "
                           f"expected {want}")
    if len(r.losses) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in r.losses):
        raise RuntimeError(f"train losses not finite: {r.losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = sum(r.step_times[1:]) / len(r.step_times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = cfg.param_count()
    log("train", f"{cfg.name} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n / 1e9:.3f} B params) {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens: flash_attention launches {launches} = 2 x "
        f"{cfg.num_layers} layers x {TRAIN_STEPS} steps (remat='full')")
    log("train", f"losses {[round(x, 4) for x in r.losses]}")
    log("train", f"step times (s) {[round(t, 4) for t in r.step_times]}; "
        f"steps after the first {1e3 * step_s:.1f} ms, {tokens / step_s:.1f} "
        f"tok/s, model {6 * n * tokens / step_s / 1e12:.1f} TFLOP/s "
        f"(6 N tokens), peak memory {peak:.2f} GiB, on {card}")

    data = SyntheticLMData(cfg, shape, device="cuda")
    opt_cfg = S.make_optimizer_config(cfg, total_steps=TRAIN_STEPS)
    step_fn = S.make_train_step(r.model, opt_cfg)
    state = {"s": r.state}

    def one_step():
        state["s"], _ = step_fn(state["s"], data.batch(TRAIN_STEPS))
    device_profile("train", "1 train step", one_step, reps=1)

    check_adamw_step(r.model, state["s"], data.batch(TRAIN_STEPS + 1),
                     opt_cfg)
    params = r.state["params"]
    del r, state
    torch.cuda.empty_cache()
    check_train_branches(cfg, params, data.batch(0))
    return launches


def check_adamw_step(model, state, batch, opt_cfg) -> None:
    """The port's AdamW update, in place on the live train state, against a
    plain out-of-place update of the same leaves from the same gradients:
    layer 0's wq, the first norm scales and the token embedding.

    The step counter is set back to 0 first, so the update is a "step 1":
    the schedule's peak lr and step-1 bias corrections, over the moments
    the run has built. At the decayed lr of the run's last steps most bf16
    weights would not move by a rounding step, and the check would see
    little of the update."""
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw_update
    from repro_torch.optim.adamw import tree_leaves

    params, opt = state["params"], state["opt"]
    opt = opt._replace(step=torch.zeros_like(opt.step))
    _, grads = S.loss_and_grads(model, params, batch)
    # (leaf, the share of its weights that must move): a bf16 norm scale
    # of 1 does not move by 3e-4, nor does an embedding row the run has
    # never seen (no gradient, no moments, decay alone)
    picks = {"blocks.attn.wq[0]": (lambda t: t["blocks"]["attn"]["wq"][0],
                                   0.5),
             "blocks.ln1.scale": (lambda t: t["blocks"]["ln1"]["scale"], 0),
             "embed.tok": (lambda t: t["embed"]["tok"], 0)}
    before = {n: [f(t).clone() for t in (params, grads, opt.mu, opt.nu)]
              for n, (f, _) in picks.items()}
    # the plain version's own clip, its norm summed in f64
    gnorm = math.sqrt(sum(g.double().square().sum().item()
                          for g in tree_leaves(grads)))
    scale = min(1.0, opt_cfg.clip_norm / max(gnorm, 1e-9))
    lr = float(opt_cfg.lr(torch.ones_like(opt.step)))
    b1, b2, eps, wd = opt_cfg.b1, opt_cfg.b2, opt_cfg.eps, opt_cfg.weight_decay

    adamw_update(params, grads, opt, opt_cfg)
    del grads
    report, errs = [], {}
    for n, (f, min_moved) in picks.items():
        p0, g, m0, v0 = before.pop(n)
        g32 = g.float() * scale
        m2 = b1 * m0 + (1 - b1) * g32
        v2 = b2 * v0 + (1 - b2) * g32 * g32
        upd = (m2 / (1 - b1)) / (torch.sqrt(v2 / (1 - b2)) + eps)
        p2 = (p0.float() - lr * (upd + wd * p0.float())).to(p0.dtype)
        # moments: max abs error over max abs value, as for the gradients
        # below (single elements of m cancel to near 0)
        for name, a, b in (("m", f(opt.mu), m2), ("v", f(opt.nu), v2)):
            rel = ((a - b).abs().max() / b.abs().max()).item()
            errs[f"{n} {name}"] = rel
            if not rel <= 1e-5:
                raise RuntimeError(f"AdamW {n} {name}: relative error {rel}")
        p = f(params)
        # the same f32 value rounded to bf16: at most one rounding step
        # apart, or, where the update cancels the weight to near 0, a few f32
        # rounding steps of the operands (atol 1e-7, far below the 3e-4 the
        # update moves a weight)
        torch.testing.assert_close(p.float(), p2.float(), rtol=2 ** -7,
                                   atol=1e-7)
        moved = (p != p0).float().mean().item()
        off = (p != p2).sum().item()
        if moved < min_moved or off > 1e-3 * p.numel():
            raise RuntimeError(f"AdamW {n}: {moved:.3f} of the weights moved, "
                               f"{off} differ from the plain update")
        report.append(f"{n} {moved:.3f} moved, {off} of {p.numel()} off by "
                      f"one rounding step")
        del p0, g, m0, v0, g32, m2, v2, upd, p2
    log("train", f"AdamW in place vs plain out-of-place (lr {lr:.3g}, clip "
        f"scale {scale:.4g}): moments' max abs error over max abs value "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
        + " (tol 1e-5); weights: " + "; ".join(report))


def check_train_branches(cfg, params, batch) -> None:
    """The kernel's branch (use_flash) against the plain one (use_flash off,
    so blockwise at 4096 tokens) on the same weights and batch: a bf16 loss
    (printed) and layer 0's attention (held to the kernel's bf16 bar), then
    an f32 loss and gradients at full width and 2 layers (held at 2e-3)."""
    from repro_torch.models import LM
    from repro_torch.models import layers as Lyr
    from repro_torch.models.model import layer_slice
    from repro_torch.optim.adamw import tree_map

    flash_cfg = cfg.replace(use_flash=True)
    with torch.no_grad():
        lf = LM(flash_cfg).loss(params, batch).item()
        lp = LM(cfg).loss(params, batch).item()
        log("train", f"bf16 loss at 8 layers: flash {lf:.6f}, blockwise "
            f"{lp:.6f}, diff {abs(lf - lp):.3g}")
        p0 = layer_slice(params["blocks"], 0)
        tokens = batch["tokens"]
        h = Lyr.apply_norm(p0["ln1"], Lyr.embed(params["embed"], tokens),
                           cfg.norm_eps)
        pos = torch.arange(tokens.shape[1], device="cuda")[None].expand(
            tokens.shape[0], -1)
        af, _ = Lyr.attention(p0["attn"], h, flash_cfg, positions=pos,
                              impl="flash")
        ab, _ = Lyr.attention(p0["attn"], h, cfg, positions=pos,
                              impl="blockwise")
        torch.testing.assert_close(af.float(), ab.float(),
                                   **KERNEL_TOL[torch.bfloat16])
        log("train", f"bf16 layer 0 attention, flash vs blockwise: "
            f"{(af != ab).sum().item()} of {af.numel()} outputs differ, max "
            f"abs diff {(af.float() - ab.float()).abs().max().item():.3g} "
            f"(tol {KERNEL_TOL[torch.bfloat16]})")
    del params, h, af, ab
    torch.cuda.empty_cache()

    cfg2 = cfg.replace(num_layers=2)
    m = LM(cfg2)
    p32 = m.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    p32 = tree_map(lambda x: x.float(), p32)
    one = {k: x[:1] for k, x in batch.items()}
    leaves = [p32["blocks"]["attn"]["wq"], p32["blocks"]["attn"]["wo"],
              p32["embed"]["out"]]
    for x in leaves:
        x.requires_grad_(True)
    out = {}
    for name, mc in (("flash", cfg2.replace(use_flash=True)),
                     ("blockwise", cfg2)):
        loss = LM(mc).loss(p32, one)
        g = torch.autograd.grad(loss, leaves)
        out[name] = (loss.detach(), [g[0][0], g[1][0], g[2]])
        del loss, g
        torch.cuda.empty_cache()
    (lf, gf), (lb, gb) = out["flash"], out["blockwise"]
    tol = TOL[torch.float32]
    torch.testing.assert_close(lf, lb, rtol=tol, atol=tol)
    errs = []
    for name, a, b in zip(("wq[0]", "wo[0]", "embed.out"), gf, gb):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
        rel = ((a - b).abs().max() / b.abs().max()).item()
        if rel > tol:
            raise RuntimeError(f"f32 grad {name}: relative error {rel:.3g}")
        errs.append(f"{name} {rel:.3g}")
    log("train", f"f32 at 2 layers, 1 x {TRAIN_SEQ} tokens, flash vs "
        f"blockwise: loss {lf.item():.6f} vs {lb.item():.6f}; grads' max "
        f"abs error over max abs value: {', '.join(errs)} (tol {tol})")


def main() -> int:
    card = phase_device()
    # f32 comparisons run in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    phase_build()
    decode = phase_kernels(dev)
    attn = phase_flash_attention(dev)
    decode["launches"] = phase_serve(card)
    torch.cuda.empty_cache()
    attn["launches"] = phase_train(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in (decode, attn)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
