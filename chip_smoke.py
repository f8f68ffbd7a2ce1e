"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py               # every phase
    python3 chip_smoke.py --phase sim   # phases 1, 2, Table I on the host, 7c
    python3 chip_smoke.py --phase multi # phases 1, 2, 7e

Drives the port (``src/repro_torch``) only. Phases, each printing its own
lines:

1. device  — fails at once without CUDA; prints the card's name and power
             limit as nvidia-smi gives them.
2. build   — compiles every kernel of the port from the checkout's sources
             (one nvcc per kernel, started together).
3. kernels — flash_decode against its plain PyTorch version on the card, in
             bf16 and f32, at the serving shape, at odd cache lengths and at
             one layer's long cache, at the plan's split count and at one,
             seven and one split a tile (lengths that leave whole splits
             empty), bf16 on the tensor cores and f32 (and bf16 in 24-row
             tiles) on CUDA cores, printing each call's route, split count
             and device kernels;
             times the kernel, the plain version and one PyTorch library
             call computing the same function (device time per call, from a
             replayed CUDA graph of many calls) at the serving shape, at one
             layer's long cache in bf16 (also at seven split counts) and
             f32, and at one chat user's 8192-token cache.
3b. attention — flash_attention against its plain version in bf16 and f32,
             causal and not, at the reference test's shapes, S = 65 / 130 /
             200 / 4097, Sq != Skv, GQA groups of 1, 4 and 8, and in the
             model's strided layout, the training shape included; at the
             bf16 kernel's tile edges (S = 1, 127, 128, 129, 255), Sq !=
             Skv around 128 and a batch slice with a batch stride that is
             not dense, and at head dim 16 at S = 1, 127, 128, 129. Checks
             that every bf16 call went to the tensor-core kernel and every
             f32 call to the CUDA-core one, prints the bf16 kernel's
             registers, spills and shared memory, and times the kernel, the
             plain version and SDPA at the training shape.
4. serve   — llama3-8b at full width and depth (random weights from a seed)
             through ``repro_torch.launch.serve``: batch 4, prompt 128, 32
             generated tokens. Checks finite logits, the kernel's launch
             count (all on the tensor cores) and its device kernels, prefill
             against the no-cache forward, and one decode step through the
             kernel against the einsum cache branch.
5. profile — device time by kernel over two decode steps, the split and
             combine kernels of flash_decode wherever they rank.
6. train   — llama3-8b at full width and 8 layers (random weights from a
             seed, synthetic data) through ``repro_torch.launch.train``:
             4 steps of 2 x 4096 tokens. Checks finite losses and the
             flash_attention launch count (all on the tensor cores),
             profiles one more step, holds one in-place AdamW update of
             the live state against a plain out-of-place update from the
             same gradients, holds one bf16 loss and layer 0's attention
             through the kernel against the plain (blockwise) branch, and
             an f32 loss and gradients at 2 layers through both branches.
6b. train smoke — ``python -m repro_torch.launch.train --smoke --steps 4``
             on the card (the smoke config: head dim 16, 4 x 128 tokens).
             Checks finite losses and that every flash_attention launch took
             the bf16 tensor-core kernel.
7. compile — the Cascade compiler of the port on the host: Table I
             (DENSE_APPS x {unpipelined, full}, place_moves=120,
             verify=True) with each app's critical-path and EDP ratios,
             and the three STRAIGHT_LINE_PINS at place_moves=40. Then the
             path the kernels serve: each of the 13 designs' timing
             matrices goes to the card and its longest path from SRC runs
             through maxplus, held to numpy's longest_path_maxplus; and
             gaussian_blur, sharpen and sobel_mag2 run through stencil on
             the gaussian, unsharp and harris frames (integer pixels from a
             seed), held to the plain version. Checks both launch counts
             and prints maxplus's device kernels (a K-split call runs two).
7b. engines — the compiler's torch engines on the card, at the reference
             benchmarks' sizes (benchmarks/pnr_kernels.py's and
             benchmarks/sta_pipeline.py's five design points, seed 0):
             torch place and route against numpy place and A* on the host
             (legal, the same result twice, cost and wirelength at or below
             the host's), the torch STA report against the scalar walk
             (field by field) and the post-PnR loop on all three engines
             (byte-identical), with place / route seconds and ms per
             analyze and per loop; then Table I with
             pnr_backend=sta_backend="torch" (compiled and verified, beside
             the host run), and with sta_backend="torch" alone the host
             run's design digests and the three STRAIGHT_LINE_PINS.
7c. sim    — the vectorized simulator (benchmarks/sim_throughput.py's
             workloads, seed 0): every dense and control app at 1024 cycles
             and harris at 4096, every sparse app at 64 tokens, through
             simulate / simulate_sparse with backend="torch" (the sim_dense
             and sim_sparse kernels, one launch of one warp a call; launch
             counts checked), held bit for bit to the interpreter, numpy and
             the kernels' plain versions on the card; the chain programs
             (INPUT -> 1 or 33 chained adds, or 32 mixed ops and a ROM ->
             OUTPUT, 4096 cycles) through both micro-op evaluations, held
             the same way, with the fit of ns a stage and fixed ns a cycle
             beside clocks.sm; the harris x 4096 ratio against the
             interpreter (the reference's contract: >= 10x; fails below
             1x), the kernels' device ms (back-to-back launches of a packed
             program) beside their roofline bound and latency floor, the
             host's split of a warm simulate and one traced harris run;
             Table I's ten routed netlists through equivalent(n=32) on all
             three backends and their 128-cycle streams against the plain
             version; the deadlock diagnostic of a starved graph, identical
             on every backend. Programs past a block's shared memory take
             the kernels' global route: the smallest seeded wide DAG past
             the limit (width 1018) and one about 4x past it (width 4096),
             256 cycles each, and the smallest seeded wide sparse program
             past it (width 176, 64 tokens), on the main path; held bit for
             bit to numpy, the interpreter and the plain versions, each
             route's launches counted, and timed beside their bounds.
7d. batch  — the compile driver: Table I (the same seeds and settings as
             phase 7) through compile_batch on the process backend, cold,
             warm from the memory cache and warm from a disk cache under
             build/ in a second compiler, equal to phase 7's serial
             compiles; Table I on the torch engines through process workers
             (spawned: CUDA is initialised here), equal byte for byte to
             phase 7b's serial compiles on the card, with the workers'
             start time and the parent's peak device memory; the reference
             frontier benchmark's grid (unsharp, 100 moves, budgets 4, 16,
             64, None x caps 0.9 x the uncapped power, None) with the torch
             STA fanned out on threads and on processes, each point equal
             to an independent compile and to the numpy-STA frontier, and a
             warm re-run with select="max_freq" resumed from the routed
             artifact; the five dense apps under caps of 0.9 and 0.7 x
             their uncapped power on the torch and numpy STA; and the keys
             of one torch-engine job on the CPU and on the card.
7e. multi  — multi-app fabric sharing and online serving, at the reference
             benchmarks' sizes on the default 32x16 fabric (100 moves):
             benchmarks/multi_app.py's four mixes through compile_multi
             (verify=True) on the thread and process backends and resident
             by resident (serial), all equal, validate_regions holding, and
             a one-app pack in a full-fabric region equal to compile();
             dense2 and quad on the torch engines on the card, every
             resident fenced, within 1.10x of the numpy placer's cost in
             its region and at or below A*'s wirelength on its placement,
             and its design through equivalent / sparse_equivalent and its
             streams on the sim kernels (one launch a graph, counted from
             0) equal to the interpreter's; benchmarks/serve_online.py's
             wide_waves and churn_trace(48, 3) through one CompileService
             each, FabricScheduler online against evaluate_static (online
             must win on objective or rejections), every readmitted
             compile equal to a fresh one with the same region and cap;
             wide_waves again with a process-backend service (equal to the
             thread backend's) and a burst of four requests the dispatch
             thread sends to one pool of spawned workers, and on the torch
             engines on the card, with tests/test_sched.py's soak generator
             (6 sessions, 8x16 fabric, 20 moves: it evicts and readmits)
             there too (every seated compile equal to a fresh one);
             benchmarks/lm_lowering.py's blocks of every arch on the
             Amber array (cgra_amber), unpipelined and full, through
             compile_batch on the host, then llama3-8b and granite-moe on
             the torch engines on the card (the same placer bar; their
             wirelength beside A*'s is printed, not held).
8. maxplus — the max-plus kernel against its plain version (bit for bit, in
             f32) at the reference test's shapes, at every closure size of
             the path, ragged, with half the entries at the NEG_INF floor,
             and at n = 4096, each also with NaN entries (NaN at the same
             outputs); every tile and K-split choice at the path's sizes,
             checked and timed; the SASS form of its running max
             (FMNMX.NAN); times one squaring at each size of the path (the
             kernel, and at the largest the plain version) and at n = 4096.
             No PyTorch call computes it.
9. stencil — the 3x3 stencil kernel against its plain version at the
             reference test's shapes and the three frames, four weight
             sets; times kernel, plain version and conv2d at each frame.

Then one JSON line of kernel results and, last, ``{"ok": true, ...}``. Any
failure raises and exits non-zero before the last line.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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

# max-plus: one FADD and one FMNMX per (i, j, k). FMNMX runs at 64 results
# a clock an SM on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput) and an SM issues 128 thread-
# instructions a clock, so either way M N K / (64 x 132 SMs x clock); the
# clock is the H100 SXM's 1.98 GHz boost
MAXPLUS_PER_S = 64 * 132 * 1.98e9
# stencil: 9 products and 9 sums a pixel, separately rounded
STENCIL_OPS_PER_PIXEL = 18

ARCH, BATCH, PROMPT, GEN = "llama3-8b", 4, 128, 32
# llama3-8b training: full width; 8 layers, batch 2 instead of 32 layers and
# 256 (train_4k), so that bf16 weights, f32 AdamW moments and the loss's
# [B, S, V] temporaries fit one 80 GB card
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 4096, 4

# the compile path: Table I's designs at benchmarks/cascade_tables.py's move
# budget, and tests/test_predication.py's pins at place_moves=40: (design
# digest, critical path ns, physical registers)
TABLE1_MOVES = 120
STRAIGHT_LINE_PINS = {
    "gaussian": ("a3a27512474fe9396edeb6f63f642286873820b92ee2701b95b0b98dae1f81f3",
                 1.375, 62),
    "unsharp": ("f51ce187b41722194946e24ed3fc93e9ab044bb59a2bb0eaee081e4ba152eaef",
                1.47, 91),
    "harris": ("1bd4154ffbd6ad87d2b51b31c4b8831d96ac0883aa7aecd0eeec371981153b01",
               2.005, 228),
}
# the golden compute of each dense app with a 3x3 kernel, on the app's frame
GOLDEN = (("gaussian", "gaussian_blur"), ("unsharp", "sharpen"),
          ("harris", "sobel_mag2"))
# the compile driver (phase 7d): the reference frontier benchmark's grid
# (benchmarks/frontier.py:29-33), caps of the power-capped schedule as
# fractions of each app's uncapped power, and the disk cache's root
FRONTIER_APP, FRONTIER_MOVES = "unsharp", 100
FRONTIER_BUDGETS = (4, 16, 64, None)
FRONTIER_CAP_FRACTIONS = (0.9, None)
POWER_CAP_FRACTIONS = (0.9, 0.7)
BATCH_CACHE = ROOT / "build" / "chip_smoke_cache"
# multi-app sharing and serving (phase 7e): benchmarks/multi_app.py's mixes
# and move budget, the mixes taken again on the torch engines, and
# benchmarks/serve_online.py's tenants, period and churn trace (48
# sessions, seed 3); the LM blocks taken again on the torch engines
MULTI_MOVES = 100
MULTI_MIXES = {"dense2": ("unsharp", "camera"),
               "dense_sparse": ("unsharp", "vecadd"),
               "sparse2": ("vecadd", "ttv"),
               "quad": ("unsharp", "camera", "vecadd", "ttv")}
MULTI_TORCH_MIXES = ("dense2", "quad")
SERVE_NARROW, SERVE_WIDE = ("vecadd", "elemmul", "ttv", "mttkrp"), "harris"
SERVE_PERIOD, SERVE_CHURN = 100_000, (48, 3)
# evict and readmit on the card: tests/test_sched.py's soak generator at
# its own settings (an 8x16 fabric of four column groups, 20 moves), 6
# sessions of seed 1 (evicts, readmits and re-packs on the host engines)
SOAK_SESSIONS, SOAK_MOVES = (6, 1), 20
LM_TORCH_ARCHS = ("llama3-8b", "granite-moe-1b-a400m")


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
                if ("registers" in line or "spill" in line
                        or "entry function" in line):
                    log("build", line.strip())


def phase_kernels(dev) -> dict:
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
    fd = importlib.import_module(
        "repro_torch.kernels.flash_decode.flash_decode")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    kv, g, hd, bk = 8, 4, 128, 32

    def inputs(t, lens, dtype, sets=1):
        out = []
        for _ in range(sets):
            q, k, v = (torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.float32).to(dtype)
                       for shape in ((len(lens), kv, g, hd),
                                     (len(lens), kv, t, hd),
                                     (len(lens), kv, t, hd)))
            out.append((q, k, v, torch.tensor(lens, dtype=torch.int32,
                                              device=dev)))
        return out

    # correctness: serve shape, odd cache lengths, one layer's long cache;
    # at the plan's split count, unsplit, 7 splits and one split a tile; bf16
    # on the tensor cores, f32 (and bf16 in 24-row tiles) on CUDA cores
    cases = [(160, [1, 37, 128, 160], bk), (255, [1, 100, 254, 255], bk),
             (257, [257, 3, 129, 256], bk), (257, [257, 3, 129, 256], 24),
             (32768, [32768, 32767, 16385, 1], bk)]
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for t, lens, tile in cases:
            q, k, v, ln = inputs(t, lens, dtype)[0]
            want = flash_decode_ref(q, k, v, ln).float()
            for n_split in (None, 1, 7, -(-t // tile)):
                p = fd.plan(len(lens), kv, g, t, hd, q.element_size(), tile,
                            sms, n_split)
                before = (flash_decode.device_launches,
                          flash_decode.tensor_core_launches)
                got = (flash_decode(q, k, v, ln, bk=tile) if n_split is None
                       else fd._launch(q, k, v, ln, tile, p))
                torch.cuda.synchronize()
                kernels = flash_decode.device_launches - before[0]
                tc = flash_decode.tensor_core_launches - before[1]
                if kernels != 1 + (p.n_split > 1) or tc != p.tensor_cores \
                        or p.tensor_cores != (dtype == torch.bfloat16
                                              and tile % 16 == 0):
                    raise RuntimeError(f"flash_decode {dtype} bk={tile} "
                                       f"n_split={p.n_split} ran {kernels} "
                                       f"device kernels, {tc} on the tensor "
                                       f"cores")
                err = (got.float() - want).abs().max().item()
                torch.testing.assert_close(got.float(), want,
                                           **KERNEL_TOL[dtype])
                max_err = max(max_err, err)
                log("kernels", f"flash_decode {str(dtype)[6:]} B={len(lens)} "
                    f"KV={kv} G={g} hd={hd} T={t} lengths={lens} bk={tile}: "
                    f"{'tensor' if p.tensor_cores else 'CUDA'} cores, n_split="
                    f"{p.n_split}{' (plan)' if n_split is None else ''}, "
                    f"{p.stages} stages, {kernels} device kernels: max abs "
                    f"err {err:.3g} (tol "
                    f"{KERNEL_TOL[dtype]})")
                del got
            del q, k, v, want

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
        r = {"ms": time_ms(flash_decode, arg_sets, iters),
             "plain_ms": time_ms(flash_decode_ref, arg_sets, iters),
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": time_ms(sdpa_decode, lib_sets, iters)}
        p = fd.plan(len(lens), kv, g, t, hd, q.element_size(), bk, sms)
        nbytes = 2 * kv * hd * sum(lens) * q.element_size()
        log("kernels", f"flash_decode {str(dtype)[6:]} B={len(lens)} T={t} "
            f"lengths={lens[0]}: " + json.dumps(r) + f", "
            f"{'tensor' if p.tensor_cores else 'CUDA'} cores, n_split="
            f"{p.n_split}, {p.stages} stages, {nbytes / r['ms'] / 1e6:.0f} "
            f"GB/s achieved, roofline share {r['bound_ms'] / r['ms']:.3f}")
        return r

    # the main path's call: the serve cache (160 slots) at the mean length of
    # its 31 decode steps; 40 input sets (105 MB) rotate past the 50 MB L2
    main = timed(160, [144] * 4, torch.bfloat16, sets=40, iters=400)
    timed(32768, [32768] * 4, torch.bfloat16, sets=1, iters=20)
    # the split count at one layer's long cache: the plan's against others
    q, k, v, ln = inputs(32768, [32768] * 4, torch.bfloat16)[0]
    sweep = {}
    for n_split in (4, 8, 9, 12, 16, 33, 66):
        p = fd.plan(4, kv, g, 32768, hd, 2, bk, sms, n_split)
        sweep[n_split] = round(1e3 * time_ms(
            lambda *a, p=p: fd._launch(*a, bk, p), [(q, k, v, ln)], 20), 2)
    log("kernels", f"flash_decode bf16 B=4 T=32768, us a call by n_split: "
        f"{json.dumps(sweep)}; the plan takes "
        f"{fd.plan(4, kv, g, 32768, hd, 2, bk, sms).n_split}")
    del q, k, v, ln
    timed(8192, [8192], torch.bfloat16, sets=4, iters=100)   # one chat user
    timed(32768, [32768] * 4, torch.float32, sets=1, iters=10)
    torch.cuda.empty_cache()
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode/flash_decode.py:29",
            "max_abs_err": max_err, **main}


def phase_flash_attention(dev) -> dict:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, h, kv, sq, skv, d, dtype, layout="dense"):
        """q [B,H,Sq,d], k/v [B,KV,Skv,d]. "model": [B,S,H,d] storage seen
        through strides, as the train step passes; "batch_slice": every
        other batch of a larger tensor, a batch stride that is not dense."""
        def one(heads, s):
            if layout == "model":
                x = torch.randn((b, s, heads, d), generator=gen, device=dev)
                return x.to(dtype).transpose(1, 2)
            if layout == "batch_slice":
                x = torch.randn((2 * b, heads, s, d), generator=gen,
                                device=dev)
                return x.to(dtype)[::2]
            return torch.randn((b, heads, s, d), generator=gen,
                               device=dev).to(dtype)
        return one(h, sq), one(kv, skv), one(kv, skv)

    # (b, h, kv, sq, skv, d, causal, layout)
    cases = [(b, h, h, s, s, d, c, "dense")                 # the reference's
             for b, h, s, d in ((1, 1, 128, 64), (2, 4, 200, 64),
                                (1, 2, 384, 128), (2, 1, 65, 32))
             for c in (True, False)]
    cases += [(1, 8, 2, s, s, 128, True, "dense")
              for s in (65, 130, 200, 4097)]
    cases += [(1, 2, 2, 64, 200, 32, False, "dense"),        # Sq != Skv
              (1, 2, 2, 64, 200, 32, True, "dense"),
              (1, 2, 2, 8, 20, 32, True, "dense"),
              (1, 2, 2, 200, 65, 32, True, "dense")]
    cases += [(2, 8, kv, 96, 96, 32, True, "dense")          # G = 1, 4, 8
              for kv in (8, 2, 1)]
    cases += [(2, 4, 2, 200, 200, 64, c, "model")           # strided
              for c in (True, False)]
    # the bf16 kernel's 128 x 128 tile: its edges, Sq != Skv around it, and
    # a batch stride that is not dense, at every head dim
    cases += [(1, 8, 2, s, s, 128, c, "dense")
              for s in (1, 127, 128, 129, 255) for c in (True, False)]
    cases += [(1, 4, 2, sq, skv, d, c, "dense")
              for sq, skv, d in ((127, 129, 128), (129, 127, 64),
                                 (128, 255, 32), (255, 128, 128),
                                 (1, 129, 64))
              for c in (True, False)]
    cases += [(2, 4, 2, 257, 257, d, True, "batch_slice")
              for d in (32, 64, 128)]
    # head dim 16 (the smoke configs') at the bf16 tile's edges, GQA
    cases += [(2, 4, 2, s, s, 16, c, "dense")
              for s in (1, 127, 128, 129) for c in (True, False)]
    train = (TRAIN_BATCH, 32, 8, TRAIN_SEQ, TRAIN_SEQ, 128, True, "model")
    cases.append(train)
    max_err = 0.0
    flash_attention.tensor_core_launches = 0
    flash_attention.cuda_core_launches = 0
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, kv, sq, skv, d, causal, layout in cases:
            q, k, v = inputs(b, h, kv, sq, skv, d, dtype, layout)
            got = flash_attention(q, k, v, causal=causal)
            want = flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(),
                                       **KERNEL_TOL[dtype])
            max_err = max(max_err, err)
            log("attention", f"flash_attention {str(dtype)[6:]} B={b} H={h} "
                f"KV={kv} Sq={sq} Skv={skv} d={d} causal={causal} {layout}: "
                f"max abs err {err:.3g}")
            del q, k, v, got, want
        torch.cuda.empty_cache()
    routes = (flash_attention.tensor_core_launches,
              flash_attention.cuda_core_launches)
    if routes != (len(cases), len(cases)):
        raise RuntimeError(f"flash_attention routes (tensor cores, CUDA "
                           f"cores) {routes}: every bf16 call must take the "
                           f"tensor cores and every f32 call the CUDA cores, "
                           f"{len(cases)} each")
    log("attention", f"all {2 * len(cases)} cases within {KERNEL_TOL}; "
        f"{routes[0]} bf16 launches on the tensor cores, {routes[1]} f32 "
        f"on CUDA cores")
    log("attention", "bf16 kernel (ptxas -v): " + bf16_kernel_resources())

    # the main path's call: one layer's forward attention in the train step
    b, h, kv, s, _, d = train[:6]
    q, k, v = inputs(b, h, kv, s, s, d, torch.bfloat16, "model")
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
        f"{main['bound_ms'] / main['ms']:.4f} (library: SDPA, which rounds "
        f"P to bf16; the kernel feeds P as two bf16 halves)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_wgmma.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:32",
            "max_abs_err": max_err, **main}


def bf16_kernel_resources() -> str:
    """Registers and spills of each head dim's instantiation of the bf16
    kernel, from its ptxas -v build log, and its dynamic shared memory."""
    from repro_torch.kernels import _build
    lib = _build.lib_path("flash_attention")
    log_lines = lib.with_name(lib.name + ".log").read_text().splitlines()
    smem = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention"
    )._kernel_lib().flash_attention_bf16_smem_bytes
    out, hd = [], None
    for line in log_lines:
        found = re.search(r"flash_attention_wgmma_kernelILi(\d+)E", line)
        if "Compiling entry function" in line:
            hd = int(found.group(1)) if found else None
        elif hd is not None and "spill" in line:
            spills = re.findall(r"(\d+) bytes spill", line)
        elif hd is not None and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"d={hd}: {regs} registers, spill stores/loads "
                       f"{'/'.join(spills)} bytes, {smem(hd)} bytes of "
                       f"dynamic shared memory")
            hd = None
    if len(out) != len((16, 32, 64, 128)):
        raise RuntimeError(f"bf16 kernel entries not found in {lib}.log")
    # the library's machine code: tensor-core products and TMA loads, and
    # no bf16 instantiation of the CUDA-core kernel
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")),
                           "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    if not all(counts.values()) or "flash_attention_kernelI13__nv_bfloat16" \
            in sass:
        raise RuntimeError(f"flash_attention SASS: {counts}, or a bf16 "
                           f"CUDA-core kernel is left")
    return "; ".join(out) + f"; SASS {counts}"


def phase_serve(card: str) -> int:
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch import serve
    from repro_torch.models import LM

    torch.cuda.reset_peak_memory_stats()
    flash_decode.launches = 0
    flash_decode.device_launches = 0
    flash_decode.tensor_core_launches = 0
    r = serve.main(["--arch", ARCH, "--batch", str(BATCH),
                    "--prompt-len", str(PROMPT), "--gen", str(GEN)])
    launches, kernels = flash_decode.launches, flash_decode.device_launches
    if flash_decode.tensor_core_launches != launches:
        raise RuntimeError(f"flash_decode: {flash_decode.tensor_core_launches}"
                           f" of {launches} calls on the tensor cores")
    cfg = r.model.cfg
    want = cfg.num_layers * (GEN - 1)
    if launches != want:
        raise RuntimeError(f"flash_decode launched {launches} times, "
                           f"expected {want}")
    # the plan follows the cache's slots, not the lengths: one split count
    # for every decode step
    t = r.cache["self"]["k"].shape[3]
    n_split = importlib.import_module(
        "repro_torch.kernels.flash_decode.flash_decode").plan(
        BATCH, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, t,
        cfg.head_dim, r.cache["self"]["k"].element_size(), 32,
        torch.cuda.get_device_properties(0).multi_processor_count).n_split
    if kernels != launches * (1 + (n_split > 1)):
        raise RuntimeError(f"flash_decode ran {kernels} device kernels in "
                           f"{launches} calls at n_split={n_split}")
    if r.tokens.shape != (BATCH, GEN) or not torch.isfinite(
            r.logits.float()).all():
        raise RuntimeError("serve produced non-finite logits or a bad shape")
    log("serve", f"{cfg.name} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}): flash_decode launches {launches} = "
        f"{cfg.num_layers} layers x {GEN - 1} decode steps, all on the "
        f"tensor cores; {kernels} device kernels (a {t}-slot cache: "
        f"n_split={n_split}, split and combine)")

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
    device_profile("profile", "2 decode steps", step, reps=2,
                   watch="flash_decode")


def device_profile(phase: str, what: str, step, reps: int,
                   watch: str = "") -> int:
    """Busy time of the device kernels of ``reps`` warm calls of ``step``,
    the device's idle share over the span from the first kernel's start to
    the last one's end, the kernels that take the most time, and those
    whose name holds ``watch`` wherever they rank. Returns the number of
    device kernels recorded."""
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
        return 0
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
    ranked = sorted(by_name.items(), key=lambda x: -x[1][0])
    for rank, (name, (ms, n)) in enumerate(ranked, 1):
        if rank <= 8 or (watch and watch in name):
            log(phase, f"{ms:8.3f} ms {100 * ms / busy:5.1f}%  x{n:<4d} "
                f"#{rank} {name[:90]}")
    return len(kernels)


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
    flash_attention.tensor_core_launches = 0
    flash_attention.cuda_core_launches = 0
    r = train.train(cfg, shape, steps=TRAIN_STEPS, device="cuda",
                    log=lambda m: log("train", m))
    launches = flash_attention.launches
    routes = (flash_attention.tensor_core_launches,
              flash_attention.cuda_core_launches)
    # remat="full" checkpoints each layer: its forward runs once in the
    # forward pass and once more when backward recomputes it, and each run
    # launches the kernel once (the backward itself is the plain version)
    if cfg.remat != "full":
        raise RuntimeError(f"expected remat='full', got {cfg.remat!r}")
    want = 2 * cfg.num_layers * TRAIN_STEPS
    if launches != want:
        raise RuntimeError(f"flash_attention launched {launches} times, "
                           f"expected {want}")
    if routes != (want, 0):
        raise RuntimeError(f"flash_attention routes (tensor cores, CUDA "
                           f"cores) {routes}: every bf16 launch must take "
                           f"the tensor cores")
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
        f"{cfg.num_layers} layers x {TRAIN_STEPS} steps (remat='full'), all "
        f"on the tensor cores")
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
    device_profile("train", "1 train step", one_step, reps=1,
                   watch="flash_attention")

    check_adamw_step(r.model, state["s"], data.batch(TRAIN_STEPS + 1),
                     opt_cfg)
    params = r.state["params"]
    del r, state
    torch.cuda.empty_cache()
    check_train_branches(cfg, params, data.batch(0))
    return launches


def phase_train_smoke(card: str) -> None:
    """``python -m repro_torch.launch.train --smoke --steps 4`` on the card:
    the smoke config's head dim is 16, so every flash_attention launch must
    take the bf16 tensor-core kernel at d = 16."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train

    for name in ("launches", "tensor_core_launches", "cuda_core_launches"):
        setattr(flash_attention, name, 0)
    t0 = time.perf_counter()
    r = train.main(["--smoke", "--steps", "4"])
    secs = time.perf_counter() - t0
    cfg = r.model.cfg
    want = 4 * (2 if cfg.remat == "full" else 1) * cfg.num_layers
    routes = (flash_attention.launches, flash_attention.tensor_core_launches,
              flash_attention.cuda_core_launches)
    if cfg.head_dim != 16 or r.model._impl(128) != "flash" or \
            r.model.cfg.dtype != "bfloat16":
        raise RuntimeError(f"train --smoke: head dim {cfg.head_dim}, dtype "
                           f"{cfg.dtype}, impl {r.model._impl(128)}")
    if routes != (want, want, 0):
        raise RuntimeError(f"train --smoke: flash_attention (all, tensor "
                           f"cores, CUDA cores) {routes}, want "
                           f"{(want, want, 0)}")
    if len(r.losses) != 4 or not all(math.isfinite(x) for x in r.losses):
        raise RuntimeError(f"train --smoke losses: {r.losses}")
    log("train-smoke", f"{cfg.name} (head dim {cfg.head_dim}, "
        f"{cfg.num_layers} layers, remat={cfg.remat!r}): flash_attention "
        f"launches {want} = 4 steps x {want // 4} a step, all on the bf16 "
        f"tensor-core kernel at d = 16; losses "
        f"{[round(x, 4) for x in r.losses]}; {secs:.1f} s on {card}")


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


def maxplus_bound(m: int, k: int, n: int):
    """(least ms, what bounds it) for one max-plus product: M N K add/max
    pairs at the card's FMNMX rate, against A, B read and C written once."""
    t_ops = m * n * k / MAXPLUS_PER_S
    t_bytes = 4 * (m * k + k * n + m * n) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def stencil_bound(h: int, w: int):
    """(least ms, what bounds it) for one 3x3 stencil: x read and out
    written once, against 18 f32 operations a pixel at the card's peak."""
    t_bytes = 8 * h * w / HBM_BYTES_PER_S
    t_ops = STENCIL_OPS_PER_PIXEL * h * w / PEAK_FLOPS[torch.float32]
    return 1e3 * max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nan_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit where not NaN, and NaN at the same positions."""
    return torch.equal(got.isnan(), want.isnan()) and torch.equal(
        got.nan_to_num(0.0), want.nan_to_num(0.0))


def maxplus_sass() -> str:
    """The max-plus library's running max in its machine code: one
    FMNMX.NAN (PTX max.NaN.f32), no plain FMNMX (fmaxf) and no compare-and-
    select."""
    from repro_torch.kernels import _build
    lib = _build.lib_path("maxplus")
    sass = subprocess.run([str(Path(_build._nvcc()).with_name("cuobjdump")),
                           "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts = {"FMNMX.NAN": len(re.findall(r"FMNMX\.NAN\b", sass)),
              "FMNMX": len(re.findall(r"FMNMX(?!\.NAN)\b", sass)),
              "FSETP": sass.count("FSETP"), "FSEL": sass.count("FSEL")}
    if not counts["FMNMX.NAN"] or counts["FMNMX"] or counts["FSEL"]:
        raise RuntimeError(f"maxplus SASS: {counts}")
    return json.dumps(counts)


def phase_maxplus(dev, path: list) -> dict:
    """``path``: (n, launches) of each longest path the compile phase ran."""
    from repro_torch.kernels.maxplus import (NEG_INF, maxplus_matmul,
                                             maxplus_matmul_plain)
    mp = importlib.import_module("repro_torch.kernels.maxplus.maxplus")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(2)

    def operand(rows, cols):
        """Normal entries, half of them absent (NEG_INF), as in a timing
        matrix, so that the floor is reached."""
        x = torch.randn(rows, cols, generator=gen, device=dev)
        x[torch.rand(rows, cols, generator=gen, device=dev) < 0.5] = NEG_INF
        return x

    def with_nan(x):
        """x with NaN at about one entry in ten thousand (at least one)."""
        x = x.clone()
        rows, cols = x.shape
        idx = torch.randint(0, rows * cols, (max(1, rows * cols // 10000),),
                            generator=gen, device=dev)
        x.view(-1)[idx] = float("nan")
        return x

    shapes = [(8, 8, 8), (100, 130, 70), (128, 128, 128), (200, 50, 300),
              (1, 257, 1), (150, 90, 60)]                  # the reference's
    sizes = sorted({n for n, _ in path})
    shapes += [(n, n, n) for n in sizes]
    shapes += [(1000, 999, 1001), (4096, 4096, 4096)]
    max_err = 0.0
    for m, k, n in shapes:
        a, b = operand(m, k), operand(k, n)
        p = mp.plan(m, n, k, sms)
        got, want = maxplus_matmul(a, b), maxplus_matmul_plain(a, b)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise RuntimeError(f"maxplus {m}x{k}x{n}: kernel differs from its "
                               f"plain version, max abs err {err}")
        max_err = max(max_err, err)
        an, bn = with_nan(a), with_nan(b)
        got, want = maxplus_matmul(an, bn), maxplus_matmul_plain(an, bn)
        if not nan_equal(got, want) or not want.isnan().any():
            raise RuntimeError(f"maxplus {m}x{k}x{n} with NaN: kernel differs "
                               f"from its plain version")
        log("maxplus", f"M={m} K={k} N={n} ({p.tile}x{p.tile} tiles, "
            f"{p.splits} K split{'s' if p.splits > 1 else ''}): equal to the "
            f"plain version bit for bit ({(got == NEG_INF).float().mean().item():.3f}"
            f" of outputs at the floor); with NaN entries, NaN at the same "
            f"{int(want.isnan().sum())} outputs")
        del a, b, an, bn, got, want
    # the floor is the TPU kernel's function, not its oracle's
    a = torch.tensor([[NEG_INF, NEG_INF], [0., 1.]], device=dev)
    b = torch.tensor([[-500., 2.], [-700., 3.]], device=dev)
    got = maxplus_matmul(a, b)
    if got[0, 0].item() != NEG_INF or not torch.equal(
            got, maxplus_matmul_plain(a, b)):
        raise RuntimeError(f"maxplus floor: got {got.tolist()}")
    log("maxplus", f"floor example: {got.tolist()} (the oracle without a "
        f"floor gives -1000000512 at [0, 0])")
    log("maxplus", "SASS of the running max: " + maxplus_sass())

    def square(p=None):
        """One squaring through the wrapper (``plan``'s choice) or, given a
        plan, through the kernel's launch with that tile and K split."""
        if p is None:
            return lambda x: maxplus_matmul(x, x)
        return lambda x: mp._launch(x, x, p)

    # every tile and K-split choice at each closure size of the path:
    # checked bit for bit (NaN included) and timed; the plan's choice marked
    for n in sizes:
        x = with_nan(operand(n, n))
        want = maxplus_matmul_plain(x, x)
        a = torch.randn(n, n, generator=gen, device=dev)
        chosen = mp.plan(n, n, n, sms)
        row = {}
        for tile in mp.TILES:
            for splits in (1, 2, 4, 8, 16):
                p = mp.plan(n, n, n, sms, tile=tile, splits=splits)
                key = f"{p.tile}/{p.splits}"
                if key in row:
                    continue
                if not nan_equal(square(p)(x), want):
                    raise RuntimeError(f"maxplus n={n} tile {tile}, {p.splits} "
                                       f"splits: differs from the plain version")
                row[key] = round(1e3 * time_ms(square(p), [(a,)], 50), 2)
        log("maxplus", f"n={n}: each (tile/K splits) choice equal to the "
            f"plain version, NaN included; us a squaring: {json.dumps(row)}; "
            f"the plan takes {chosen.tile}/{chosen.splits}")
        del x, want, a

    def timed(n, iters, plain_iters):
        a = torch.randn(n, n, generator=gen, device=dev)
        bound_ms, bound_by = maxplus_bound(n, n, n)
        return {"ms": time_ms(square(), [(a,)], iters),
                "plain_ms": time_ms(lambda x: maxplus_matmul_plain(x, x),
                                    [(a,)], plain_iters),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}

    # one squaring at each closure size of the path, and the plain version
    # at the largest; the path's kernel time and what it spends over bound
    ms_at = {n: time_ms(square(),
                        [(torch.randn(n, n, generator=gen, device=dev),)],
                        200) for n in sizes}
    path_ms = sum(k * ms_at[n] for n, k in path)
    over_ms = sum(k * (ms_at[n] - maxplus_bound(n, n, n)[0]) for n, k in path)
    log("maxplus", "one squaring at each size of the path (ms): "
        + json.dumps(ms_at) + f"; the path's {sum(k for _, k in path)} "
        f"launches: {path_ms:.4f} ms, {over_ms:.4f} ms above their bounds")
    main = timed(sizes[-1], iters=200, plain_iters=10)
    log("maxplus", f"n={sizes[-1]} (the path's largest), one squaring: "
        + json.dumps(main) + f", roofline share "
        f"{main['bound_ms'] / main['ms']:.3f}")
    big = timed(4096, iters=5, plain_iters=1)
    a = torch.randn(4096, 4096, generator=gen, device=dev)
    again = [time_ms(square(), [(a,)], 5) for _ in range(5)]
    del a
    log("maxplus", "n=4096, one squaring: " + json.dumps(big)
        + f", roofline share {big['bound_ms'] / big['ms']:.3f}; five more "
        f"readings of 5 squarings (ms): {json.dumps(again)}")
    torch.cuda.empty_cache()
    return {"name": "maxplus", "route": "cuda",
            "source": "src/repro_torch/kernels/maxplus/csrc/maxplus.cu",
            "replaces": "src/repro/kernels/maxplus/maxplus.py:29",
            "max_abs_err": max_err, **main}


def phase_stencil(dev) -> dict:
    from repro_torch.core import DENSE_APPS
    from repro_torch.kernels import stencil as S
    gen = torch.Generator(device=dev).manual_seed(3)
    frames = [DENSE_APPS[app].frame for app, _ in GOLDEN]
    shapes = [(8, 16), (100, 240), (128, 128), (77, 515), (300, 200)]
    max_err = 0.0
    for h, w in shapes + frames:
        x = torch.randn(h, w, generator=gen, device=dev)
        for name in ("GAUSS3", "SHARPEN3", "SOBEL_X3", "SOBEL_Y3"):
            got = S.stencil3x3(x, getattr(S, name))
            want = S.stencil3x3_ref(x, getattr(S, name))
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            max_err = max(max_err, (got - want).abs().max().item())
        log("stencil", f"H={h} W={w}: 4 weight sets within rtol=atol=1e-5 "
            f"of the plain version (max abs err so far {max_err:.3g})")
        del x, got, want

    def conv(w4):
        return lambda x: F.conv2d(x[None, None], w4, padding=1)[0, 0]

    results = {}
    for (app, _), (h, w) in zip(GOLDEN, frames):
        x = torch.randn(h, w, generator=gen, device=dev)
        lib = conv(S.GAUSS3.to(dev)[None, None])
        torch.testing.assert_close(lib(x), S.stencil3x3_ref(x, S.GAUSS3),
                                   rtol=1e-4, atol=1e-4)
        bound_ms, bound_by = stencil_bound(h, w)
        results[app] = {
            "ms": time_ms(lambda t: S.stencil3x3(t, S.GAUSS3), [(x,)], 50),
            "plain_ms": time_ms(lambda t: S.stencil3x3_ref(t, S.GAUSS3),
                                [(x,)], 10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lib, [(x,)], 50)}
        r = results[app]
        log("stencil", f"{app} frame {h}x{w} ({8 * h * w / 1e6:.0f} MB "
            f"moved): " + json.dumps(r) + f", {8 * h * w / r['ms'] / 1e6:.0f}"
            f" GB/s achieved, roofline share {r['bound_ms'] / r['ms']:.3f}")
        del x
    torch.cuda.empty_cache()
    return {"name": "stencil", "route": "cuda",
            "source": "src/repro_torch/kernels/stencil/csrc/stencil.cu",
            "replaces": "src/repro/kernels/stencil/stencil.py:26",
            "max_abs_err": max_err, **results["gaussian"]}


def table1_designs(c):
    """Table I on the host: ([(label, CompileResult)], {(app, flow):
    CompileResult}, the seconds it took)."""
    from repro_torch.core import DENSE_APPS, PassConfig
    designs, table1 = [], {}
    t0 = time.perf_counter()
    for app, spec in DENSE_APPS.items():
        for flow in ("unpipelined", "full"):
            r = c.compile(spec, getattr(PassConfig, flow)(
                place_moves=TABLE1_MOVES), verify=True, use_cache=False)
            designs.append((f"{app} {flow}", r))
            table1[(app, flow)] = r
    return designs, table1, time.perf_counter() - t0


def phase_compile(dev, card: str):
    """Returns (n, maxplus launches) of each longest path run, the maxplus
    and stencil launch counts of the path, and the host run's Table I as
    {(app, flow): CompileResult}."""
    from repro_torch.core import DENSE_APPS, CascadeCompiler, PassConfig
    from repro_torch.core.netlist import design_digest
    from repro_torch.core.sta import longest_path_maxplus, timing_matrix
    from repro_torch.kernels import stencil as S
    from repro_torch.kernels.maxplus import (NEG_INF, longest_path,
                                             maxplus_matmul)

    c = CascadeCompiler()
    designs, table1, secs = table1_designs(c)
    for app, spec in DENSE_APPS.items():
        r0, r1 = table1[(app, "unpipelined")], table1[(app, "full")]
        log("compile", f"{app}: critical path {r0.sta.critical_path_ns:.3f}"
            f" -> {r1.sta.critical_path_ns:.3f} ns (ratio "
            f"{r0.sta.critical_path_ns / r1.sta.critical_path_ns:.2f}), EDP "
            f"ratio {r0.power.edp_js / r1.power.edp_js:.2f}, runtime "
            f"{r0.power.runtime_s * 1e3:.3f} -> {r1.power.runtime_s * 1e3:.3f}"
            f" ms; compiled and verified in {r0.compile_seconds:.2f} + "
            f"{r1.compile_seconds:.2f} s")
    log("compile", f"Table I: {len(designs)} designs (place_moves="
        f"{TABLE1_MOVES}, verify=True) in {secs:.2f} s on the host")
    for app, (digest, cp, regs) in STRAIGHT_LINE_PINS.items():
        r = c.compile(DENSE_APPS[app], PassConfig.full(place_moves=40),
                      use_cache=False)
        got = (design_digest(r.design), round(r.sta.critical_path_ns, 6),
               r.design.physical_register_count())
        if got != (digest, cp, regs):
            raise RuntimeError(f"{app} pin: got {got}, want "
                               f"{(digest, cp, regs)}")
        designs.append((f"{app} pin", r))
    log("compile", "STRAIGHT_LINE_PINS hold (critical path ns, registers, "
        "design digest): " + ", ".join(f"{a} {p[1]} / {p[2]}"
                                      for a, p in STRAIGHT_LINE_PINS.items()))

    gen = torch.Generator(device=dev).manual_seed(4)
    S.stencil3x3.launches = 0
    maxplus_matmul.launches = 0
    maxplus_matmul.device_launches = 0
    paths, golden = [], []
    for label, r in designs:
        m, verts = timing_matrix(r.design, c.timing)
        src = verts.index("SRC")
        arr = longest_path(torch.from_numpy(m).to(dev), src)
        paths.append((label, m, src, arr))
    for app, op in GOLDEN:
        h, w = DENSE_APPS[app].frame
        x = torch.randint(0, 256, (h, w), generator=gen, device=dev,
                          dtype=torch.int32).float()
        golden.append((app, op, x, getattr(S, op)(x)))
    torch.cuda.synchronize()
    mp, st = maxplus_matmul.launches, S.stencil3x3.launches
    mp_kernels = maxplus_matmul.device_launches
    path = [(m.shape[0], max(1, math.ceil(math.log2(max(m.shape[0], 2)))))
            for _, m, _, _ in paths]
    want_mp = sum(k for _, k in path)
    if mp != want_mp or st != 4:
        raise RuntimeError(f"launches: maxplus {mp} (want {want_mp}), "
                           f"stencil {st} (want 4)")
    log("compile", f"launches: maxplus {mp} = sum over the {len(designs)} "
        f"designs of max(1, ceil(log2 n)), {mp_kernels} device kernels (a "
        f"K-split squaring runs two); stencil {st} (1 gaussian_blur, "
        f"1 sharpen, 2 in sobel_mag2)")

    for label, m, src, arr in paths:
        got = arr.cpu().numpy()
        want = longest_path_maxplus(m, src)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
        reached = int((got > NEG_INF / 2).sum())
        log("compile", f"{label}: n={m.shape[0]}, longest path from SRC "
            f"through the kernel: {reached} vertices reached, latest "
            f"arrival {got.max():.4f} ns, max abs err vs numpy "
            f"{np.abs(got - want).max():.3g} (tol rtol 1e-4, atol 1e-3)")
    def sobel_mag2_plain(x):
        gx, gy = (S.stencil3x3_ref(x, w) for w in (S.SOBEL_X3, S.SOBEL_Y3))
        return gx * gx + gy * gy

    plain = {"gaussian_blur": lambda x: S.stencil3x3_ref(x, S.GAUSS3),
             "sharpen": lambda x: S.stencil3x3_ref(x, S.SHARPEN3),
             "sobel_mag2": sobel_mag2_plain}
    for app, op, x, out in golden:
        want = plain[op](x)
        if out.shape != x.shape or not torch.isfinite(out).all():
            raise RuntimeError(f"{op} on the {app} frame: bad output")
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        log("compile", f"{op} on the {app} frame {tuple(x.shape)}: finite, "
            f"max abs err vs the plain version "
            f"{(out - want).abs().max().item():.3g} (tol rtol=atol=1e-5), "
            f"range [{out.min().item():.1f}, {out.max().item():.1f}]")
    del golden, paths
    torch.cuda.empty_cache()
    log("compile", f"on {card}")
    return path, mp, st, table1


# the compiler's device engines: the design points of
# benchmarks/pnr_kernels.py and benchmarks/sta_pipeline.py (the same five),
# seed 0; the post-PnR loop at sta_pipeline's test bar of 40 rounds
ENGINE_POINTS = (("gaussian", 1), ("camera", 2), ("harris", 1),
                 ("mttkrp", 2), ("harris", 4))
STA_LOOP_ITERS = 40
STA_REPEATS = 20


def sta_fields(rep) -> tuple:
    return (rep.critical_path_ns, rep.max_freq_mhz, rep.clock_period_ns,
            rep.n_segments, rep.critical_path, rep.arrival_out)


def loop_state(design, res) -> tuple:
    return (res.history, res.stop_reason, res.iterations, res.initial_ns,
            res.final_ns, res.registers_added,
            sorted((k, sorted(rb.reg_hops)) for k, rb in design.routes.items()),
            [b.n_regs for b in design.netlist.branches])


def phase_engines(dev, card: str, table1: dict) -> dict:
    """The compiler's torch engines on the card: place and route against
    numpy and A* on the host, STA and the post-PnR loop against the scalar
    walk, Table I through them (returned as {(app, flow): CompileResult})."""
    import copy

    from repro_torch.core import (ALL_APPS, DENSE_APPS, CascadeCompiler,
                                  PassConfig, PostPnRParams, analyze,
                                  analyze_vec, generate_timing_model,
                                  lower_design, post_pnr_pipeline)
    from repro_torch.core.interconnect import Fabric
    from repro_torch.core.netlist import design_digest, extract_netlist
    from repro_torch.core.place import PlaceParams, place
    from repro_torch.core.route import RouteParams, check_legal, route

    # every engine copies its result to the host before it returns, so the
    # host clock spans the device work
    t_phase = time.perf_counter()
    fabric = Fabric()

    def pnr(nl, backend):
        stats = {}
        t0 = time.perf_counter()
        placement = place(nl, fabric, PlaceParams(seed=0, backend=backend),
                          stats=stats, device=dev)
        t1 = time.perf_counter()
        design = route(nl, placement, fabric, RouteParams(backend=backend),
                       device=dev)
        t2 = time.perf_counter()
        check_legal(nl, placement, fabric, design)
        hops = {k: [(h.src, h.dst) for h in rb.hops]
                for k, rb in design.routes.items()}
        return {"place_s": t1 - t0, "route_s": t2 - t1,
                "cost": stats["best_cost"], "wl": design.total_wirelength(),
                "stats": stats, "result": (placement, hops)}

    for app, mult in ENGINE_POINTS:
        nl = extract_netlist(ALL_APPS[app].build(mult))
        host = pnr(nl, "numpy")
        first, warm = pnr(nl, "torch"), pnr(nl, "torch")
        if warm["result"] != first["result"]:
            raise RuntimeError(f"{app}x{mult}: torch PnR differs run to run")
        if warm["cost"] > host["cost"] or warm["wl"] > host["wl"]:
            raise RuntimeError(
                f"{app}x{mult}: torch cost {warm['cost']:.1f} / wirelength "
                f"{warm['wl']} above numpy {host['cost']:.1f} / A* "
                f"{host['wl']}")
        st = warm["stats"]
        log("engines", f"PnR {app}x{mult} ({len(nl.nodes)} nodes): place "
            f"numpy {host['place_s']:.3f} s, torch {first['place_s']:.3f} s "
            f"first / {warm['place_s']:.3f} s warm ({st['replicas']} "
            f"replicas, {st['moves_evaluated']} moves evaluated, "
            f"{st['moves_accepted']} accepted); cost {host['cost']:.1f} -> "
            f"{warm['cost']:.1f} (ratio {warm['cost'] / host['cost']:.3f}); "
            f"route A* {host['route_s']:.3f} s, torch {first['route_s']:.3f}"
            f" s first / {warm['route_s']:.3f} s warm; wirelength "
            f"{host['wl']} -> {warm['wl']}; legal, same result twice")

    c = CascadeCompiler(device=dev)
    for app, mult in ENGINE_POINTS:
        r = c.compile(ALL_APPS[app], PassConfig(post_pnr=False), unroll=mult)
        design = r.design
        tm = generate_timing_model(design.fabric)
        want = analyze(design, tm)
        if sta_fields(analyze(design, tm, backend="torch",
                              device=dev)) != sta_fields(want):
            raise RuntimeError(f"{app}x{mult}: torch STA report differs "
                               f"from the scalar walk")
        L = lower_design(design, tm)
        analyze_vec(design, tm, backend="torch", lowering=L, device=dev)
        ms = {}
        for backend, fn in (
                ("scalar", lambda: analyze(design, tm)),
                ("numpy", lambda: analyze_vec(design, tm, lowering=L)),
                ("torch", lambda: analyze_vec(design, tm, backend="torch",
                                              lowering=L, device=dev))):
            t0 = time.perf_counter()
            for _ in range(STA_REPEATS):
                fn()
            ms[backend] = (time.perf_counter() - t0) * 1e3 / STA_REPEATS
        loops = {}
        for backend in ("scalar", "numpy", "torch"):
            d = copy.deepcopy(design)
            t0 = time.perf_counter()
            res = post_pnr_pipeline(
                d, tm, PostPnRParams(max_iters=STA_LOOP_ITERS),
                sta_backend=backend,
                lowering=None if backend == "scalar" else L, device=dev)
            loops[backend] = ((time.perf_counter() - t0) * 1e3,
                              loop_state(d, res))
        for backend in ("numpy", "torch"):
            if loops[backend][1] != loops["scalar"][1]:
                raise RuntimeError(f"{app}x{mult}: the {backend} post-PnR "
                                   f"loop differs from the scalar loop")
        state = loops["scalar"][1]
        log("engines", f"STA {app}x{mult} ({L.n_verts} vertices, "
            f"{L.n_levels} levels, {L.n_sites} register sites): torch report"
            f" == scalar, field by field; ms per analyze scalar "
            f"{ms['scalar']:.3f}, numpy {ms['numpy']:.3f}, torch "
            f"{ms['torch']:.3f}; post-PnR loop ({state[2]} rounds, "
            f"{state[1]}, {state[3]:.3f} -> {state[4]:.3f} ns, "
            f"{state[5]} registers) byte-identical, ms scalar "
            f"{loops['scalar'][0]:.1f}, numpy {loops['numpy'][0]:.1f}, "
            f"torch {loops['torch'][0]:.1f}")

    t0 = time.perf_counter()
    dev_runs = {}
    for (app, flow), host_r in table1.items():
        r = c.compile(DENSE_APPS[app], getattr(PassConfig, flow)(
            place_moves=TABLE1_MOVES, pnr_backend="torch",
            sta_backend="torch"), verify=True, use_cache=False)
        if "verify" not in r.pass_stats["pipeline"]:
            raise RuntimeError(f"{app} {flow}: not verified")
        dev_runs[(app, flow)] = r
    secs = time.perf_counter() - t0
    for app in DENSE_APPS:
        h0, h1 = (table1[(app, f)] for f in ("unpipelined", "full"))
        d0, d1 = (dev_runs[(app, f)] for f in ("unpipelined", "full"))
        log("engines", f"Table I {app} on the torch engines: critical path "
            f"{d0.sta.critical_path_ns:.3f} -> {d1.sta.critical_path_ns:.3f}"
            f" ns (ratio {d0.sta.critical_path_ns / d1.sta.critical_path_ns:.2f};"
            f" host {h0.sta.critical_path_ns:.3f} -> "
            f"{h1.sta.critical_path_ns:.3f}, ratio "
            f"{h0.sta.critical_path_ns / h1.sta.critical_path_ns:.2f}), EDP "
            f"ratio {d0.power.edp_js / d1.power.edp_js:.2f} (host "
            f"{h0.power.edp_js / h1.power.edp_js:.2f}); verified")
    log("engines", f"Table I: {len(dev_runs)} designs with pnr_backend="
        f"sta_backend='torch' (place_moves={TABLE1_MOVES}, verify=True) in "
        f"{secs:.2f} s")

    t0 = time.perf_counter()
    for (app, flow), host_r in table1.items():
        r = c.compile(DENSE_APPS[app], getattr(PassConfig, flow)(
            place_moves=TABLE1_MOVES, sta_backend="torch"), use_cache=False)
        if design_digest(r.design) != design_digest(host_r.design):
            raise RuntimeError(f"{app} {flow}: sta_backend='torch' changed "
                               f"the design digest")
    for app, (digest, cp, regs) in STRAIGHT_LINE_PINS.items():
        r = c.compile(DENSE_APPS[app], PassConfig.full(
            place_moves=40, sta_backend="torch"), use_cache=False)
        got = (design_digest(r.design), round(r.sta.critical_path_ns, 6),
               r.design.physical_register_count())
        if got != (digest, cp, regs):
            raise RuntimeError(f"{app} pin with sta_backend='torch': got "
                               f"{got}, want {(digest, cp, regs)}")
    log("engines", f"sta_backend='torch' alone: the {len(table1)} Table I "
        f"design digests equal the host run's and the "
        f"{len(STRAIGHT_LINE_PINS)} STRAIGHT_LINE_PINS hold "
        f"({time.perf_counter() - t0:.2f} s)")
    log("engines", f"phase took {time.perf_counter() - t_phase:.1f} s on "
        f"{card}")
    return dev_runs


# the simulator: benchmarks/sim_throughput.py's workloads (seed 0: every
# dense and control app at 1024 cycles, harris at 4096, every sparse app at
# 64 tokens with max_cycles 64 x 40), Table I's routed netlists through the
# compiler's verify check (equivalent, n = 32) and a graph that deadlocks
SIM_SEED, SIM_CYCLES, SIM_HARRIS_CYCLES, SIM_TOKENS = 0, 1024, 4096, 64
SIM_WARM = 3                    # warm repeats, best taken, as the benchmark
SIM_NETLIST_CYCLES = 128
# 32-bit integer ops at the H100's f32 peak outside the tensor cores (its
# int32 rate is at most that)
INT32_OPS_PER_S = PEAK_FLOPS[torch.float32]
# the chain programs: INPUT -> k chained PEs -> OUTPUT at 4096 cycles; the
# add chains at k = 1 and 33 give ns a stage and the fixed ns a cycle, the
# mixed chain (its ops in turn, then a ROM of a length that is not a power
# of two) the cost of mixing micro-ops in a round
SIM_CHAIN_CYCLES = 4096
CHAIN_MIX = ("add", "mul", "xor", "sub", "shr", "min", "max", "or", "and",
             "gt", "abs", "eq", "shl", "ne", "le", "ge")
CHAIN_ROM = [(977 * t + 11) % 65536 for t in range(37)]
# the latency floor, an assumption for reading, not a gate: one dependent
# shared-memory step takes 30 SM clocks at the card's clocks.max.sm; a
# sim_dense cycle is (stages + 1) steps (its stages and the sample), a
# sim_sparse round 3 (the counts and read pointers, the heads, the stores)
STEP_CLOCKS = 30
SPARSE_ROUND_STEPS = 3
# the kernels' global route: the smallest seeded wide DAG past a block's
# opt-in shared memory (232 448 bytes on an H100) and one about 4x past it,
# as dense programs at 256 cycles, and the smallest seeded wide DAG past it
# as a sparse program at SIM_TOKENS tokens (tests/test_torch_card.py _wide)
SIM_GLOBAL_WIDTHS, SIM_GLOBAL_CYCLES = (1018, 4096), 256
SIM_GLOBAL_SPARSE_WIDTH = 176


def sim_inputs(g, length: int, rng) -> dict:
    return {n: rng.integers(0, 0x10000, size=length).tolist()
            for n, nd in g.nodes.items() if nd.kind == "input"}


def best_s(fn, repeat: int):
    """(best host seconds of ``repeat`` calls, the last call's result)."""
    best, out = float("inf"), None
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def event_ms(fn, reps: int) -> float:
    """Device ms per call over ``reps`` calls, between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sim_bound(nbytes: int, ops: int):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dense_function_bytes(prog, cycles: int) -> int:
    """Bytes a dense simulation must move, whatever its encoding: the input
    and output streams (int64), and the program read once: a 16-byte
    descriptor (op and three operands) a node that is neither an input nor
    a constant, 8 bytes a constant (slot, value), 4 bytes a latency, 4
    bytes a ROM entry."""
    n_in, n_const = len(prog.input_pos), len(prog.const_pos)
    roms = int(prog.tab_len.sum()) if prog.tab_len is not None else 0
    return (8 * (n_in + len(prog.output_pos)) * cycles
            + 16 * (prog.n_nodes - n_in - n_const) + 8 * n_const
            + 4 * len(prog.seq_pos) + 4 * roms)


def sparse_program_bytes(prog) -> int:
    """Bytes of a sparse program read once, whatever its encoding: a 16-byte
    descriptor (op and three input buffers) a node, 4 bytes a fan-out edge
    of a node or an input, 4 bytes a buffer's capacity, 8 bytes a constant
    buffer (buffer, value), 4 bytes an output's buffer, 4 bytes a ROM
    entry."""
    edges = int(prog.ev_out_mask.sum()) + int(prog.in_out_mask.sum())
    return (16 * len(prog.ev_names) + 4 * edges + 4 * prog.n_buf
            + 8 * len(prog.const_buf) + 4 * len(prog.out_buf)
            + 4 * int(prog.tab_len.sum()))


def stream_err(got: dict, want: dict) -> int:
    """Largest absolute difference between two sets of output streams,
    which must have the same names and lengths."""
    if got.keys() != want.keys() or any(len(got[k]) != len(want[k])
                                        for k in got):
        raise RuntimeError("sim: the streams' names or lengths differ")
    return max((abs(a - b) for k in got for a, b in zip(got[k], want[k])),
               default=0)


def deadlock_message(run) -> str:
    """The RuntimeError ``run`` raises; raises if it does not."""
    try:
        run()
    except RuntimeError as e:
        return str(e)
    raise AssertionError("sim: the starved graph did not deadlock")


def starved_graph():
    """tests/test_sim_backends.py's deadlock: ``b`` dries up after one
    token, so ``mix`` starves on its port 1 with one token of ``a`` left."""
    from repro_torch.core.dfg import DFG, INPUT, OUTPUT, PE
    g = DFG("starve")
    a, b = g.add(INPUT, name="a"), g.add(INPUT, name="b")
    pe = g.add(PE, name="mix", op="add")
    g.connect(a, pe, port=0)
    g.connect(b, pe, port=1)
    o = g.add(OUTPUT, name="o")
    g.connect(pe, o)
    return g.validate()


def chain_graph(k: int, ops=("add",), rom: bool = False):
    """INPUT i -> k PEs, PE j = ops[j % len(ops)](PE j-1, i) (abs takes PE
    j-1 alone), then a ROM of CHAIN_ROM if ``rom`` -> OUTPUT o."""
    from repro_torch.core.dfg import DFG, INPUT, MEM, OUTPUT, PE
    g = DFG(f"chain{k}{'_mix' if len(ops) > 1 else ''}")
    i = g.add(INPUT, name="i")
    prev = i
    for j in range(k):
        n = g.add(PE, name=f"n{j}", op=ops[j % len(ops)])
        g.connect(prev, n, port=0)
        if ops[j % len(ops)] != "abs":
            g.connect(i, n, port=1)
        prev = n
    if rom:
        n = g.add(MEM, name="lut", op="rom", latency=1,
                  meta={"table": CHAIN_ROM})
        g.connect(prev, n)
        prev = n
    g.connect(prev, g.add(OUTPUT, name="o"))
    return g.validate()


def wide_graph(width: int, sparse: bool = False, seed: int = 0):
    """Three inputs, ``width`` random two-input PEs over them, then half as
    many over those, each of the last to an output (seeded)."""
    from repro_torch.core.dfg import DFG
    rng = np.random.default_rng(seed)
    ops = ["add", "sub", "mul", "and", "or", "xor", "min", "max"]
    g = DFG("wide")
    layers = [[g.add("input", name=f"in{i}") for i in range(3)]]
    for n in (width, width // 2):
        layer = []
        for _ in range(n):
            pe = g.add("pe", op=ops[int(rng.integers(len(ops)))])
            for port in (0, 1):
                g.connect(layers[-1][int(rng.integers(len(layers[-1])))], pe,
                          port=port)
            layer.append(pe)
        layers.append(layer)
    for i, pe in enumerate(layers[-1]):
        g.connect(pe, g.add("output", name=f"out{i}"))
    g.sparse = sparse
    return g.validate()


def smi_clocks() -> tuple:
    """(clocks.sm, clocks.max.sm) in MHz, as nvidia-smi reads them now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    sm, mx = out.stdout.strip().splitlines()[0].split(",")
    return float(sm), float(mx)


def launcher_ms(launch, reps: int) -> float:
    """Device ms per kernel over ``reps`` back-to-back launches of a
    pre-packed program (no host work between them), after one warm-up."""
    launch()
    return event_ms(launch, reps)


def trace_sim_child() -> None:
    """One traced harris run through ``simulate(backend="torch")``, warm:
    the device kernels, busy time and idle share (run by ``phase_sim`` in a
    process of its own)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import DENSE_APPS, simulate
    g = DENSE_APPS["harris"].build(1)
    ins = sim_inputs(g, SIM_HARRIS_CYCLES, np.random.default_rng(SIM_SEED))
    if not device_profile(
            "sim", f"harris x {SIM_HARRIS_CYCLES} cycles through "
            f"simulate(backend='torch')",
            lambda: simulate(g, ins, SIM_HARRIS_CYCLES, backend="torch"),
            reps=1, watch="sim_dense"):
        raise RuntimeError("sim: the traced harris run recorded no device "
                           "kernel")


def phase_chains(dev) -> None:
    """The chain programs through sim_dense at SIM_CHAIN_CYCLES: each run
    held to the interpreter, numpy and the plain version on the card;
    device ms of each; the fit of ns a stage and fixed ns a cycle, beside
    nvidia-smi's clocks.sm."""
    from repro_torch.core import simulate
    from repro_torch.core.sim_vec import _input_matrix, lower_dense
    from repro_torch.kernels.sim import sim_dense_plain, stage_plan
    from repro_torch.kernels.sim.sim import dense_launcher, pack_dense

    cycles, rng = SIM_CHAIN_CYCLES, np.random.default_rng(SIM_SEED)
    chains = (("add x1", chain_graph(1)), ("add x33", chain_graph(33)),
              ("mixed x32 + rom", chain_graph(32, CHAIN_MIX, rom=True)))
    ms, rounds, clocks = {}, {}, []
    for label, g in chains:
        ins = sim_inputs(g, cycles, rng)
        prog = lower_dense(g)
        in_t = torch.from_numpy(_input_matrix(prog, ins, cycles)).to(dev)
        want = simulate(g, ins, cycles)
        np_out = simulate(g, ins, cycles, backend="numpy")
        plain = sim_dense_plain(prog, in_t, cycles)
        plain_out = {o: plain[i].tolist()
                     for i, o in enumerate(prog.output_names)}
        if not want == np_out == plain_out:
            raise RuntimeError(f"sim chain {label}: plain version, numpy "
                               f"and interpreter differ")
        h = pack_dense(prog, cycles)[0]
        rounds[label] = h["n_light"] + h["n_heavy"]
        out, launch = dense_launcher(prog, in_t, cycles)
        ms[label] = launcher_ms(launch, 5)
        clocks.append(smi_clocks()[0])
        if not torch.equal(out, plain):
            raise RuntimeError(f"sim chain {label}: the kernel differs from "
                               f"the plain version")
        log("sim", f"chain {label} ({len(stage_plan(prog))} stages; "
            f"{h['n_light']} light + {h['n_heavy']} heavy rounds a cycle) x "
            f"{cycles} cycles: kernel == plain == numpy == interpreter; "
            f"kernel {ms[label]:.4f} ms")
    one, many, mixed = (label for label, _ in chains)
    sm_mhz = sum(clocks) / len(clocks)
    per_ns = 1e6 * (ms[many] - ms[one]) / cycles / (rounds[many]
                                                    - rounds[one])
    fixed_ns = 1e6 * ms[one] / cycles - rounds[one] * per_ns
    mixed_ns = 1e6 * (ms[mixed] - ms[one]) / cycles / (rounds[mixed]
                                                       - rounds[one])
    log("sim", f"chain fit: {per_ns:.2f} ns a stage "
        f"({per_ns * sm_mhz / 1e3:.0f} SM clocks at clocks.sm "
        f"{sm_mhz:.0f} MHz, the mean of nvidia-smi's readings after "
        f"each timing: {', '.join(f'{c:.0f}' for c in clocks)}), fixed "
        f"{fixed_ns:.2f} ns a cycle; the mixed chain {mixed_ns:.2f} ns "
        f"a round")


def host_split(g, ins, cycles: int, dev) -> None:
    """One warm simulate(backend="torch") at harris, piece by piece on the
    host clock (best of SIM_WARM, each piece ending in a synchronize),
    beside a whole warm call."""
    from repro_torch.core import simulate
    from repro_torch.core.sim_vec import _input_matrix, lower_dense
    from repro_torch.kernels.sim.sim import dense_launcher, pack_dense

    best: dict = {}

    def clock(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best[name] = min(best.get(name, float("inf")),
                         1e3 * (time.perf_counter() - t0))
        return out

    for _ in range(SIM_WARM):
        prog = clock("lowering", lambda: lower_dense(g))
        in_mat = clock("input matrix",
                       lambda: _input_matrix(prog, ins, cycles))
        clock("packing", lambda: pack_dense(prog, cycles))
        in_t = clock("input upload", lambda: torch.from_numpy(in_mat).to(dev))
        out, launch = clock("packing + program upload",
                            lambda: dense_launcher(prog, in_t, cycles))
        clock("kernel (launch to synchronize)", launch)
        host = clock("download", lambda: out.cpu().numpy())
        clock("tolist", lambda: {n: host[i].tolist()
                                 for i, n in enumerate(prog.output_names)})
        clock("whole simulate", lambda: simulate(g, ins, cycles,
                                                 backend="torch"))
    parts = [k for k in best if k not in ("packing", "whole simulate")]
    log("sim", f"host split of a warm simulate(backend='torch'), harris x "
        f"{cycles}, ms (best of {SIM_WARM}): " + ", ".join(
            f"{k} {v:.3f}" for k, v in best.items())
        + f"; the parts but packing alone sum to "
        f"{sum(best[k] for k in parts):.3f}")


def check_global_route(dev, runs: dict, max_mhz: float, err: dict) -> dict:
    """The main path's global-route runs held bit for bit to numpy, the
    interpreter and the plain versions on the card, and timed (back-to-back
    launches of the packed program) beside their bounds and the shared
    route's latency floor. Returns the two rows' timing fields; fills
    ``err``'s "dense_global" and "sparse_global"."""
    from repro_torch.core import simulate, simulate_sparse
    from repro_torch.core.sim_vec import (_feed_matrix, _input_matrix,
                                          lower_dense, lower_sparse)
    from repro_torch.kernels.sim import (dense_plan, sim_dense_plain,
                                         sim_sparse_plain, sparse_plan)
    from repro_torch.kernels.sim.sim import (_smem_limit, dense_launcher,
                                             pack_sparse, sparse_launcher)

    limit, out = _smem_limit(dev), {}
    err["dense_global"] = 0
    for label in [k for k in runs if k != "sparse"]:
        g, ins, cycles, got, first = runs[label]
        t_int, want = best_s(lambda: simulate(g, ins, cycles), 1)
        t_np, np_out = best_s(lambda: simulate(g, ins, cycles,
                                               backend="numpy"), 1)
        prog = lower_dense(g)
        h = dense_plan(prog, cycles, limit)[0]
        in_t = torch.from_numpy(_input_matrix(prog, ins, cycles)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = sim_dense_plain(prog, in_t, cycles)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain_out = {o: plain[i].tolist()
                     for i, o in enumerate(prog.output_names)}
        err["dense_global"] = max(err["dense_global"],
                                  stream_err(got, plain_out))
        if not h["global_route"] or 4 * h["s_words"] <= limit:
            raise RuntimeError(f"sim {label}: not a global-route program")
        if not (got == want == np_out == plain_out):
            raise RuntimeError(f"sim {label}: kernel, plain version, numpy "
                               f"and interpreter streams differ")
        k_out, launch = dense_launcher(prog, in_t, cycles)
        ms = launcher_ms(launch, 5)
        if not torch.equal(k_out, plain):
            raise RuntimeError(f"sim {label}: the launcher's run differs")
        n_rd = h["n_light"] + h["n_heavy"]
        bound_ms, bound_by = sim_bound(
            dense_function_bytes(prog, cycles),
            cycles * (prog.n_nodes - len(prog.input_pos)
                      - len(prog.const_pos)))
        floor_ms = 1e3 * cycles * n_rd * STEP_CLOCKS / (1e6 * max_mhz)
        log("sim", f"global route, dense {label} ({prog.n_nodes} nodes, "
            f"{4 * h['s_words']} bytes of program and state, "
            f"{4 * h['s_words'] / limit:.2f}x a block's {limit}) x {cycles} "
            f"cycles: kernel == plain == numpy == interpreter on "
            f"{len(got)} output streams; s interpreter {t_int:.3f}, numpy "
            f"{t_np:.3f}, torch {first:.3f} (one call, packing included), "
            f"plain on the card {plain_s:.3f}; kernel {ms:.4f} ms a call on "
            f"the device ({1e6 * ms / cycles:.1f} ns a cycle, {n_rd} rounds "
            f"a cycle, {1e6 * ms / cycles / n_rd:.1f} ns a round), bound "
            f"{bound_ms:.3g} ms ({bound_by}; roofline share "
            f"{bound_ms / ms:.2g}); the shared route's latency floor "
            f"{floor_ms:.4f} ms ({STEP_CLOCKS} SM clocks a round at "
            f"{max_mhz:.0f} MHz, an assumption; share {floor_ms / ms:.3f})")
        if label == f"wide x{SIM_GLOBAL_WIDTHS[0]}":
            out["sim_dense_global"] = {
                "ms": ms, "plain_ms": 1e3 * plain_s, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    g, ins, mc, got, first = runs["sparse"]
    t_int, want = best_s(lambda: simulate_sparse(g, ins, mc), 1)
    t_np, np_out = best_s(lambda: simulate_sparse(g, ins, mc,
                                                  backend="numpy"), 1)
    prog = lower_sparse(g)
    feed, frem = _feed_matrix(prog, ins)
    h = sparse_plan(prog, feed.shape, mc, limit)[0]
    shared_words = pack_sparse(prog, feed.shape, mc)[0]["s_words"]
    feed_t, frem_t = (torch.from_numpy(x).to(dev) for x in (feed, frem))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = sim_sparse_plain(prog, feed_t, frem_t, mc)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_out = {o: plain[2][i, :int(plain[3][i])].tolist()
                 for i, o in enumerate(prog.output_names)}
    err["sparse_global"] = stream_err(got, plain_out)
    k_res, launch = sparse_launcher(prog, feed_t, frem_t, mc)
    ms = launcher_ms(launch, 5)
    same = all(torch.equal(a, b) for i, (a, b) in enumerate(
        zip(k_res, plain)) if i != 2)
    for o in range(len(prog.output_names)):
        k = int(plain[3][o])
        same = same and torch.equal(k_res.outm[o, :k], plain[2][o, :k])
    if not h["global_route"] or 4 * shared_words <= limit:
        raise RuntimeError("sim wide sparse: not a global-route program")
    if not (same and got == want == np_out == plain_out):
        raise RuntimeError("sim wide sparse: kernel, plain version, numpy "
                           "and interpreter differ")
    rounds = int(plain.rounds)
    nbytes = 8 * (int(frem.sum()) + int(plain.ocnt.sum())) \
        + sparse_program_bytes(prog)
    items = (len(prog.ev_names) + len(prog.output_names)
             + len(prog.input_names) + prog.n_buf)
    bound_ms, bound_by = sim_bound(nbytes, rounds * items)
    floor_ms = 1e3 * rounds * SPARSE_ROUND_STEPS * STEP_CLOCKS / (
        1e6 * max_mhz)
    log("sim", f"global route, sparse wide x{SIM_GLOBAL_SPARSE_WIDTH} "
        f"({prog.n_buf} buffers, {len(prog.ev_names)} nodes, fan-out "
        f"{h['fan']}, {h['n_rounds']} item rounds a round; "
        f"{4 * shared_words} bytes of program and state in the shared "
        f"route's layout, {4 * shared_words / limit:.2f}x a block's; "
        f"{4 * h['s_words']} in the global route's wide layout) x "
        f"{SIM_TOKENS} tokens: "
        f"kernel == plain (end state and streams) == numpy == interpreter; "
        f"{rounds} rounds; s interpreter {t_int:.3f}, numpy {t_np:.3f}, "
        f"torch {first:.3f}, plain on the card {plain_s:.3f}; kernel "
        f"{ms:.4f} ms a call on the device ({1e3 * ms / rounds:.3f} us a "
        f"round), bound {bound_ms:.3g} ms ({bound_by}; roofline share "
        f"{bound_ms / ms:.2g}); the shared route's latency floor "
        f"{floor_ms:.4f} ms (share {floor_ms / ms:.3f})")
    out["sim_sparse_global"] = {
        "ms": ms, "plain_ms": 1e3 * plain_s, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}
    return out


def phase_sim(dev, card: str, table1: dict):
    """The vectorized simulator: interpreter, numpy, the kernels through
    ``simulate(backend="torch")`` and their plain versions on the card,
    bit for bit. Returns the kernels' entries of the results line."""
    from repro_torch.core import (CONTROL_APPS, DENSE_APPS, SPARSE_APPS,
                                  clear_ref_memo, equivalent, simulate,
                                  simulate_sparse)
    from repro_torch.core.sim_vec import (_feed_matrix, _input_matrix,
                                          lower_dense, lower_sparse)
    from repro_torch.kernels.sim import (sim_dense, sim_dense_plain,
                                         sim_sparse, sim_sparse_plain,
                                         stage_plan)
    from repro_torch.kernels.sim.sim import (dense_launcher, pack_dense,
                                             sparse_launcher)

    t_phase = time.perf_counter()
    dense = [(n, s, SIM_HARRIS_CYCLES if n == "harris" else SIM_CYCLES)
             for n, s in list(DENSE_APPS.items()) + list(CONTROL_APPS.items())]
    sparse_rng = np.random.default_rng(SIM_SEED)
    sparse = [(n, s, sim_inputs(s.build(1), SIM_TOKENS, sparse_rng))
              for n, s in SPARSE_APPS.items()]
    starve = starved_graph()
    wide = [(f"wide x{w}", wide_graph(w), SIM_GLOBAL_CYCLES)
            for w in SIM_GLOBAL_WIDTHS]
    wide_sparse = wide_graph(SIM_GLOBAL_SPARSE_WIDTH, sparse=True)
    wide_sparse_in = sim_inputs(wide_sparse, SIM_TOKENS,
                                np.random.default_rng(SIM_SEED))

    # the main path: the entry points with backend="torch", counts from 0
    for fn in (sim_dense, sim_sparse):
        fn.launches = fn.shared_launches = fn.global_launches = 0
    runs = {}
    for name, spec, cycles in dense:
        g = spec.build(1)
        ins = sim_inputs(g, cycles, np.random.default_rng(SIM_SEED))
        first, got = best_s(lambda: simulate(g, ins, cycles, backend="torch"),
                            1)
        warm, again = best_s(lambda: simulate(g, ins, cycles,
                                              backend="torch"), SIM_WARM)
        if again != got:
            raise RuntimeError(f"sim {name}: the kernel differs run to run")
        runs[name] = (g, ins, cycles, got, first, warm)
    for name, spec, ins in sparse:
        g, mc = spec.build(1), SIM_TOKENS * 40
        first, got = best_s(lambda: simulate_sparse(g, ins, mc,
                                                    backend="torch"), 1)
        warm, again = best_s(lambda: simulate_sparse(g, ins, mc,
                                                     backend="torch"),
                             SIM_WARM)
        if again != got:
            raise RuntimeError(f"sim {name}: the kernel differs run to run")
        runs[name] = (g, ins, mc, got, first, warm)
    verify_in = {}
    for (app, flow), r in table1.items():
        ref, final = DENSE_APPS[app].build(1), r.design.netlist.to_dfg()
        rng = np.random.default_rng(0)             # the verify pass's inputs
        ins = {n: rng.integers(0, 255, size=48).tolist()
               for n, nd in ref.nodes.items() if nd.kind == "input"}
        clear_ref_memo()
        ok = equivalent(ref, final, ins, n=32, backend="torch")
        streams = simulate(final, ins, SIM_NETLIST_CYCLES, backend="torch")
        verify_in[(app, flow)] = (ref, final, ins, ok, streams)
    starve_in = {"a": [1, 2, 3], "b": [5]}
    diag = {"torch": deadlock_message(lambda: simulate_sparse(
        starve, starve_in, 64, backend="torch"))}
    global_runs = {}
    for label, g, cycles in wide:
        ins = sim_inputs(g, cycles, np.random.default_rng(SIM_SEED))
        secs, got = best_s(lambda: simulate(g, ins, cycles, backend="torch"),
                           1)
        global_runs[label] = (g, ins, cycles, got, secs)
    secs, got = best_s(lambda: simulate_sparse(
        wide_sparse, wide_sparse_in, SIM_TOKENS * 40, backend="torch"), 1)
    global_runs["sparse"] = (wide_sparse, wide_sparse_in, SIM_TOKENS * 40,
                             got, secs)
    torch.cuda.synchronize()
    launches = {"dense": sim_dense.launches, "sparse": sim_sparse.launches}
    routes = {k: (fn.shared_launches, fn.global_launches)
              for k, fn in (("dense", sim_dense), ("sparse", sim_sparse))}
    shared = {"dense": len(dense) * (1 + SIM_WARM) + 3 * len(table1),
              "sparse": len(sparse) * (1 + SIM_WARM) + 1}
    want_routes = {"dense": (shared["dense"], len(wide)),
                   "sparse": (shared["sparse"], 1)}
    if routes != want_routes or any(launches[k] != sum(routes[k])
                                    for k in launches):
        raise RuntimeError(f"sim launches {launches}, by route (shared, "
                           f"global) {routes}, want {want_routes}")
    log("sim", f"main path: sim_dense {launches['dense']} launches "
        f"({routes['dense'][0]} on the shared route, {routes['dense'][1]} "
        f"on the global route), sim_sparse {launches['sparse']} "
        f"({routes['sparse'][0]} shared, {routes['sparse'][1]} global); one "
        f"a simulate call")
    max_mhz = smi_clocks()[1]
    phase_chains(dev)

    # the same runs on the interpreter, numpy and the plain versions
    ratio, results, err = None, {}, {"dense": 0, "sparse": 0}
    for name, spec, cycles in dense:
        g, ins, _, got, first, warm = runs[name]
        t_int, want_ = best_s(lambda: simulate(g, ins, cycles), 1)
        t_np, np_out = best_s(lambda: simulate(g, ins, cycles,
                                               backend="numpy"), 1)
        prog = lower_dense(g)
        in_t = torch.from_numpy(_input_matrix(prog, ins, cycles)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = sim_dense_plain(prog, in_t, cycles)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain_out = {o: plain[i].tolist()
                     for i, o in enumerate(prog.output_names)}
        err["dense"] = max(err["dense"], stream_err(got, plain_out))
        if not (got == want_ == np_out == plain_out):
            raise RuntimeError(f"sim {name}: kernel, plain version, numpy "
                               f"and interpreter streams differ")
        n_st = len(stage_plan(prog))
        log("sim", f"dense {name} ({prog.n_nodes} nodes, {n_st} stages) x "
            f"{cycles} cycles: kernel == plain == numpy == interpreter on "
            f"{len(got)} output stream(s); s interpreter {t_int:.4f}, numpy "
            f"{t_np:.4f}, torch {first:.4f} first / {warm:.4f} warm "
            f"({1e6 * warm / cycles:.2f} us a cycle), plain on the card "
            f"{plain_s:.3f}")
        if name == "harris":
            ratio = t_int / warm
            k_out, launch = dense_launcher(prog, in_t, cycles)
            ms = launcher_ms(launch, 5)
            if not torch.equal(k_out, plain):
                raise RuntimeError("sim harris: the launcher's run differs")
            nbytes = dense_function_bytes(prog, cycles)
            ops = cycles * (prog.n_nodes - len(prog.input_pos)
                            - len(prog.const_pos))
            bound_ms, bound_by = sim_bound(nbytes, ops)
            floor_ms = 1e3 * cycles * (n_st + 1) * STEP_CLOCKS / (
                1e6 * max_mhz)
            hd = pack_dense(prog, cycles)[0]
            n_rd = hd["n_light"] + hd["n_heavy"]
            results["sim_dense"] = {
                "ms": ms, "plain_ms": 1e3 * plain_s, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
            log("sim", f"harris x {cycles} cycles: warm torch is "
                f"{ratio:.2f}x the interpreter (the reference's contract for "
                f"its warm device backend: >= 10x); kernel {ms:.4f} ms a "
                f"call on the device ({1e6 * ms / cycles:.1f} ns a "
                f"cycle; {n_st} stages, {hd['n_light']} light + "
                f"{hd['n_heavy']} heavy rounds a cycle, "
                f"{1e6 * ms / cycles / n_rd:.1f} ns a round), bound "
                f"{bound_ms:.3g} ms ({bound_by}; latency-bound: roofline "
                f"share {bound_ms / ms:.2g}); latency floor {floor_ms:.4f} "
                f"ms (an assumption, not a measurement: {STEP_CLOCKS} SM "
                f"clocks a dependent shared-memory step at clocks.max.sm "
                f"{max_mhz:.0f} MHz, (stages + 1) steps a cycle; share {floor_ms / ms:.3f})")
            host_split(g, ins, cycles, dev)
            # in this process, after the earlier phases' traces, the
            # profiler recorded no device activity for this run; a fresh
            # process records it
            sys.stdout.flush()
            subprocess.run([sys.executable, "-c",
                            "import chip_smoke; chip_smoke.trace_sim_child()"],
                           cwd=ROOT, check=True, timeout=300)
    for name, spec, _ in sparse:
        g, ins, mc, got, first, warm = runs[name]
        t_int, want_ = best_s(lambda: simulate_sparse(g, ins, mc), 1)
        t_np, np_out = best_s(lambda: simulate_sparse(g, ins, mc,
                                                      backend="numpy"), 1)
        prog = lower_sparse(g)
        feed, frem = _feed_matrix(prog, ins)
        feed_t, frem_t = (torch.from_numpy(x).to(dev) for x in (feed, frem))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = sim_sparse_plain(prog, feed_t, frem_t, mc)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        kern = sim_sparse(prog, feed_t, frem_t, mc)
        same = all(torch.equal(a, b) for i, (a, b) in enumerate(
            zip(kern, plain)) if i != 2)
        for o in range(len(prog.output_names)):
            k = int(plain[3][o])
            same = same and torch.equal(kern.outm[o, :k], plain[2][o, :k])
        plain_out = {o: plain[2][i, :int(plain[3][i])].tolist()
                     for i, o in enumerate(prog.output_names)}
        err["sparse"] = max(err["sparse"], stream_err(got, plain_out))
        if not (same and got == want_ == np_out == plain_out):
            raise RuntimeError(f"sim {name}: kernel, plain version, numpy "
                               f"and interpreter differ")
        rounds = int(plain.rounds)
        log("sim", f"sparse {name} ({prog.n_buf} buffers, "
            f"{len(prog.ev_names)} nodes) x {SIM_TOKENS} tokens: kernel == "
            f"plain (end state and streams) == numpy == interpreter; "
            f"{rounds} rounds; s interpreter {t_int:.4f}, numpy {t_np:.4f}, "
            f"torch {first:.4f} first / {warm:.4f} warm, plain on the card "
            f"{plain_s:.3f}")
        if name == "mttkrp":
            k_res, launch = sparse_launcher(prog, feed_t, frem_t, mc)
            ms = launcher_ms(launch, 5)
            if int(k_res.rounds) != rounds:
                raise RuntimeError("sim mttkrp: the launcher's run differs")
            n_out_tok = int(plain.ocnt.sum())
            nbytes = 8 * (int(frem.sum()) + n_out_tok) \
                + sparse_program_bytes(prog)
            items = (len(prog.ev_names) + len(prog.output_names)
                     + len(prog.input_names) + prog.n_buf)
            bound_ms, bound_by = sim_bound(nbytes, rounds * items)
            floor_ms = 1e3 * rounds * SPARSE_ROUND_STEPS * STEP_CLOCKS / (
                1e6 * max_mhz)
            results["sim_sparse"] = {
                "ms": ms, "plain_ms": 1e3 * plain_s, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
            log("sim", f"sparse mttkrp: kernel {ms:.4f} ms a call on the "
                f"device ({1e3 * ms / rounds:.3f} us a round), bound "
                f"{bound_ms:.3g} ms ({bound_by}; latency-bound: roofline "
                f"share {bound_ms / ms:.2g}); latency floor {floor_ms:.4f} "
                f"ms (an assumption, not a measurement: "
                f"{SPARSE_ROUND_STEPS} dependent steps a round of "
                f"{STEP_CLOCKS} SM clocks at {max_mhz:.0f} MHz; share "
                f"{floor_ms / ms:.3f})")

    t0 = time.perf_counter()
    for (app, flow), (ref, final, ins, ok, streams) in verify_in.items():
        oks = {"torch": ok}
        for backend in ("interpreter", "numpy"):
            clear_ref_memo()
            oks[backend] = equivalent(ref, final, ins, n=32, backend=backend)
        want_ = simulate(final, ins, SIM_NETLIST_CYCLES)
        prog = lower_dense(final)
        in_t = torch.from_numpy(_input_matrix(prog, ins,
                                              SIM_NETLIST_CYCLES)).to(dev)
        plain = sim_dense_plain(prog, in_t, SIM_NETLIST_CYCLES)
        plain_out = {o: plain[i].tolist()
                     for i, o in enumerate(prog.output_names)}
        np_out = simulate(final, ins, SIM_NETLIST_CYCLES, backend="numpy")
        if not all(oks.values()) or not (streams == want_ == np_out
                                         == plain_out):
            raise RuntimeError(f"sim Table I {app} {flow}: equivalent "
                               f"{oks}, or the streams differ")
        log("sim", f"Table I {app} {flow}: routed netlist {prog.n_nodes} "
            f"nodes, {len(stage_plan(prog))} stages; equivalent(n=32) True "
            f"on interpreter, numpy, torch; {SIM_NETLIST_CYCLES}-cycle "
            f"streams kernel == plain == numpy == interpreter")
    log("sim", f"Table I: {len(verify_in)} verify checks on 3 backends in "
        f"{time.perf_counter() - t0:.2f} s")

    results.update(check_global_route(dev, global_runs, max_mhz, err))

    for backend, device in (("interpreter", None), ("numpy", None),
                            ("torch", "cpu")):
        diag[backend + (f" on {device}" if device else "")] = \
            deadlock_message(lambda: simulate_sparse(
                starve, starve_in, 64, backend=backend, device=device))
    if len(set(diag.values())) != 1 or "p1<-b" not in diag["torch"]:
        raise RuntimeError(f"sim deadlock diagnostics differ: {diag}")
    log("sim", f"deadlock diagnostic identical on {', '.join(diag)}: "
        f"{diag['torch']!r}")
    log("sim", f"phase took {time.perf_counter() - t_phase:.1f} s on {card}")
    if ratio is None or ratio <= 1:
        raise RuntimeError(f"sim: the kernel does not beat the interpreter "
                           f"on harris x {SIM_HARRIS_CYCLES} ({ratio})")
    src = "src/repro_torch/kernels/sim/csrc/"
    return [
        {"name": "sim_dense", "route": "cuda", "source": src + "sim_dense.cu",
         "replaces": "src/repro/core/sim_vec.py:440",
         "launches": launches["dense"], "max_abs_err": err["dense"],
         **results["sim_dense"]},
        {"name": "sim_sparse", "route": "cuda",
         "source": src + "sim_sparse.cu",
         "replaces": "src/repro/core/sim_vec.py:877",
         "launches": launches["sparse"], "max_abs_err": err["sparse"],
         **results["sim_sparse"]},
        {"name": "sim_dense_global", "route": "cuda",
         "source": src + "sim_dense.cu",
         "replaces": "src/repro/core/sim_vec.py:440",
         "launches": routes["dense"][1], "max_abs_err": err["dense_global"],
         **results["sim_dense_global"]},
        {"name": "sim_sparse_global", "route": "cuda",
         "source": src + "sim_sparse.cu",
         "replaces": "src/repro/core/sim_vec.py:877",
         "launches": routes["sparse"][1], "max_abs_err": err["sparse_global"],
         **results["sim_sparse_global"]}]


def result_bytes(r) -> tuple:
    """A compile result as phases 7d and 7e compare it: the summary, the
    design digest (placement, routes, registers), the critical path and
    the passes that ran."""
    from repro_torch.core.netlist import design_digest
    return (json.dumps(r.summary()), design_digest(r.design),
            r.sta.critical_path_ns, r.pass_stats["pipeline"])


def capped_bytes(r) -> tuple:
    """A power-capped result: its summary, the controller's outcome and
    its trajectory."""
    pc = r.power_cap
    return (json.dumps(r.summary()), json.dumps(pc.summary()),
            [(p.critical_path_ns, p.freq_mhz, p.power_mw, p.edp_js,
              p.registers_added) for p in pc.trajectory])


def point_metrics(p) -> tuple:
    return (p.critical_path_ns, p.freq_mhz, p.power_mw, p.edp_js,
            p.registers_added)


def cuda_worker_ready(hold_s: float) -> tuple:
    """A process worker's first CUDA tensor: (its pid, the wall clock when
    the tensor is ready), then ``hold_s`` seconds of waiting, so that each
    of a pool's tasks lands on a worker of its own; phase 7d's reading of
    the workers' start time."""
    import repro_torch.core  # noqa: F401  (what a batch worker imports)
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    ready = time.time()
    time.sleep(hold_s)
    return os.getpid(), ready


def phase_batch(dev, card: str, table1: dict, dev_runs: dict) -> None:
    """The compile driver: compile_batch of Table I on the host backends
    (process workers; cold, warm in memory, warm from disk) and on the
    torch engines (spawned workers on the card); the frontier on the torch
    STA (thread and process fan-out); the power-capped schedule; the
    device rule of the keys."""
    import shutil
    from concurrent.futures import ProcessPoolExecutor
    from dataclasses import replace

    from repro_torch.core import (ALL_APPS, DENSE_APPS, CascadeCompiler,
                                  CompileCache, DiskCache, ExploreSpec,
                                  PassConfig, compile_key)
    from repro_torch.core.compiler import _process_context

    t_phase = time.perf_counter()
    keys = list(table1)
    jobs = [(DENSE_APPS[a], getattr(PassConfig, f)(place_moves=TABLE1_MOVES))
            for a, f in keys]
    want = [result_bytes(table1[k]) for k in keys]
    shutil.rmtree(BATCH_CACHE, ignore_errors=True)

    def disk_compiler():
        return CascadeCompiler(
            cache=CompileCache(disk=DiskCache(root=BATCH_CACHE / "results")),
            stage_cache=CompileCache(
                disk=DiskCache(root=BATCH_CACHE / "stages")))

    first = disk_compiler()
    for label, c, hits in (("cold", first, 0),
                           ("warm from the memory cache", first, len(jobs)),
                           ("warm from the disk cache, a fresh compiler",
                            disk_compiler(), len(jobs))):
        t0 = time.perf_counter()
        out = c.compile_batch(jobs, verify=True, backend="process")
        secs = time.perf_counter() - t0
        lb = c.last_batch
        if [result_bytes(r) for r in out] != want:
            raise RuntimeError(f"batch {label}: results differ from phase "
                               f"7's serial compiles")
        if lb["cache_hits"] != hits or (hits == 0 and (
                lb["compiled"] != len(jobs) or lb["start_method"] != "spawn")):
            raise RuntimeError(f"batch {label}: {lb}")
        log("batch", f"Table I host backends, process backend, {label}: "
            f"{secs:.3f} s; {len(out)} results == phase 7's serial compiles "
            f"(summary, design digest, critical path, passes); workers "
            f"{lb['workers']}, start method {lb['start_method']}; "
            f"last_batch {json.dumps(lb)}; on {card}")
    disk = c.cache.disk.stats()
    if disk["hits"] != len(jobs):
        raise RuntimeError(f"batch: disk tier {disk}")
    log("batch", f"disk tier of the fresh compiler: {disk['hits']} hits, "
        f"{disk['entries']} entries, {disk['size_bytes']} bytes under "
        f"{BATCH_CACHE.relative_to(ROOT)}")

    # the torch engines: process workers spawn (CUDA is initialised here)
    tjobs = [(DENSE_APPS[a], getattr(PassConfig, f)(
        place_moves=TABLE1_MOVES, pnr_backend="torch", sta_backend="torch"))
        for a, f in keys]
    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache(),
                        device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = c.compile_batch(tjobs, verify=True, backend="process")
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    lb = c.last_batch
    if [result_bytes(r) for r in out] != [result_bytes(dev_runs[k])
                                          for k in keys]:
        raise RuntimeError("batch: torch-engine process results differ from "
                           "the serial compiles on the card")
    if lb["start_method"] != "spawn" or lb["compiled"] != len(tjobs):
        raise RuntimeError(f"batch torch engines: {lb}")
    t0 = time.time()
    with ProcessPoolExecutor(max_workers=lb["workers"],
                             mp_context=_process_context(True)) as ex:
        ready = list(ex.map(cuda_worker_ready, [2.0] * lb["workers"]))
    starts = sorted(t - t0 for _, t in ready)
    log("batch", f"Table I on the torch engines (pnr_backend=sta_backend="
        f"'torch', verify=True), process backend: {secs:.3f} s; "
        f"{len(out)} results == phase 7b's serial compiles on the card, "
        f"byte for byte (summary, design digest, critical path, passes); "
        f"workers {lb['workers']}, start method {lb['start_method']}; "
        f"parent's device memory {before} bytes before, peak {peak} bytes "
        f"during the batch; workers' start: a pool of {lb['workers']} "
        f"spawned workers ({len({pid for pid, _ in ready})} distinct pids) "
        f"has its first CUDA tensor {starts[0]:.2f} s (first worker) to "
        f"{starts[-1]:.2f} s (last) after the pool is made; on {card}")

    # the frontier: the reference benchmark's grid, torch STA on the card
    app = ALL_APPS[FRONTIER_APP]
    fc = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache(),
                         device=dev)
    base = fc.compile(app, PassConfig.full(place_moves=FRONTIER_MOVES,
                                           sta_backend="torch"),
                      use_cache=False)
    caps = tuple(None if f is None else base.power.power_mw * f
                 for f in FRONTIER_CAP_FRACTIONS)
    spec = ExploreSpec(register_budgets=FRONTIER_BUDGETS, power_caps_mw=caps)

    def frontier_cfg(sta, sp=spec):
        return PassConfig.frontier(sp, place_moves=FRONTIER_MOVES,
                                   sta_backend=sta)

    fronts = {}
    for backend in ("thread", "process"):
        c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache(),
                            device=dev)
        t0 = time.perf_counter()
        (r,) = c.compile_batch([(app, frontier_cfg("torch"))],
                               backend=backend)
        fronts[backend] = (r, time.perf_counter() - t0, c)
        if c.last_batch["explore_points"] != len(spec.points()):
            raise RuntimeError(f"batch frontier {backend}: {c.last_batch}")
    t0 = time.perf_counter()
    np_r = CascadeCompiler(cache=CompileCache(),
                           stage_cache=CompileCache()).compile(
        app, frontier_cfg("numpy"))
    np_s = time.perf_counter() - t0
    rows = {k: [p.scaled() for p in v[0].frontier.all_points()]
            for k, v in fronts.items()}
    rows["numpy"] = [p.scaled() for p in np_r.frontier.all_points()]
    if not rows["thread"] == rows["process"] == rows["numpy"]:
        raise RuntimeError("batch frontier: thread, process and numpy-STA "
                           "frontiers differ")
    fr = fronts["thread"][0].frontier
    for b, cap in spec.points():
        cfg = (PassConfig.power_capped(cap, post_pnr_budget=b,
                                       place_moves=FRONTIER_MOVES,
                                       sta_backend="torch")
               if cap is not None else
               PassConfig.full(post_pnr_budget=b, place_moves=FRONTIER_MOVES,
                               sta_backend="torch"))
        ind = fc.compile(app, cfg)
        got = point_metrics(fr.point_for(b, cap))
        if got != (ind.sta.critical_path_ns, ind.sta.max_freq_mhz,
                   ind.power.power_mw, ind.power.edp_js,
                   ind.design.netlist.added_registers()):
            raise RuntimeError(f"batch frontier point ({b}, {cap}) differs "
                               f"from an independent compile")
    warm_c = fronts["thread"][2]
    t0 = time.perf_counter()
    warm = warm_c.compile(app, frontier_cfg(
        "torch", replace(spec, select="max_freq")))
    warm_s = time.perf_counter() - t0
    if warm.pass_stats.get("stage_resume") != "routed":
        raise RuntimeError("batch frontier: the max_freq re-run did not "
                           "resume from the routed artifact")
    sel = fr.selected
    log("batch", f"frontier {FRONTIER_APP} ({FRONTIER_MOVES} moves, "
        f"budgets {FRONTIER_BUDGETS} x caps {[None if c is None else round(c, 3) for c in caps]} mW; "
        f"sta_backend='torch' on the card): {len(fr.all_points())} points, "
        f"{len(fr.points)} non-dominated, each == an independent compile; "
        f"thread fan-out {fronts['thread'][1]:.3f} s, process fan-out "
        f"{fronts['process'][1]:.3f} s (start method "
        f"{_process_context(True).get_start_method()}), numpy-STA frontier "
        f"{np_s:.3f} s, all three equal; selected (min_edp) budget "
        f"{sel.register_budget}, cap {sel.power_cap_mw}: "
        f"{sel.freq_mhz:.1f} MHz, {sel.power_mw:.2f} mW; warm re-run with "
        f"select='max_freq' resumed from 'routed' in {warm_s:.3f} s "
        f"(selected {warm.frontier.selected.freq_mhz:.1f} MHz)")

    # the power-capped schedule on the torch STA against the numpy STA
    pcc = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache(),
                          device=dev)
    for name, spec_app in DENSE_APPS.items():
        unc = pcc.compile(spec_app, PassConfig.power_capped(
            None, place_moves=TABLE1_MOVES, sta_backend="torch"))
        parts = []
        for frac in POWER_CAP_FRACTIONS:
            cap = frac * unc.power.power_mw
            r_t, r_n = (pcc.compile(spec_app, PassConfig.power_capped(
                cap, place_moves=TABLE1_MOVES, sta_backend=sta))
                for sta in ("torch", "numpy"))
            pc = r_t.power_cap
            if capped_bytes(r_t) != capped_bytes(r_n):
                raise RuntimeError(f"batch power cap {name} x{frac}: torch "
                                   f"and numpy STA differ")
            if pc.feasible and r_t.power.power_mw > cap or (
                    not pc.feasible and pc.stop_reason != "cap_infeasible"):
                raise RuntimeError(f"batch power cap {name} x{frac}: "
                                   f"{pc.summary()}")
            parts.append(f"x{frac}: cap {cap:.2f} mW -> "
                         + (f"{r_t.power.power_mw:.2f} mW at "
                            f"{r_t.sta.max_freq_mhz:.1f} MHz, "
                            f"{pc.final.registers_added} registers, "
                            f"{pc.rounds_rolled_back} rolled back"
                            if pc.feasible else "infeasible (cap below the "
                            "un-pipelined design)"))
        log("batch", f"power cap {name}: uncapped {unc.power.power_mw:.2f} "
            f"mW at {unc.sta.max_freq_mhz:.1f} MHz; " + "; ".join(parts)
            + "; torch STA == numpy STA (summary, outcome, trajectory)")

    # the keys: one torch-engine job on the CPU and on the card
    cache, stages = CompileCache(), CompileCache()
    cpu = CascadeCompiler(cache=cache, stage_cache=stages, device="cpu")
    on_card = CascadeCompiler(cache=cache, stage_cache=stages, device=dev)
    app, cfg = DENSE_APPS["gaussian"], PassConfig.full(
        place_moves=20, pnr_backend="torch", sta_backend="torch")
    k_cpu, k_card = (compile_key(app, cfg, c.fabric, c.timing, c.energy,
                                 device=c.device) for c in (cpu, on_card))
    stage_same = {st: cpu.stage_key_for(app, cfg, st)
                  == on_card.stage_key_for(app, cfg, st)
                  for st in ("mapped", "placed", "routed")}
    r_cpu = cpu.compile(app, cfg)
    r_card = on_card.compile(app, cfg)
    again = on_card.compile(app, cfg)
    if (k_cpu == k_card or stage_same != {"mapped": True, "placed": False,
                                          "routed": False}
            or r_card.cache_hit or not again.cache_hit or len(cache) != 2):
        raise RuntimeError(f"batch keys: compile keys equal "
                           f"{k_cpu == k_card}, stage keys equal "
                           f"{stage_same}, card hit {r_card.cache_hit}")
    log("batch", f"keys of one torch-engine job (gaussian, pnr_backend="
        f"sta_backend='torch'): compile key on the CPU {k_cpu[:12]}, on the "
        f"card {k_card[:12]}; stage keys equal across devices {stage_same}; "
        f"the CPU result was not served to the card (card compile "
        f"cache_hit={r_card.cache_hit}, then {again.cache_hit}; "
        f"{len(cache)} entries); critical path CPU "
        f"{r_cpu.sta.critical_path_ns:.3f} ns, card "
        f"{r_card.sta.critical_path_ns:.3f} ns")
    shutil.rmtree(BATCH_CACHE, ignore_errors=True)
    log("batch", f"phase took {time.perf_counter() - t_phase:.1f} s on "
        f"{card}")


def pack_bytes(m) -> tuple:
    """A pack as phase 7e compares it: regions, the fabric summary, the
    shared flush report and each resident's summary and design digest."""
    import dataclasses
    from repro_torch.core.netlist import design_digest
    return (sorted((n, (r.row0, r.col0, r.rows, r.cols))
                   for n, r in m.regions.items()),
            json.dumps(m.summary, sort_keys=True),
            json.dumps(dataclasses.asdict(m.flush), sort_keys=True),
            [(r.app.name, json.dumps(r.summary(), sort_keys=True),
              design_digest(r.design)) for r in m.results])


def engine_bars(c, app, cfg) -> tuple:
    """(torch placer cost, numpy placer cost under the same config, torch
    wirelength, A*'s wirelength on the torch placement) of one compile:
    tests/test_torch_pnr.py's bars on the torch engines, inside
    ``cfg.region`` where it has one."""
    from dataclasses import replace
    from repro_torch.core import route
    st = c.compile_to_stage(app, cfg, stage="routed").state
    host = c.compile_to_stage(app, replace(cfg, pnr_backend="numpy"),
                              stage="routed").state
    astar = route(st["netlist"], st["placement"], st["place_fabric"],
                  region=cfg.region)
    return (st["pass_stats"]["pnr"]["place"]["best_cost"],
            host["pass_stats"]["pnr"]["place"]["best_cost"],
            st["design"].total_wirelength(), astar.total_wirelength())


#: graphs ``resident_streams`` runs through the sim kernels: the source and
#: the design (equivalent / sparse_equivalent), then the design's streams
RESIDENT_GRAPHS = 3


def resident_streams(r) -> tuple:
    """(verdict through the sim kernels, the interpreter's verdict, whether
    the streams are equal) of one resident, with the verify pass's inputs
    (64 tokens a stream for a sparse app): equivalent / sparse_equivalent,
    then the design's own streams, on the "torch" backend and the
    interpreter."""
    from repro_torch.core import (clear_ref_memo, equivalent, simulate,
                                  simulate_sparse, sparse_equivalent)
    ref, final = r.app.build(1), r.design.netlist.to_dfg()
    rng = np.random.default_rng(0)
    size, hi = (SIM_TOKENS, 0x10000) if r.app.sparse else (48, 255)
    ins = {n: rng.integers(0, hi, size=size).tolist()
           for n, nd in ref.nodes.items() if nd.kind == "input"}
    out = {}
    for backend in ("torch", "interpreter"):
        clear_ref_memo()
        if r.app.sparse:
            out[backend] = (sparse_equivalent(ref, final, ins,
                                              backend=backend),
                            simulate_sparse(final, ins, backend=backend))
        else:
            out[backend] = (equivalent(ref, final, ins, n=32,
                                       backend=backend),
                            simulate(final, ins, SIM_NETLIST_CYCLES,
                                     backend=backend))
    return (out["torch"][0], out["interpreter"][0],
            out["torch"][1] == out["interpreter"][1])


def serve_apps(names: dict) -> dict:
    """Apps under the trace's names (``{name: base app}``)."""
    import dataclasses
    from repro_torch.core import ALL_APPS
    return {n: dataclasses.replace(ALL_APPS[b], name=n)
            for n, b in names.items()}


def wide_waves_trace():
    """benchmarks/serve_online.py's ``wide_waves_trace``: four width-4
    tenants fill the column groups, the 2nd and 4th depart, then the
    width-8 harris arrives, admissible online only through the compacting
    re-pack."""
    from repro_torch.core import session_trace
    sessions = [("a0", 0, 20_000_000), ("a1", 100, 5_000_000),
                ("a2", 200, 20_000_000), ("a3", 300, 6_000_000),
                ("w1", 8_000_000, 20_000_000)]
    apps = serve_apps({"a0": "vecadd", "a1": "elemmul", "a2": "ttv",
                       "a3": "mttkrp", "w1": SERVE_WIDE})
    return session_trace(sessions, period=SERVE_PERIOD,
                         name="wide_waves"), apps


def churn_trace(n_sessions: int, seed: int):
    """benchmarks/serve_online.py's ``churn_trace``: overlapping narrow and
    wide tenants arriving and departing around the fabric's capacity."""
    import random
    from repro_torch.core import session_trace
    rng = random.Random(seed)
    bases = list(SERVE_NARROW) + [SERVE_WIDE]
    names, sessions, t = {}, [], 0
    for i in range(n_sessions):
        base = rng.choice(bases)
        name = f"{base}_s{i}"
        names[name] = base
        t += rng.randint(100_000, 400_000)
        sessions.append((name, t, t + rng.randint(300_000, 1_500_000)))
    return session_trace(sessions, period=SERVE_PERIOD,
                         name=f"churn{seed}"), serve_apps(names)


def soak_trace(n_sessions: int, seed: int):
    """tests/test_sched.py's ``soak_trace``: overlapping random sessions of
    the narrow sparse apps, the churn that evicts and readmits."""
    import random
    from repro_torch.core import session_trace
    rng = random.Random(seed)
    names, sessions, t = {}, [], 0
    for i in range(n_sessions):
        base = rng.choice(SERVE_NARROW)
        name = f"{base}_s{i}"
        names[name] = base
        t += rng.randint(100_000, 400_000)
        sessions.append((name, t, t + rng.randint(300_000, 1_200_000)))
    return session_trace(sessions, period=SERVE_PERIOD,
                         name=f"soak{seed}"), serve_apps(names)


def serve_trace(trace, apps, cfg, svc) -> dict:
    """``benchmarks/serve_online.py``'s ``run_trace`` through ``svc``:
    online (``FabricScheduler.run``) and static (``evaluate_static``), each
    seated compile recorded with its region and cap. Every readmitted
    resident's compile is held to a fresh one with the same region and cap
    (every seated compile with ``fresh="all"``)."""
    from repro_torch.core import (FabricScheduler, evaluate_static,
                                  sched_latency_weight)

    seated = []

    class Seats(FabricScheduler):
        def _log(self, out, cycle, kind, app, **detail):
            super()._log(out, cycle, kind, app, **detail)
            moved = {"admit": [app], "readmit": [app],
                     "repack": detail.get("moved", [])}.get(kind, [])
            for n in moved:
                res = self._residents[n]
                seated.append((kind, n, res.region, res.cap_mw, res.result))

    configs = {n: cfg for n in trace.arrivals}
    weight = sched_latency_weight()
    t0 = time.perf_counter()
    online = Seats(service=svc, latency_weight=weight).run(
        trace, apps, configs=configs)
    t_online = time.perf_counter() - t0
    t0 = time.perf_counter()
    static = evaluate_static(trace, apps, service=svc, configs=configs,
                             latency_weight=weight)
    t_static = time.perf_counter() - t0
    wins = (online.objective > static.objective
            or online.rejected < static.rejected)
    return {"online": online, "static": static, "wins": wins,
            "seconds": (t_online, t_static), "seated": seated}


def check_seated(seated, kinds, cfg, fresh_compiler) -> int:
    """Each seated compile of ``kinds`` equal byte for byte to a fresh
    compile with the same region and cap; returns how many were held."""
    from repro_torch.core import resident_config
    n = 0
    for kind, name, region, cap, served in seated:
        if kind not in kinds:
            continue
        direct = fresh_compiler().compile(
            served.app, resident_config(cfg, region, power_cap_mw=cap))
        if result_bytes(direct) != result_bytes(served):
            raise RuntimeError(f"multi serve: the {kind} compile of {name} "
                               f"in {region} differs from a fresh compile")
        n += 1
    return n


def phase_multi(dev, card: str) -> dict:
    """Multi-app fabric sharing and online serving: packs on the host
    backends and on the card's torch engines, each torch resident's design
    through the sim kernels; the online scheduler against the static
    packer; the LM blocks on the Amber array. Returns the sim kernels'
    launches on this path, ``{"dense": (shared, global), "sparse": ...}``."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS, cgra_amber
    from repro_torch.core import (ALL_APPS, CascadeCompiler, CompileCache,
                                  CompileService, Fabric, MultiAppSpec,
                                  PassConfig, resident_config,
                                  service_batch_window_s, service_max_batch,
                                  validate_regions)
    from repro_torch.core.lmmap import lower_block
    from repro_torch.kernels.sim import sim_dense, sim_sparse

    t_phase = time.perf_counter()

    def fresh(**kw):
        return CascadeCompiler(cache=CompileCache(),
                               stage_cache=CompileCache(), **kw)

    cfg = PassConfig.full(place_moves=MULTI_MOVES)
    tcfg = replace(cfg, pnr_backend="torch", sta_backend="torch")

    # 7e.1: benchmarks/multi_app.py's mixes on the host backends
    host_packs = {}
    for mix, names in MULTI_MIXES.items():
        apps = [ALL_APPS[a] for a in names]
        spec = MultiAppSpec.of(*apps, config=cfg)
        packs, secs, methods = {}, {}, {}
        for backend in ("thread", "process"):
            c = fresh()
            t0 = time.perf_counter()
            packs[backend] = c.compile_multi(spec, verify=True,
                                             backend=backend)
            secs[backend] = time.perf_counter() - t0
            methods[backend] = c.last_batch.get("start_method")
        m = host_packs[mix] = packs["thread"]
        validate_regions(c.fabric, list(m.regions.values()), list(m.regions))
        c = fresh()
        t0 = time.perf_counter()
        serial = [c.compile(a, resident_config(cfg, m.regions[a.name]),
                            verify=True) for a in apps]
        secs["serial"] = time.perf_counter() - t0
        if pack_bytes(packs["process"]) != pack_bytes(m) or [
                result_bytes(r) for r in serial] != [
                result_bytes(r) for r in m.results]:
            raise RuntimeError(f"multi {mix}: the serial, thread and process "
                               f"backends differ")
        s = m.summary
        log("multi", f"pack {mix} ({MULTI_MOVES} moves, verify=True): "
            f"regions " + ", ".join(
                f"{n} {r.rows}x{r.cols}@r{r.row0}c{r.col0}"
                for n, r in sorted(m.regions.items()))
            + f"; {s['freq_mhz']:.1f} MHz (limited by "
            f"{s['freq_limited_by']}), shared flush register savings "
            f"{m.flush.register_savings}, utilization "
            f"{s['utilization']:.3f}; serial {secs['serial']:.3f} s, thread "
            f"{secs['thread']:.3f} s, process {secs['process']:.3f} s (start "
            f"method {methods['process']}); the three equal")
    c = fresh()
    app = ALL_APPS["unsharp"]
    alone = c.compile(app, cfg, verify=True)
    one = c.compile_multi(MultiAppSpec(jobs=((app, cfg),)), verify=True)
    if not (one.results[0].cache_hit
            and one.regions[app.name].covers(c.fabric)
            and result_bytes(one.results[0]) == result_bytes(alone)):
        raise RuntimeError("multi: a one-app pack in a full-fabric region "
                           "is not compile()'s result")
    log("multi", "a one-app pack (unsharp) in a full-fabric region == "
        "compile() byte for byte (the same key: a cache hit)")

    # 7e.2: packs on the card's torch engines; each resident's design
    # through the sim kernels, counts from 0
    for fn in (sim_dense, sim_sparse):
        fn.launches = fn.shared_launches = fn.global_launches = 0
    graphs = {"dense": 0, "sparse": 0}
    for mix in MULTI_TORCH_MIXES:
        apps = [ALL_APPS[a] for a in MULTI_MIXES[mix]]
        c = fresh(device=dev)
        t0 = time.perf_counter()
        m = c.compile_multi(MultiAppSpec.of(*apps, config=tcfg),
                            backend="thread")
        secs = time.perf_counter() - t0
        if m.regions != host_packs[mix].regions:
            raise RuntimeError(f"multi torch {mix}: regions differ from the "
                               f"host pack's")
        parts = []
        for r in m.results:
            region = m.regions[r.app.name]
            if r.pass_stats.get("region_fence", {}).get("region") != (
                    region.row0, region.col0, region.rows, region.cols):
                raise RuntimeError(f"multi torch {mix} {r.app.name}: no "
                                   f"region fence check")
            cost_t, cost_n, wl_t, wl_a = engine_bars(
                c, r.app, resident_config(tcfg, region))
            ok_t, ok_i, same = resident_streams(r)
            kind = "sparse" if r.app.sparse else "dense"
            graphs[kind] += RESIDENT_GRAPHS
            if cost_t > 1.10 * cost_n or wl_t > wl_a or not (
                    ok_t and ok_i and same):
                raise RuntimeError(
                    f"multi torch {mix} {r.app.name}: placer cost {cost_t} "
                    f"(numpy {cost_n}), wirelength {wl_t} (A* {wl_a}), "
                    f"equivalent {ok_t} (interpreter {ok_i}), streams "
                    f"equal {same}")
            parts.append(f"{r.app.name} fenced in {region.rows}x"
                         f"{region.cols}@r{region.row0}c{region.col0}, "
                         f"{r.sta.max_freq_mhz:.1f} MHz, placer cost "
                         f"{cost_t / cost_n:.3f} x numpy's, wirelength "
                         f"{wl_t} (A* {wl_a}), equivalent and streams == "
                         f"the interpreter's")
        log("multi", f"pack {mix} on the torch engines (pnr_backend="
            f"sta_backend='torch', {MULTI_MOVES} moves, on the card): "
            f"{secs:.3f} s; {m.summary['freq_mhz']:.1f} MHz; "
            + "; ".join(parts))
    launches = {"dense": (sim_dense.shared_launches,
                          sim_dense.global_launches),
                "sparse": (sim_sparse.shared_launches,
                           sim_sparse.global_launches)}
    if {k: sum(v) for k, v in launches.items()} != graphs or (
            sim_dense.launches, sim_sparse.launches) != (graphs["dense"],
                                                         graphs["sparse"]):
        raise RuntimeError(f"multi: sim launches {launches}, want one a "
                           f"graph {graphs}")
    log("multi", f"sim kernel launches on this path: sim_dense "
        f"{launches['dense']} (shared, global), sim_sparse "
        f"{launches['sparse']}: one a graph simulated")

    # 7e.3: benchmarks/serve_online.py's traces through one service each,
    # online against static
    svc_kw = dict(batch_window_s=service_batch_window_s(),
                  max_batch=service_max_batch())
    soak_fabric = Fabric(rows=8, cols=16, mem_col_stride=4,
                         name="sched8x16")
    legs = [("host, thread backend", wide_waves_trace(), cfg, {}),
            ("host, thread backend", churn_trace(*SERVE_CHURN), cfg, {}),
            ("host, process backend", wide_waves_trace(), cfg,
             {"backend": "process"}),
            ("torch engines on the card", wide_waves_trace(), tcfg,
             {"device": dev}),
            ("torch engines on the card", soak_trace(*SOAK_SESSIONS),
             replace(tcfg, place_moves=SOAK_MOVES),
             {"device": dev, "fabric": soak_fabric})]
    outcomes = {}
    for label, (trace, apps), leg_cfg, kw in legs:
        soak = trace.name.startswith("soak")
        svc = CompileService(**svc_kw, **kw).start()
        try:
            res = serve_trace(trace, apps, leg_cfg, svc)
            stats = svc.stats()
            lb = dict(svc.compiler.last_batch)
        finally:
            svc.stop()
        on = res["online"]
        # online must win on the benchmark's fragmentation traces; the
        # soak is there to evict and readmit on the card
        if not (on.evicted and on.readmitted if soak else res["wins"]):
            raise RuntimeError(f"serve {trace.name} ({label}): "
                               f"{on.summary()}")
        device = kw.get("device")
        kinds = ("admit", "readmit", "repack") if device else ("readmit",)
        held = check_seated(res["seated"], kinds, leg_cfg,
                            lambda: fresh(device=device,
                                          fabric=kw.get("fabric")))
        outcomes[(trace.name, label)] = res
        on, st = res["online"].summary(), res["static"].summary()
        log("serve", f"{trace.name} ({label}, {leg_cfg.place_moves} moves, "
            f"{svc.compiler.fabric.name}): online "
            f"admitted {on['admitted']}, readmitted {on['readmitted']}, "
            f"evicted {on['evicted']}, repacks {on['repacks']}, rejected "
            f"{on['rejected']}, objective {on['objective']}, "
            f"{res['seconds'][0]:.3f} s wall; static admitted "
            f"{st['admitted']}, rejected {st['rejected']}, objective "
            f"{st['objective']}, {res['seconds'][1]:.3f} s wall; online "
            f"{'wins' if res['wins'] else 'does not win'}; {held} {'/'.join(kinds)} compiles == fresh compiles "
            f"with the same region and cap; service {stats['completed']} "
            f"compiles, {stats['batches']} batches (largest "
            f"{stats['largest_batch']}), {stats['dedup_inflight']} "
            f"in-flight dedups; last batch {json.dumps(lb)}")
    a, b = (outcomes[("wide_waves", f"host, {x} backend")]
            for x in ("thread", "process"))
    if [(json.dumps(o.events, sort_keys=True), o.objective)
            for o in (a["online"], a["static"])] != [
            (json.dumps(o.events, sort_keys=True), o.objective)
            for o in (b["online"], b["static"])]:
        raise RuntimeError("serve wide_waves: the process-backend service's "
                           "outcome differs from the thread backend's")
    # a burst the dispatch thread coalesces into one batch: one pool of
    # spawned workers (CUDA is initialised in this process)
    svc = CompileService(backend="process", **svc_kw)
    burst = [ALL_APPS[a] for a in SERVE_NARROW]
    tickets = [svc.submit(a, cfg) for a in burst]
    t0 = time.perf_counter()
    svc.start()
    try:
        got = [t.result(timeout=600) for t in tickets]
        secs = time.perf_counter() - t0
        lb = dict(svc.compiler.last_batch)
    finally:
        svc.stop()
    want = [fresh().compile(a, cfg) for a in burst]
    if lb.get("start_method") != "spawn" or lb.get("compiled") != len(
            burst) or [result_bytes(r) for r in got] != [
            result_bytes(r) for r in want]:
        raise RuntimeError(f"serve burst: {lb}")
    log("serve", f"a burst of {len(burst)} requests on the process-backend "
        f"service: one batch from the dispatch thread in {secs:.3f} s, "
        f"workers {lb['workers']}, start method {lb['start_method']}; "
        f"results == serial compiles")

    # 7e.4: benchmarks/lm_lowering.py's blocks on the Amber array
    amber = dict(fabric=cgra_amber.make_fabric(),
                 timing=cgra_amber.make_timing_model(),
                 energy=cgra_amber.make_energy_params())
    flows = (PassConfig.unpipelined, PassConfig.full)

    def lm_rows(results, names):
        return {n: (r0.sta.max_freq_mhz, r1.sta.max_freq_mhz,
                    r0.sta.critical_path_ns / r1.sta.critical_path_ns,
                    r0.power.edp_js / r1.power.edp_js)
                for n, r0, r1 in zip(names, results[::2], results[1::2])}

    c = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache(),
                        **amber)
    specs = {n: lower_block(a) for n, a in ARCHS.items()}
    t0 = time.perf_counter()
    res = c.compile_batch([(specs[n], f(place_moves=MULTI_MOVES))
                           for n in ARCHS for f in flows])
    secs = time.perf_counter() - t0
    host = lm_rows(res, list(ARCHS))
    for n, (unpip, pip, cp, edp) in host.items():
        if not all(math.isfinite(x) and x > 0 for x in (unpip, pip, cp, edp)):
            raise RuntimeError(f"lm {n}: {host[n]}")
        log("lm", f"{n} ({ARCHS[n].family}, sparse path "
            f"{int(specs[n].sparse)}) on {amber['fabric'].name}: unpip_mhz "
            f"{unpip:.0f}, pip_mhz {pip:.0f}, cp_ratio {cp:.2f}, edp_ratio "
            f"{edp:.2f}")
    log("lm", f"{len(res)} block compiles through compile_batch on the host "
        f"backends in {secs:.3f} s; last batch {json.dumps(c.last_batch)}")
    ct = CascadeCompiler(cache=CompileCache(), stage_cache=CompileCache(),
                         device=dev, **amber)
    t0 = time.perf_counter()
    res = ct.compile_batch([(specs[n], replace(
        f(place_moves=MULTI_MOVES), pnr_backend="torch",
        sta_backend="torch")) for n in LM_TORCH_ARCHS for f in flows],
        backend="thread")
    secs = time.perf_counter() - t0
    for n, (unpip, pip, cp, edp) in lm_rows(res, LM_TORCH_ARCHS).items():
        # the placer's bar holds; the wirelength against A*'s is a reading
        # (the batched router is the reference's algorithm, held to A* on
        # tests/test_torch_pnr.py's designs only)
        bars = [engine_bars(ct, r.app, r.config) for r in res
                if r.app.name == specs[n].name]
        if any(ct_ > 1.10 * cn for ct_, cn, _, _ in bars):
            raise RuntimeError(f"lm torch {n}: placer cost past its bar: "
                               f"{bars}")
        log("lm", f"{n} on the torch engines (card): unpip_mhz {unpip:.0f}, "
            f"pip_mhz {pip:.0f}, cp_ratio {cp:.2f}, edp_ratio {edp:.2f} "
            f"(host {host[n][2]:.2f}, {host[n][3]:.2f}); unpipelined, full: "
            f"placer cost "
            + ", ".join(f"{ct_ / cn:.3f}" for ct_, cn, _, _ in bars)
            + " x numpy's; wirelength "
            + ", ".join(f"{wt} (A* {wa})" for _, _, wt, wa in bars))
    log("lm", f"{len(res)} block compiles on the torch engines in "
        f"{secs:.3f} s")
    log("multi", f"phase took {time.perf_counter() - t_phase:.1f} s on "
        f"{card}")
    return launches


def print_ok() -> None:
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main(argv) -> int:
    if argv not in ([], ["--phase", "sim"], ["--phase", "multi"]):
        raise SystemExit("usage: python3 chip_smoke.py [--phase sim|multi]")
    card = phase_device()
    # f32 comparisons run in full f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda")
    phase_build()
    if argv == ["--phase", "multi"]:    # phases 1, 2, 7e
        phase_multi(dev, card)
        print_ok()
        return 0
    if argv:                    # phases 1, 2, Table I on the host, 7c
        from repro_torch.core import CascadeCompiler
        _, table1, secs = table1_designs(CascadeCompiler())
        log("compile", f"Table I on the host in {secs:.2f} s")
        for e in phase_sim(dev, card, table1):
            log("sim", json.dumps(e))
        print_ok()
        return 0
    decode = phase_kernels(dev)
    attn = phase_flash_attention(dev)
    decode["launches"] = phase_serve(card)
    torch.cuda.empty_cache()
    attn["launches"] = phase_train(card)
    torch.cuda.empty_cache()
    phase_train_smoke(card)
    torch.cuda.empty_cache()
    path, mp_launches, st_launches, table1 = phase_compile(dev, card)
    dev_runs = phase_engines(dev, card, table1)
    sim = phase_sim(dev, card, table1)
    phase_batch(dev, card, table1, dev_runs)
    multi = phase_multi(dev, card)
    for e in sim:             # the sim kernels' launches on both paths
        kind = "dense" if e["name"].startswith("sim_dense") else "sparse"
        e["launches"] += (multi[kind][1] if e["name"].endswith("_global")
                          else sum(multi[kind]))
    maxplus = phase_maxplus(dev, path)
    stencil = phase_stencil(dev)
    maxplus["launches"], stencil["launches"] = mp_launches, st_launches
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {k: e[k] for k in keys}
        for e in (decode, attn, maxplus, stencil, *sim)]}), flush=True)
    print_ok()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
