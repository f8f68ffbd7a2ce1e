"""Training cells: the program's ``make_train_step`` (forward, loss with the
router's balance term, backward, AdamW in place) on a new batch each step.

Set-up makes the weights from the seed and builds the one train state;
warming drives it through the mix's first ``checked_steps`` steps by the
window's own call (``st["step"]``) and feed (``st["feed"]``); those
readings (each step's loss, the first gradient as AdamW's first moment
holds it, each leaf's change after the last of them) are what the
reference is held to. The window then goes on from the same state, a step
at a time, each step's loss read on the host as a trainer logs it, until
the first step that ends after ``--seconds``.

After the window the program's state is freed and the plain reference
makes the weights again and takes the same steps on the same batches.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List, Tuple

import torch

from reference.common import AdamW, Numerics, adamw_step, leaves, leaf_names

from harness import counts, traffic, weights
from harness.run import Run, free_device, strict_f32


def _optimizer(mix: Dict) -> AdamW:
    o = mix["optimizer"]
    return AdamW(peak_lr=o["peak_lr"], total_steps=o["total_steps"])


def _norms(tree: Dict) -> Dict[str, float]:
    return {n: float(t.float().norm()) for n, t in weights.items(tree)}


def setup(run: Run) -> Dict:
    from repro_torch.launch import steps as S
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init, make_optimizer

    mix, dev = run.cell.mix, run.device
    port = run.port_config()
    model = LM(port)
    ref = run.reference()
    params = weights.make(ref.param_layout(), run.seed, traffic.WEIGHTS, dev)
    weights.check_layout(params, model.shapes(), "parameters")
    opt = mix["optimizer"]
    opt_cfg = make_optimizer(port.optimizer, total_steps=opt["total_steps"],
                             lr=opt["peak_lr"],
                             grad_compress=port.grad_compress)
    b, s, vocab = mix["batch"], mix["seq_len"], run.cfg["vocab_size"]
    run.work = counts.train_step(ref, b, s)
    return {"state": {"params": params, "opt": adamw_init(params, opt_cfg)},
            "step": S.make_train_step(model, opt_cfg),
            "feed": lambda k: traffic.train_batch(run.seed, k, b, s, vocab,
                                                  dev),
            "next": 0, "model": model, "b1": opt_cfg.b1}


def warm(run: Run, st: Dict) -> None:
    """The checked steps, and the program's readings of them."""
    losses = []
    for k in range(run.cell.mix["checked_steps"]):
        losses.append(_step(st))
        if k == 0:
            grads = {n: v / (1 - st["b1"])
                     for n, v in _norms(st["state"]["opt"].mu).items()}
    init = weights.make(run.reference().param_layout(), run.seed,
                        traffic.WEIGHTS, run.device)
    change = {n: float((p.float() - p0.float()).norm())
              for (n, p), (_, p0) in zip(weights.items(st["state"]["params"]),
                                         weights.items(init))}
    del init
    st["program"] = {"loss": losses, "grad": grads, "change": change}


def _step(st: Dict) -> float:
    st["state"], loss = st["step"](st["state"], st["feed"](st["next"]))
    st["next"] += 1
    return float(loss)


def window(run: Run, st: Dict) -> None:
    mix = run.cell.mix
    t0 = time.perf_counter()
    while True:
        loss = _step(st)
        run.units += 1
        if not math.isfinite(loss):
            run.failed += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.attempted = run.units
    tokens = run.units * mix["batch"] * mix["seq_len"]
    run.end_to_end["train_tokens_per_s"] = tokens / run.window_s


def traced(run: Run, st: Dict) -> None:
    """A profiled stretch of ``trace_steps`` steps; the attention kernel's
    bound a call (the trace counts its calls: forward and any recompute)."""
    from harness.trace import profile
    mix, cfg = run.cell.mix, run.cfg
    run.trace = profile(lambda: _step(st), mix["trace_steps"])
    run.bounds["flash_attention_wgmma_kernel"] = \
        counts.attention_call_seconds(mix["batch"], cfg["num_heads"],
                                      cfg["num_kv_heads"], mix["seq_len"],
                                      cfg["head_dim"])


def reference_steps(run: Run, num: Numerics) -> Dict:
    """The reference's readings on the same weights and batches."""
    mix, dev = run.cell.mix, run.device
    ref = run.reference()
    layout = ref.param_layout()
    stored = weights.make(layout, run.seed, traffic.WEIGHTS, dev)
    names = leaf_names(stored)
    dtypes = [t.dtype for t in leaves(stored)]
    master = [t.float() for t in leaves(stored)]
    del stored
    m = [torch.zeros_like(p) for p in master]
    v = [torch.zeros_like(p) for p in master]
    opt = _optimizer(mix)
    losses: List[float] = []
    grads: Dict[str, float] = {}
    for k in range(mix["checked_steps"]):
        batch = traffic.train_batch(run.seed, k, mix["batch"],
                                    mix["seq_len"], run.cfg["vocab_size"],
                                    dev)
        for p in master:
            p.requires_grad_(True)
        tree = _tree(layout, master)
        loss = ref.loss(num, tree, batch["tokens"], batch["labels"])
        g = torch.autograd.grad(loss, master)
        for p in master:
            p.requires_grad_(False)
        clipped = adamw_step(opt, k + 1, master, list(g), m, v)
        del g
        with torch.no_grad():       # stored at the configuration's dtypes
            for p, dt in zip(master, dtypes):
                p.copy_(p.to(dt).float())
        losses.append(float(loss.detach()))
        if k == 0:
            grads = {n: float(c.norm()) for n, c in zip(names, clipped)}
        del clipped, loss
    init = leaves(weights.make(layout, run.seed, traffic.WEIGHTS, dev))
    change = {n: float((p - p0.float()).norm())
              for n, p, p0 in zip(names, master, init)}
    return {"loss": losses, "grad": grads, "change": change}


def _tree(layout: Dict, flat: List[torch.Tensor]) -> Dict:
    it = iter(flat)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}
    return build(layout)


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: each step's relative loss gap, and each
    leaf's gap of norms (the first gradient; the change over the checked
    steps) against the larger of that leaf's and the median leaf's
    reference norm: the worst leaf's, and the mean over the leaves of the
    first gradient's. Leaves whose reference gradient is under a
    thousandth of the median leaf's (nought to rounding) are left out of
    the change."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    g_med = statistics.median(ref["grad"].values())
    grad = {n: (prog["grad"][n] - r) / max(r, g_med)
            for n, r in ref["grad"].items()}
    moved = [n for n, r in ref["grad"].items() if r >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][n] for n in moved)
    change = {n: (prog["change"][n] - ref["change"][n])
              / max(ref["change"][n], c_med) for n in moved}
    out = {"loss_gap": max(steps),
           "grad_gap": max(abs(g) for g in grad.values()),
           "grad_gap_mean": statistics.fmean(abs(g) for g in grad.values()),
           "change_gap": max(abs(c) for c in change.values())}
    out.update({f"loss_gap.{k + 1}": g for k, g in enumerate(steps)})
    # each leaf's signed gaps, for the look behind a limit
    out.update({f"grad_gap:{n}": g for n, g in grad.items()})
    out.update({f"change_gap:{n}": c for n, c in change.items()})
    return out


def check(run: Run, st: Dict, sides: Tuple[str, ...]) -> Dict[str, Dict]:
    """The readings of each side against the float32 reference: the
    program's (taken in warming), and the control's (the reference in fp8
    in the program's place)."""
    prog = st["program"]
    st.clear()
    free_device()
    strict_f32()
    ref = reference_steps(run, Numerics("f32"))
    out = {"program": gaps(prog, ref)}
    if "control" in sides:
        out["control"] = gaps(reference_steps(run, Numerics("fp8")), ref)
    return out
