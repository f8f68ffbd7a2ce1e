"""Decode cells: the program's ``make_decode_step``, greedy, every session
at once, each step's tokens copied to the host as a server that streams
them must.

Set-up makes the weights and a long history from the seed: the cache is
written in the program's own layout (keys and values of positions
0..history-1, and for recurrent layers their states), no prefill run. The
sessions then decode in rounds of ``round`` steps from position
``history``; after a round the position goes back to ``history``: the
recurrent state goes on, the key and value slots of the round are written
over. Warming takes the mix's ``warmup_steps`` first steps (every shape the
window uses); the window goes on until the first step that ends after
``--seconds``. Each step ends in a CUDA event, and the gap between two
consecutive events is the gap between a session's tokens.

After the window: the sampled sessions' final cache and the tokens of every
step are kept, the program's state freed, and the plain reference replays
those sessions from the same history, fed the same tokens, round by round.
Its control (the reference in fp8 in the program's place) is judged the
same way, by its own best token at each position and its own cache.
Readings: how far a served token's logit lies below the reference's best
(greedy tokens; the widest gap and the mean over every position judged),
the relative error of the last step's logits, and the relative errors of
the cache and state the program wrote; ``limits/<workload>.json`` says
which of them are compared.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List, Tuple

import torch

from reference.common import Numerics

from harness import counts, traffic, weights
from harness.run import Run, free_device, strict_f32


def setup(run: Run) -> Dict:
    from repro_torch.launch import steps as S
    from repro_torch.models import LM

    mix, dev, cfg = run.cell.mix, run.device, run.cfg
    model = LM(run.port_config())
    ref = run.reference()
    b, slots = mix["sessions"], mix["cache_slots"]
    params = weights.make(ref.param_layout(), run.seed, traffic.WEIGHTS, dev)
    weights.check_layout(params, model.shapes(), "parameters")
    cache = weights.make(ref.cache_layout(b, slots), run.seed, traffic.CACHE,
                         dev)
    weights.check_layout(cache, model.cache_shapes(b, slots), "cache")
    sessions = traffic.sample(run.seed, b, mix["check_sessions"])
    return {"params": params, "cache": cache,
            "step": S.make_decode_step(model),
            "fed": [traffic.first_tokens(run.seed, b, cfg["vocab_size"], dev)],
            "served": [], "watched": [], "k": 0, "ref": ref,
            "sessions": sessions, "watch": torch.tensor(sessions, device=dev)}


def warm(run: Run, st: Dict) -> None:
    for _ in range(run.cell.mix["warmup_steps"]):
        _step(run, st)


def position(mix: Dict, k: int) -> int:
    return mix["history"] + k % mix["round"]


def _step(run: Run, st: Dict) -> None:
    logits, _ = st["step"](st["params"], {"tokens": st["fed"][-1]},
                           st["cache"], position(run.cell.mix, st["k"]))
    nxt = logits.argmax(-1)
    # the checked sessions' logits, judged after the window
    st["watched"].append(logits.index_select(0, st["watch"]))
    st["event"] = _event(run)
    st["served"].append(nxt.cpu())           # the tokens streamed out
    st["fed"].append(nxt[:, None])
    st["k"] += 1


def _event(run: Run):
    if run.device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_s(a, b) -> float:
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


def window(run: Run, st: Dict) -> None:
    mix = run.cell.mix
    b = mix["sessions"]
    events = [_event(run)]
    first = st["k"]
    t0 = time.perf_counter()
    while True:
        _step(run, st)
        events.append(st["event"])
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    if run.device.type == "cuda":
        events[-1].synchronize()
    gaps = [_elapsed_s(a, c) for a, c in zip(events, events[1:])]
    run.units = st["k"] - first
    run.attempted = run.units * b
    run.end_to_end["decode_tokens_per_s"] = run.attempted / run.window_s
    run.end_to_end["decode_step_p95_ms"] = 1e3 * percentile(gaps, 95)
    ref = st["ref"]
    per = [counts.decode_step(ref, b, position(mix, k))
           for k in range(first, st["k"])]
    run.work = {k: sum(w[k] for w in per) / len(per) for k in per[0]}


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between the two nearest ranks."""
    v = sorted(values)
    x = (len(v) - 1) * q / 100
    lo = int(math.floor(x))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def traced(run: Run, st: Dict) -> None:
    """A profiled stretch of ``trace_steps`` steps; flash_decode's bound a
    call, averaged over the stretch's positions (the trace counts the
    calls)."""
    from harness.trace import profile
    mix, cfg = run.cell.mix, run.cfg
    n = mix["trace_steps"]
    first = st["k"]
    run.trace = profile(lambda: _step(run, st), n)
    g = cfg["num_heads"] // cfg["num_kv_heads"]
    run.bounds["flash_decode"] = sum(
        counts.decode_call_seconds(mix["sessions"], cfg["num_kv_heads"], g,
                                   cfg["head_dim"], position(mix, k) + 1)
        for k in range(first, first + n)) / n


def check(run: Run, st: Dict, sides: Tuple[str, ...]) -> Dict[str, Dict]:
    mix = run.cell.mix
    ref = st["ref"]
    sessions, idx = st["sessions"], st["watch"]
    steps = st["k"]
    last_round = (steps - 1) // mix["round"] * mix["round"]
    written = steps - last_round        # slots of the last round
    prog = {}
    for name, t in ref.flat_cache(st["cache"]).items():
        t = t.index_select(1, idx)
        if name in ("k", "v"):
            t = t[:, :, :, mix["history"]:mix["history"] + written]
        prog[name] = t.float().clone()
    fed = torch.cat(st["fed"][:steps], 1).index_select(0, idx)   # [b, n]
    served = torch.stack(st["served"][:steps], 1).to(run.device)
    served = served.index_select(0, idx)
    prog["logits"] = torch.stack(st["watched"][:steps], 1)     # [b, n, V]
    st.clear()
    free_device()
    strict_f32()
    return replay(run, ref, sessions, fed, served, prog, written,
                  "control" in sides)


def replay(run: Run, ref, sessions: List[int], fed: torch.Tensor,
           served: torch.Tensor, prog: Dict, written: int, control: bool
           ) -> Dict[str, Dict]:
    """The reference over the sampled sessions, round by round, fed the
    tokens the program was fed. Returns the program's readings and, with
    ``control``, those of the fp8 reference in its place (its own best
    token at each position is what is judged, and its cache)."""
    mix, dev = run.cell.mix, run.device
    b, slots, hist = mix["sessions"], mix["cache_slots"], mix["history"]
    idx = torch.tensor(sessions, device=dev)
    params = weights.make(ref.param_layout(), run.seed, traffic.WEIGHTS, dev)
    full = weights.make(ref.cache_layout(b, slots), run.seed, traffic.CACHE,
                        dev)
    start = {}
    for name, t in ref.flat_cache(full).items():
        t = t.index_select(1, idx)
        start[name] = (t[:, :, :, :hist] if name in ("k", "v") else t).clone()
    del full
    free_device()
    sides = {"ref": Numerics("f32")}
    if control:
        sides["control"] = Numerics("fp8")
    prog_logits = prog.pop("logits")
    prefix = {"k": start["k"], "v": start["v"]}
    state = {s: {k: v for k, v in start.items() if k not in prefix}
             for s in sides}
    gap = {"program": [], "control": []}
    err = {"program": [], "control": []}
    last = {}
    for r0 in range(0, fed.shape[1], mix["round"]):
        toks = fed[:, r0:r0 + mix["round"]]
        for s, num in sides.items():
            logits, last[s] = ref.forward_cached(num, params, toks,
                                                 dict(state[s], **prefix))
            state[s] = {k: last[s][k] for k in state[s]}
            if s == "ref":
                want = logits
            else:
                ctl = logits
        chosen = {"program": served[:, r0:r0 + mix["round"]]}
        judged = {"program": prog_logits[:, r0:r0 + mix["round"]]}
        if control:
            chosen["control"] = ctl.argmax(-1)
            judged["control"] = ctl
        best = want.max(-1).values
        for s, c in chosen.items():
            gap[s].append(best - want.gather(-1, c[..., None])[..., 0])
            err[s].append(row_errors(judged[s], want))
    out = {"program": dict(state_errors(prog, last["ref"]),
                           **token_gaps(gap["program"]),
                           **logit_errors(err["program"]))}
    if control:
        out["control"] = dict(state_errors(last["control"], last["ref"]),
                              **token_gaps(gap["control"]),
                              **logit_errors(err["control"]))
    return out


def token_gaps(gaps: List[torch.Tensor]) -> Dict[str, float]:
    """How far below the reference's best logit the judged tokens' logits
    lie: the widest gap, and the mean over every position judged."""
    g = torch.cat([t.reshape(-1) for t in gaps])
    return {"token_gap": float(g.max()), "token_gap_mean": float(g.mean())}


def row_errors(a: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The relative error of each position's logits (the last dim)."""
    want = want.float()
    return (a.float() - want).norm(dim=-1) / want.norm(dim=-1)


def logit_errors(errs: List[torch.Tensor]) -> Dict[str, float]:
    """The relative logit errors of the positions judged: their median (a
    rare position whose routing flipped on rounding moves it little) and
    the worst."""
    e = torch.cat([t.reshape(-1) for t in errs])
    return {"logit_err": float(e.median()), "logit_err_max": float(e.max())}


def rel_err(a: torch.Tensor, want: torch.Tensor) -> float:
    """||a - want|| / ||want||, in float32."""
    want = want.float()
    return float((a.float() - want).norm() / want.norm())


def state_errors(judged: Dict, want: Dict) -> Dict[str, float]:
    """Relative errors, ||a - w|| / ||w||, of the cache and state tensors of
    each layer (or each place of a shared block): the worst of all, the
    worst tensor's median over layers, and the worst at the first layer."""
    by_layer = {}
    for name, w in want.items():
        a = judged[name]
        by_layer[name] = [rel_err(a[i], w[i]) for i in range(w.shape[0])]
    return {"state_gap": max(max(v) for v in by_layer.values()),
            "state_gap_median": max(statistics.median(v)
                                    for v in by_layer.values()),
            "state_gap_first": max(v[0] for v in by_layer.values())}
