"""Cascade-guided pipeline-stage partitioning (beyond-paper bridge).

The paper's post-PnR pipelining loop is: find the critical combinational
segment with STA, break it by enabling a register, re-balance, repeat until
no segment improves.  At cluster scale the same loop solves pipeline-
parallel stage partitioning: layers are "combinational elements" whose delay
is their per-chip roofline time, a stage boundary is a "pipeline register"
whose cost is the activation transfer between cards, and the clock period is
the pipeline beat (the slowest stage).  1F1B fill/drain bubbles play the
role of pipeline fill latency.

``partition(...)`` runs exactly that loop:

  1. start with one segment (all layers combinational);
  2. STA = segment delays (max-plus over the chain);
  3. break the worst segment at its weighted median — the register-insertion
     step — while the added boundary pays for itself (beat shrinks);
  4. stop at the stage budget, or when three consecutive breaks improve the
     beat by <5% (the paper's §V-D stopping rule).

Compared to the naive contiguous equal-layer split, this balances
heterogeneous stacks (MoE interleave, hybrid shared-attention) by cost, not
by count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec

# One H100 SXM5, from NVIDIA's data sheet (dense bf16 on the tensor cores,
# HBM3, NVLink 4's 900 GB/s split in its two directions); the card these
# plans are read beside reports itself to nvidia-smi as "NVIDIA H100 80GB
# HBM3, 700.00 W". The reference's constants were a TPU v5e's.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9


# ---------------------------------------------------------------------------
# per-layer roofline delays


def layer_costs(cfg: ModelConfig, shape: ShapeSpec, chips_per_stage: int,
                microbatches: int = 8) -> List[float]:
    """Per-layer per-microbatch step time (s) on `chips_per_stage` chips:
    max(compute, memory) roofline term of one layer."""
    tokens = shape.seq_len * shape.global_batch / microbatches
    d, hd = cfg.d_model, cfg.resolved_head_dim
    fwd_bwd = 3.0 if shape.kind == "train" else 1.0

    def t(flops, bytes_):
        return max(flops / (chips_per_stage * PEAK_FLOPS),
                   bytes_ / (chips_per_stage * HBM_BW))

    out: List[float] = []
    for li in range(cfg.num_layers):
        attn_p = cfg._attn_params(d, cfg.num_heads, cfg.num_kv_heads, hd)
        if cfg.family in ("ssm", "hybrid"):
            p = (cfg._rwkv_layer_params() if cfg.family == "ssm"
                 else cfg._mamba_layer_params())
            fl = 2 * p * tokens * fwd_bwd
            by = 2 * p + tokens * d * 2 * 6
            if cfg.family == "hybrid" and cfg.shared_attn_every and \
                    (li + 1) % cfg.shared_attn_every == 0:
                ap = attn_p + cfg._mlp_params(d, cfg.d_ff)
                fl += 2 * ap * tokens * fwd_bwd + \
                    4 * tokens * shape.seq_len * cfg.num_heads * hd * 0.5
                by += 2 * ap
        elif cfg.num_experts and (li % cfg.moe_layer_period ==
                                  cfg.moe_layer_period - 1):
            active = attn_p + cfg.experts_per_token * \
                cfg._mlp_params(d, cfg.d_ff) * cfg.capacity_factor
            fl = 2 * active * tokens * fwd_bwd + \
                4 * tokens * shape.seq_len * cfg.num_heads * hd * 0.5 * fwd_bwd
            # MoE reads ALL resident expert weights per step: memory-heavy
            by = 2 * (attn_p + cfg.num_experts * cfg._mlp_params(d, cfg.d_ff)
                      / max(1, chips_per_stage)) + tokens * d * 2 * 8
        else:
            p = attn_p + cfg._mlp_params(
                d, cfg.d_ff, gated=cfg.family != "audio")
            fl = 2 * p * tokens * fwd_bwd + \
                4 * tokens * shape.seq_len * cfg.num_heads * hd * 0.5 * fwd_bwd
            by = 2 * p + tokens * d * 2 * 8
        out.append(t(fl, by))
    return out


def boundary_cost(cfg: ModelConfig, shape: ShapeSpec, microbatches: int,
                  chips_per_stage: int) -> float:
    """Activation transfer time across one stage boundary (per microbatch)."""
    tokens = shape.seq_len * shape.global_batch / microbatches
    act_bytes = tokens * cfg.d_model * 2
    return act_bytes / (chips_per_stage * NVLINK_BW)


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PipelinePlan:
    boundaries: List[int]            # stage i = layers [b[i], b[i+1])
    beat_s: float                    # slowest stage+boundary time
    makespan_s: float                # (M + S - 1) * beat (1F1B)
    bubble_frac: float
    stage_times: List[float]
    history: List[Tuple[int, float]]  # (n_stages, beat) per iteration


def _stage_times(costs: Sequence[float], bounds: List[int],
                 bcost: float) -> List[float]:
    out = []
    for i in range(len(bounds) - 1):
        seg = sum(costs[bounds[i]:bounds[i + 1]])
        out.append(seg + (bcost if i + 1 < len(bounds) - 1 else 0.0))
    return out


def _refine(costs: Sequence[float], bounds: List[int], bcost: float,
            max_pass: int = 64) -> List[int]:
    """Branch-delay-style re-balancing: slide each internal boundary while
    it lowers the worse of its two adjacent stages (the Cascade matching
    step after a register insertion)."""
    bounds = list(bounds)
    for _ in range(max_pass):
        improved = False
        for i in range(1, len(bounds) - 1):
            def pair_max(b):
                left = sum(costs[bounds[i - 1]:b])
                right = sum(costs[b:bounds[i + 1]])
                return max(left, right)
            cur = pair_max(bounds[i])
            for cand in (bounds[i] - 1, bounds[i] + 1):
                if bounds[i - 1] < cand < bounds[i + 1] and \
                        pair_max(cand) < cur - 1e-12:
                    bounds[i] = cand
                    cur = pair_max(cand)
                    improved = True
        if not improved:
            break
    return bounds


def partition(costs: Sequence[float], num_stages: int, bcost: float,
              microbatches: int = 8, improve_eps: float = 0.05
              ) -> PipelinePlan:
    """Cascade post-PnR loop over the layer chain."""
    n = len(costs)
    bounds = [0, n]
    history: List[Tuple[int, float]] = []
    stale = 0
    while len(bounds) - 1 < num_stages and stale < 3:
        times = _stage_times(costs, bounds, bcost)
        beat = max(times)
        history.append((len(bounds) - 1, beat))
        # critical segment = the paper's critical path
        wi = int(np.argmax(times))
        lo, hi = bounds[wi], bounds[wi + 1]
        if hi - lo < 2:
            break
        # break near the weighted median (balanced register insertion):
        # evaluate the median cut and its neighbours, keep the best —
        # alternating-cost stacks (MoE interleave) make the raw median
        # overshoot by one
        seg = list(costs[lo:hi])
        csum = np.cumsum(seg)
        med = lo + 1 + int(np.searchsorted(csum, csum[-1] / 2))
        best_cut, best_val = None, None
        for cut in (med - 1, med, med + 1):
            cut = min(max(cut, lo + 1), hi - 1)
            val = max(sum(costs[lo:cut]), sum(costs[cut:hi]))
            if best_val is None or val < best_val:
                best_cut, best_val = cut, val
        new_bounds = sorted(set(bounds + [best_cut]))
        new_beat = max(_stage_times(costs, new_bounds, bcost))
        if new_beat >= beat * (1 - improve_eps):
            stale += 1
        else:
            stale = 0
        bounds = new_bounds
    bounds = _refine(costs, bounds, bcost)
    times = _stage_times(costs, bounds, bcost)
    beat = max(times)
    s = len(bounds) - 1
    makespan = (microbatches + s - 1) * beat
    ideal = sum(costs)
    return PipelinePlan(
        boundaries=bounds, beat_s=beat, makespan_s=makespan,
        bubble_frac=(s - 1) / (microbatches + s - 1),
        stage_times=times, history=history)


def naive_partition(costs: Sequence[float], num_stages: int, bcost: float,
                    microbatches: int = 8) -> PipelinePlan:
    """Contiguous equal-LAYER-count split (the baseline every framework
    ships)."""
    n = len(costs)
    bounds = [round(i * n / num_stages) for i in range(num_stages + 1)]
    bounds = sorted(set(bounds))
    times = _stage_times(costs, bounds, bcost)
    beat = max(times)
    s = len(bounds) - 1
    return PipelinePlan(
        boundaries=bounds, beat_s=beat,
        makespan_s=(microbatches + s - 1) * beat,
        bubble_frac=(s - 1) / (microbatches + s - 1),
        stage_times=times, history=[])


def plan_for(cfg: ModelConfig, shape: ShapeSpec, num_stages: int = 4,
             chips_per_stage: int = 64, microbatches: int = 8
             ) -> Dict[str, PipelinePlan]:
    costs = layer_costs(cfg, shape, chips_per_stage, microbatches)
    bc = boundary_cost(cfg, shape, microbatches, chips_per_stage)
    return {
        "cascade": partition(costs, num_stages, bc, microbatches),
        "naive": naive_partition(costs, num_stages, bc, microbatches),
    }
