"""The yardstick's arithmetic: the card's peaks, and the operations and bytes
of each piece of work, counted from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity, at the
700 W limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM. Model operations are
the least the mathematics needs: 2 per multiply-add of a weight per token
the token actually uses (a MoE token's k experts), the attention products
over the (query, key) pairs a causal mask keeps, and any recurrence's state
updates; training counts the forward once and the backward twice, never a
recomputation. Bytes count each tensor read once and each written once.

What differs between families comes from the configuration's plain
reference (``reference/<module>.py``), found by name: its ``counts()``
(parameters by kind, self-attention layers, recurrence flops a token, the
bytes of the weights a step reads) and its ``cache_layout``, whose bytes a
slot and a session are read off two layouts. A new family brings these with
its reference; nothing here names a family.
"""

from __future__ import annotations

from typing import Dict

from reference.common import layout_bytes

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM
HBM_BYTES_PER_S = 3.35e12

BF16, F32 = 2, 4


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card needs: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def causal_pairs(s: int, prefix: int = 0) -> int:
    """(query, key) pairs of s queries at positions prefix.. against every
    key at or before them."""
    return s * prefix + s * (s + 1) // 2


def cache_bytes_per_token(ref) -> int:
    """Bytes the serving cache keeps a token of one session: what one more
    slot adds to the reference's cache layout."""
    return layout_bytes(ref.cache_layout(1, 2)) - \
        layout_bytes(ref.cache_layout(1, 1))


def state_bytes_per_session(ref) -> int:
    """Bytes of a session's cache that do not grow with its slots (a
    recurrence's state)."""
    return layout_bytes(ref.cache_layout(1, 1)) - cache_bytes_per_token(ref)


def attention_flops(ref, batch: int, s: int, prefix: int = 0) -> int:
    """QK and PV of every self-attention layer's forward: 4 hd a pair a
    head."""
    cfg = ref.cfg
    return (4 * cfg["head_dim"] * cfg["num_heads"] * batch
            * causal_pairs(s, prefix) * ref.counts()["attention_layers"])


def model_flops(ref, tokens: int, batch: int, seq: int,
                prefix: int = 0) -> int:
    """One forward over ``batch`` rows of ``seq`` new tokens each after
    ``prefix`` earlier ones (``tokens`` = batch x seq)."""
    c = ref.counts()
    return (2 * c["active"] * tokens + attention_flops(ref, batch, seq, prefix)
            + c["recurrence_flops_per_token"] * tokens)


def train_step(ref, batch: int, seq: int) -> Dict[str, float]:
    """One optimizer step on batch x seq tokens: the forward once and the
    backward twice; weights, gradients and AdamW's two f32 moments read and
    written once, the batch read once."""
    tokens = batch * seq
    n = ref.counts()["total"]
    # parameters read and written (bf16), the f32 gradient written and read,
    # two f32 moments read and written
    nbytes = n * (2 * BF16 + 2 * F32 + 4 * F32) + tokens * 16
    return {"flops": 3.0 * model_flops(ref, tokens, batch, seq),
            "bytes": float(nbytes)}


def decode_step(ref, batch: int, pos: int) -> Dict[str, float]:
    """One decode step of ``batch`` sessions at position ``pos`` (pos
    earlier tokens in the cache): every weight read once (every expert: at
    batch sizes like these each is chosen), a token-table row a session,
    the cache's pos rows read and one written, the states read and
    written, the logits written."""
    c = ref.counts()
    weights = c["weight_bytes"] + batch * ref.cfg["d_model"] * BF16
    cache = batch * (pos + 1) * cache_bytes_per_token(ref)
    state = 2 * batch * state_bytes_per_session(ref)
    logits = batch * c["logit_width"] * BF16
    return {"flops": float(model_flops(ref, batch, batch, 1, pos)),
            "bytes": float(weights + cache + state + logits)}


# ---------------------------------------------------------------------------
# one kernel call's bound (as the port's card checks count it)


def attention_call_seconds(batch: int, heads: int, kv: int, s: int, d: int,
                           causal: bool = True) -> float:
    """Least time of one flash_attention forward on bf16 inputs: 4 d flops
    a kept (query, key) pair a head against q and k, v (kv heads) read
    and o written."""
    pairs = causal_pairs(s) if causal else s * s
    flops = 4 * d * batch * heads * pairs
    nbytes = 2 * batch * (heads + kv) * s * d * BF16
    return least_seconds(flops, nbytes)


def decode_call_seconds(batch: int, kv: int, g: int, hd: int, rows: int,
                        elem: int = BF16) -> float:
    """Least time of one flash_decode call: the K/V rows below each
    session's frontier (``rows`` a session) read once, q read, the output
    and the lengths written, against QK and PV's flops."""
    nbytes = (2 * kv * hd * rows * batch * elem + 2 * batch * kv * g * hd
              * elem + 4 * batch)
    flops = 4 * kv * g * hd * rows * batch
    return least_seconds(flops, nbytes)
