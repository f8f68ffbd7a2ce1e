"""Serving the port's six families beyond dense against the JAX package:
prefill, then teacher-forced decode (both models get the same next token,
so an argmax flip cannot make them diverge), on smoke configs from the same
parameter arrays. Logits at every step and the caches and recurrent states
at the end. Bars and the MoE routing rule: ``_torch_lm``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm import (NEW_ARCHS, TIE_GAP, all_experts, close,  # noqa: E402
                       f32_caches, flat, hold_bf16, np_batch, pair,
                       port_batch, ref_batch, routing_gaps)

B, PLEN, STEPS = 2, 8, 4


def _serve(ref, port, rparams, params, dt, rcache, cache):
    """Prefill PLEN tokens, then STEPS teacher-forced decode steps on both
    models; returns the reference's and the port's logits a step."""
    nb = np_batch(port.cfg, B, PLEN + STEPS, seed=5)
    toks = nb["tokens"]
    pre = {k: v for k, v in nb.items() if k != "labels"}
    pre["tokens"] = toks[:, :PLEN]
    want, got = [], []
    w, rcache = jax.jit(ref.prefill)(rparams, ref_batch(pre, dt), rcache)
    g, cache = port.prefill(params, port_batch(pre, dt), cache)
    want.append(w)
    got.append(g)
    rdecode = jax.jit(ref.decode_step)
    ttoks = torch.from_numpy(toks).long()
    for i in range(STEPS):
        p = PLEN + i
        w, rcache = rdecode(rparams, {"tokens": jnp.asarray(toks[:, p:p + 1])},
                            rcache, jnp.int32(p))
        g, cache = port.decode_step(params, {"tokens": ttoks[:, p:p + 1]},
                                    cache, p)
        want.append(w)
        got.append(g)
    return want, got, rcache, cache


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_teacher_forced_decode_f32(arch):
    ref, port, rparams, params = pair(arch, "f32")
    rcache, cache = f32_caches(ref, port, B, PLEN + STEPS)
    slots = {n: t.data_ptr() for n, t in flat(cache)}
    with routing_gaps() as gaps:
        want, got, rcache, cache = _serve(ref, port, rparams, params, "f32",
                                          rcache, cache)
    assert all(g > TIE_GAP for g in gaps), gaps
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, 1e-4, msg=f"step {i}")
    want_cache = dict(flat(rcache))
    assert sorted(want_cache) == sorted(slots)
    for n, t in flat(cache):
        close(t, want_cache[n], 1e-4, msg=n)
        assert t.data_ptr() == slots[n], n        # written in place


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_teacher_forced_decode_bf16(arch):
    kw = all_experts(arch)
    ref, port, rparams, params = pair(arch, "bf16", **kw)
    want, got, _, cache = _serve(ref, port, rparams, params, "bf16",
                                 ref.init_cache(B, PLEN + STEPS),
                                 port.init_cache(B, PLEN + STEPS, "cpu"))
    ref32, port32, rparams32, params32 = pair(arch, "f32", **kw)
    want32, _, _, _ = _serve(ref32, port32, rparams32, params32, "f32",
                             *f32_caches(ref32, port32, B, PLEN + STEPS))
    for i, (g, w, w32) in enumerate(zip(got, want, want32)):
        assert g.dtype == torch.bfloat16
        hold_bf16(g, w, w32, what=f"step {i}")
    # recurrent states stay f32 in the cache, the rest in the model's dtype
    for n, t in flat(cache):
        f32 = n.split(".")[-1] in ("wkv", "ssm")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), n


def test_moe_decode_is_held_at_real_routing_in_bf16_where_no_choice_is_close():
    """granite's real top-2 of 4 in bf16: the decode steps whose routing has
    no near tie (gap 1e-2, well past bf16's rounding of the router input)
    meet the bar; the test asserts that most steps are such steps."""
    ref, port, rparams, params = pair("granite-moe-1b-a400m", "bf16")
    with routing_gaps() as gaps:
        want, got, _, _ = _serve(ref, port, rparams, params, "bf16",
                                 ref.init_cache(B, PLEN + STEPS),
                                 port.init_cache(B, PLEN + STEPS, "cpu"))
    layers = port.cfg.num_layers
    clear = [min(gaps[i * layers:(i + 1) * layers]) > 1e-2
             for i in range(STEPS + 1)]
    assert sum(clear) >= 3, gaps
    for i, ok in enumerate(clear):
        if ok:
            close(got[i], want[i], 5e-2, msg=f"step {i}")
