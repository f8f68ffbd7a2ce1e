"""Shared set-up of the port's LM family tests: the JAX package's model and
the port's, on the same parameter arrays (``params_from_reference``) and the
same numpy inputs.

Bars: f32 at rtol = atol = 1e-4 (the same arithmetic in another summation
order); bf16 at the reference's own 5e-2 (tests/test_models.py). MoE routing
is discrete, so an f32 comparison holds only where every routing choice is
clear: ``routing_gaps`` records the gap between each token's k-th and
(k+1)-th expert probability in the port's forward, and the tests require it
above ``TIE_GAP``. In bf16 the two frameworks round activations at different
places, which flips near-ties, so MoE models are held there with every
expert routed (``all_experts``: k = E at capacity factor 8), as the
reference's own prefill/decode test does.

One block in bf16 is held directly to the reference's bf16 output on the
same inputs (``hold_bf16_steps``): within two bf16 rounding steps at the
output's largest magnitude, ``tests/test_torch_ssm.py`` and
``tests/test_torch_moe.py``. The readings there are at most one step for
the RWKV6 and Mamba2 outputs, 1.1 for the f32 Mamba2 state (it is built
from bf16 inputs) and 1.5 for the MoE layer at its real routing.

bf16 through a whole model grows rounding over depth, differently in each
framework: on the smoke configs the reference's own bf16 logits lie up to
0.33 (rwkv6), 0.22 (zamba2) and 0.04-0.06 (the others) from its f32
logits, so a 5e-2 bar between the two frameworks' bf16 logits is at or
below the noise. ``hold_bf16`` holds a whole model's bf16 output to the
reference's f32 output (which the port meets at 1e-4 in f32) within
max(5e-2, twice the reference's own bf16 error there).
"""

import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro_torch.configs import get_config
from repro_torch.models import LM
from repro_torch.models.convert import params_from_reference

# the six archs of the families beyond dense
NEW_ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b", "rwkv6-7b",
             "zamba2-2.7b", "llama-3.2-vision-11b", "whisper-small")
# numpy, reference and port dtypes, and the bar
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, 1e-4),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 5e-2)}
TIE_GAP = 1e-6
LAYERS = importlib.import_module("repro_torch.models.layers")


def all_experts(arch):
    """Overrides of the smoke config's MoE layer: every expert routed, no
    drops (none for other families)."""
    cfg = get_config(arch).smoke()
    if not cfg.num_experts:
        return {}
    return dict(experts_per_token=cfg.num_experts, capacity_factor=8.0)


def pair(arch, dt, **kw):
    """(reference LM, port LM, reference params, port params): the smoke
    config with ``kw``, the reference's seed-0 weights cast to dt."""
    rcfg = ref_get_config(arch).smoke().replace(**kw)
    cfg = get_config(arch).smoke().replace(**kw)
    jdt = DTYPES[dt][1]
    rparams = jax.tree.map(
        lambda a: np.asarray(a) if a.dtype == jnp.float32 and dt == "bf16"
        else np.asarray(a.astype(jdt)),
        RefLM(rcfg).init(jax.random.PRNGKey(0)))
    return RefLM(rcfg), LM(cfg), rparams, params_from_reference(rparams,
                                                                "cpu")


def np_batch(cfg, b, s, seed):
    """Tokens, labels and the family's stub inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s + 1)).astype("int32")
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (b, cfg.num_image_tokens, cfg.d_model)).astype("float32")
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (b, 1500, cfg.d_model)).astype("float32")
    return out


def ref_batch(nb, dt):
    return {k: jnp.asarray(v) if v.dtype == np.int32
            else jnp.asarray(v).astype(DTYPES[dt][1]) for k, v in nb.items()}


def port_batch(nb, dt):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v).to(DTYPES[dt][2]) for k, v in nb.items()}


def flat(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{pre}{k}.")
        else:
            yield f"{pre}{k}", v


def close(got, want, tol, msg=""):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32),
        rtol=tol, atol=tol, err_msg=msg)


def f32_caches(ref, port, b, t):
    """Both models' caches for (b, t), every leaf in f32, so that an f32
    comparison sees no bf16 cache rounding."""
    rc = jax.tree.map(lambda a: a.astype(jnp.float32), ref.init_cache(b, t))
    pc = port.init_cache(b, t, "cpu")
    return rc, tree_map(lambda x: x.float(), pc)


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def hold_bf16(got, want16, want32, what=""):
    """The whole-model bf16 bar (module docstring)."""
    w32 = np.asarray(want32, np.float32)
    ref_err = np.abs(np.asarray(want16, np.float32) - w32).max()
    err = np.abs(got.detach().float().numpy() - w32).max()
    assert err <= max(DTYPES["bf16"][3], 2 * ref_err), (what, err, ref_err)


def bf16_steps(got, want):
    """The largest difference of got from want, in bf16 rounding steps at
    want's largest magnitude (2^-7 of the power of two at or below it)."""
    w = np.asarray(want, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    return np.abs(got.detach().float().numpy() - w).max() / step


def hold_bf16_steps(got, want, what="", steps=2):
    """One block's bf16 bar (module docstring): within ``steps`` bf16
    rounding steps of the reference's bf16 output."""
    n = bf16_steps(got, want)
    assert n <= steps, (what, n)


@contextlib.contextmanager
def routing_gaps():
    """Record, for every MoE routing of the port while inside, the least gap
    between a token's k-th and (k+1)-th expert probability (k < E)."""
    gaps = []
    route = LAYERS.moe_route

    def recording(p, x, cfg):
        e, k = cfg.num_experts, cfg.experts_per_token
        if k < e:
            with torch.no_grad():
                probs = torch.softmax(x.float() @ p["router"], dim=-1)
                top = probs.topk(k + 1, dim=-1).values
                gaps.append((top[..., k - 1] - top[..., k]).min().item())
        return route(p, x, cfg)
    LAYERS.moe_route = recording
    try:
        yield gaps
    finally:
        LAYERS.moe_route = route
