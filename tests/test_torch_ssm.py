"""The port's RWKV6 and Mamba2 mixers against the JAX package's
(``src/repro/models/ssm.py``), on the same numpy inputs: the chunked
recurrences at chunk 8 and chunk 1 (the stepwise form) on
tests/test_models.py's inputs, a ragged length (t = 21 at chunk 8) and a
carried-in state, their gradients, and one whole block in training, prefill
and decode form in f32 (1e-4) and bf16 (``_torch_lm.hold_bf16_steps``:
within two bf16 rounding steps of the reference's bf16 output, at the
output's largest magnitude; one bf16 block lies 0.13 from f32 in both
frameworks, but at most 1.1 steps from the other framework's bf16).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

from _torch_lm import hold_bf16_steps  # noqa: E402

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _rwkv_inputs(t, state):
    """tests/test_models.py:126-142's draws, at length t."""
    rng = np.random.default_rng(0)
    b, nh, hd = 2, 2, 8
    r, k, v = (rng.normal(size=(b, t, nh, hd)).astype("float32")
               for _ in range(3))
    w_log = -rng.uniform(0.05, 1.5, size=(b, t, nh, hd)).astype("float32")
    u = rng.normal(size=(nh, hd)).astype("float32")
    s0 = (rng.normal(size=(b, nh, hd, hd)) if state else
          np.zeros((b, nh, hd, hd))).astype("float32")
    return r, k, v, w_log, u, s0


def _mamba_inputs(t, state):
    """tests/test_models.py:145-157's draws, at length t."""
    rng = np.random.default_rng(1)
    b, nh, hd, st = 2, 2, 8, 4
    xh = rng.normal(size=(b, t, nh, hd)).astype("float32")
    B = rng.normal(size=(b, t, st)).astype("float32")
    C = rng.normal(size=(b, t, st)).astype("float32")
    log_a = -rng.uniform(0.05, 1.0, size=(b, t, nh)).astype("float32")
    s0 = (rng.normal(size=(b, nh, hd, st)) if state else
          np.zeros((b, nh, hd, st))).astype("float32")
    return xh, B, C, log_a, s0


CASES = [(24, 8, False), (24, 1, False), (21, 8, False), (21, 8, True),
         (5, 8, True), (1, 8, True)]


@pytest.mark.parametrize("t,chunk,state", CASES)
@pytest.mark.parametrize("mixer", ["rwkv", "mamba"])
def test_chunked_recurrence_matches_reference(mixer, t, chunk, state):
    if mixer == "rwkv":
        args = _rwkv_inputs(t, state)
        ref, port = RS.rwkv_wkv_chunked, TS.rwkv_wkv_chunked
    else:
        args = _mamba_inputs(t, state)
        ref, port = RS.mamba_ssd_chunked, TS.mamba_ssd_chunked
    want_out, want_st = ref(*map(jnp.asarray, args), chunk=chunk)
    got_out, got_st = port(*map(torch.from_numpy, args), chunk=chunk)
    assert got_out.shape == want_out.shape and got_st.dtype == torch.float32
    _close(got_out, want_out, 1e-4)
    _close(got_st, want_st, 1e-4)


@pytest.mark.parametrize("mixer", ["rwkv", "mamba"])
def test_chunked_equals_stepwise_on_the_port(mixer):
    """The reference's own invariant (tests/test_models.py:126-157) on the
    port: chunk 8 equals the per-token recurrence, at a ragged length too."""
    for t in (24, 21):
        if mixer == "rwkv":
            args = [torch.from_numpy(a) for a in _rwkv_inputs(t, True)]
            fn = TS.rwkv_wkv_chunked
        else:
            args = [torch.from_numpy(a) for a in _mamba_inputs(t, True)]
            fn = TS.mamba_ssd_chunked
        (oc, sc), (o1, s1) = fn(*args, chunk=8), fn(*args, chunk=1)
        torch.testing.assert_close(oc, o1, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(sc, s1, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mixer", ["rwkv", "mamba"])
def test_chunked_recurrence_gradients_match_reference(mixer):
    """Gradients of every input (decays included) at a ragged length."""
    if mixer == "rwkv":
        args = _rwkv_inputs(21, True)
        ref, port = RS.rwkv_wkv_chunked, TS.rwkv_wkv_chunked
    else:
        args = _mamba_inputs(21, True)
        ref, port = RS.mamba_ssd_chunked, TS.mamba_ssd_chunked
    rng = np.random.default_rng(2)
    outs = ref(*map(jnp.asarray, args), chunk=8)
    cot = [rng.normal(size=o.shape).astype("float32") for o in outs]

    def scalar(*a):
        o, s = ref(*a, chunk=8)
        return jnp.sum(o * cot[0]) + jnp.sum(s * cot[1])
    want = jax.grad(scalar, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    o, s = port(*targs, chunk=8)
    total = (o * torch.from_numpy(cot[0])).sum() + \
        (s * torch.from_numpy(cot[1])).sum()
    got = torch.autograd.grad(total, targs)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 1e-4, msg=f"input {i}")


def _block_params(defs_fn, cfg, seed):
    """One layer's params: each leaf its default plus 0.1 x N(0, 1), so the
    token-shift mixes and biases are not trivial; numpy f32."""
    rng = np.random.default_rng(seed)
    rcfg = ref_get_config(cfg.name.removesuffix("-smoke")).smoke()
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed),
                                                  defs_fn(rcfg, 1)))
    return jax.tree.map(
        lambda a: (a[0].astype(np.float32)
                   + 0.1 * rng.normal(size=a.shape[1:])).astype("float32"),
        params)


# (arch, block, mode): training (no state), prefill (t=5 from a carried
# state) and decode (t=1)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_block_matches_reference(arch, dt, mode):
    cfg = get_config(arch).smoke()
    rcfg = ref_get_config(arch).smoke()
    rwkv = cfg.family == "ssm"
    ref_block = RS.rwkv_block if rwkv else RS.mamba_block
    port_block = TS.rwkv_block if rwkv else TS.mamba_block
    p = _block_params(RS.rwkv_defs if rwkv else RS.mamba_defs, cfg, 7)
    rng = np.random.default_rng(8)
    b, t = 2, (1 if mode == "decode" else 5 if mode == "prefill" else 12)
    x = rng.normal(size=(b, t, cfg.d_model)).astype("float32")
    state = None
    if mode != "train":
        sdefs = (RS.rwkv_state_defs if rwkv else RS.mamba_state_defs)(
            rcfg, b, 1)
        state = jax.tree.map(
            lambda d: rng.normal(size=d.shape[1:]).astype("float32"), sdefs,
            is_leaf=lambda d: hasattr(d, "shape") and hasattr(d, "axes"))
    f32_leaves = ("wkv", "ssm")

    def jx(tree, dt):        # params and x in dt; f32 states stay f32
        return {k: jx(v, dt) if isinstance(v, dict) else jnp.asarray(
            v).astype(jnp.float32 if k in f32_leaves else JDT[dt])
            for k, v in tree.items()}

    def tx(tree):
        return {k: tx(v) if isinstance(v, dict) else torch.from_numpy(v).to(
            torch.float32 if k in f32_leaves else TDT[dt])
            for k, v in tree.items()}

    want, wst = jax.jit(lambda p, x, s: ref_block(p, x, rcfg, state=s))(
        jx(p, dt), jnp.asarray(x).astype(JDT[dt]),
        None if state is None else jx(state, dt))
    got, gst = port_block(tx(p), torch.from_numpy(x).to(TDT[dt]), cfg,
                          state=None if state is None else tx(state))
    assert got.dtype == TDT[dt]
    assert (gst is None) == (wst is None)
    outs = [("out", got, want)] + [(n, gst[n], wst[n]) for n in wst or ()]
    for n, g, w in outs:
        assert g.dtype == (torch.float32 if n in f32_leaves else TDT[dt]), n
        if dt == "f32":
            _close(g, w, 1e-4, msg=n)
        else:
            hold_bf16_steps(g, w, what=n)
