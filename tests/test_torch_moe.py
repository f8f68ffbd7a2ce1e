"""The port's MoE layer and the layers the new families add (the ungated
gelu MLP, cross-attention, the biased layer norm) against the JAX package's
(``src/repro/models/layers.py``), on the same numpy inputs.

``moe_ffn`` is held at its real routing (granite's smoke config: top-2 of 4
experts) at capacity factor 1.25 with tokens dropped past capacity: the
output and aux in f32 at 1e-4, each (token, expert) routing choice where
the k-th and (k+1)-th probabilities lie more than 1e-6 apart (every choice
here), and the set of dropped (token, expert) pairs; and with every expert
routed (k = E, capacity factor 8) in f32 and bf16. bf16 single layers are
held at 2e-2, as tests/test_torch_layers.py holds the dense layers, and the
MoE layer's bf16 output also within two bf16 rounding steps of the
reference's bf16 output (``_torch_lm.hold_bf16_steps``), at every expert
routed and at its real routing.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

from _torch_lm import TIE_GAP, hold_bf16_steps  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
ARCH = "granite-moe-1b-a400m"
B, S = 4, 32


def _cfgs(**kw):
    return (ref_get_config(ARCH).smoke().replace(**kw),
            get_config(ARCH).smoke().replace(**kw))


def _pair(a, dt, keep_f32=False):
    jdt, tdt = (jnp.float32, torch.float32) if keep_f32 else DTYPES[dt][:2]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _moe_inputs(cfg, seed=0):
    """Expert weights at the reference's init scale and a router whose
    columns carry a common offset, so that some experts draw more than
    their capacity."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": rng.normal(size=(d, e)) / np.sqrt(d),
         "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    p = {k: v.astype("float32") for k, v in p.items()}
    x = (rng.normal(size=(B, S, d)) + 0.3).astype("float32")
    return p, x


def _run(dt, **kw):
    rcfg, cfg = _cfgs(**kw)
    p, x = _moe_inputs(cfg)
    jp = {k: _pair(v, dt, keep_f32=k == "router")[0] for k, v in p.items()}
    tp = {k: _pair(v, dt, keep_f32=k == "router")[1] for k, v in p.items()}
    jx, tx = _pair(x, dt)
    want, want_aux = jax.jit(RL.moe_ffn, static_argnums=(2,))(jp, jx, rcfg)
    got, aux = TL.moe_ffn(tp, tx, cfg)
    return cfg, p, x, (got, aux), (want, want_aux)


def _reference_drops(p, x, cfg):
    """The reference's dropped (sequence, token, expert) triples: its
    router's choices (the first lines of its moe_ffn), walked in token
    order, each expert keeping its first ``cap`` pseudo-tokens."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
    _, choice = jax.lax.top_k(probs, cfg.experts_per_token)
    ids = np.asarray(choice).reshape(B, -1)
    k = cfg.experts_per_token
    cap = math.ceil(S * k / cfg.num_experts * cfg.capacity_factor)
    drops = set()
    for b in range(B):
        seen = np.zeros(cfg.num_experts, int)
        for t, e in enumerate(ids[b]):
            if seen[e] >= cap:
                drops.add((b, t // k, int(e)))
            seen[e] += 1
    return drops, np.asarray(choice)


def test_moe_ffn_at_real_routing_matches_reference_and_drops_the_same():
    cfg, p, x, (got, aux), (want, want_aux) = _run("f32")
    _close(got, want, 1e-4)
    _close(aux, want_aux, 1e-4)

    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    gates, choice, _ = TL.moe_route(tp, torch.from_numpy(x), cfg)
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
    top = probs.topk(cfg.experts_per_token + 1, dim=-1).values
    assert (top[..., -2] - top[..., -1]).min() > 1e-6    # no near tie
    want_drops, want_choice = _reference_drops(p, x, cfg)
    np.testing.assert_array_equal(choice.numpy(), want_choice)
    cap = TL.moe_capacity(cfg, S)
    ids = choice.reshape(B, -1)
    rank = TL.moe_dispatch(ids, cfg.num_experts)[3]
    k = cfg.experts_per_token
    got_drops = {(b, t // k, int(ids[b, t])) for b, t in
                 zip(*torch.nonzero(rank >= cap, as_tuple=True))
                 for b, t in [(int(b), int(t))]}
    assert cap == 20 and len(want_drops) > 0
    assert got_drops == want_drops


@pytest.mark.parametrize("dt", list(DTYPES))
def test_moe_ffn_with_every_expert_routed(dt):
    _, _, _, (got, aux), (want, want_aux) = _run(
        dt, experts_per_token=4, capacity_factor=8.0)
    assert got.dtype == DTYPES[dt][1]
    _close(got, want, max(DTYPES[dt][2], 1e-4))
    _close(aux, want_aux, 1e-4)
    if dt == "bf16":
        hold_bf16_steps(got, want)


def test_moe_ffn_in_bf16_at_real_routing():
    """granite's top-2 of 4 in bf16, tokens dropped past capacity: both
    routers take the same bf16 inputs to f32, so the port chooses the
    reference's experts where no choice is near a tie, and its output lies
    within two bf16 rounding steps of the reference's bf16 output."""
    cfg, p, x, (got, aux), (want, want_aux) = _run("bf16")
    x16 = torch.from_numpy(x).bfloat16()
    probs = torch.softmax(x16.float() @ torch.from_numpy(p["router"]), -1)
    top = probs.topk(cfg.experts_per_token + 1, dim=-1).values
    assert (top[..., -2] - top[..., -1]).min() > TIE_GAP
    _, choice, _ = TL.moe_route({"router": torch.from_numpy(p["router"])},
                                x16, cfg)
    want_drops, want_choice = _reference_drops(p, x16.float().numpy(), cfg)
    np.testing.assert_array_equal(choice.numpy(), want_choice)
    assert len(want_drops) > 0
    assert got.dtype == torch.bfloat16
    _close(aux, want_aux, 1e-4)
    hold_bf16_steps(got, want)


def test_moe_ffn_gradients_match_reference():
    """d(sum(out * c) + aux)/d(x, every weight) at the real routing."""
    rcfg, cfg = _cfgs()
    p, x = _moe_inputs(cfg)
    c = np.random.default_rng(1).normal(size=x.shape).astype("float32")

    def scalar(p, x):
        y, aux = RL.moe_ffn(p, x, rcfg)
        return jnp.sum(y * c) + aux
    want = jax.grad(scalar, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TL.moe_ffn(tp, tx, cfg)
    names = list(tp)
    grads = torch.autograd.grad((y * torch.from_numpy(c)).sum() + aux,
                                [tp[n] for n in names] + [tx])
    for n, g in zip(names, grads):
        _close(g, want[0][n], 1e-4, msg=n)
    _close(grads[-1], want[1], 1e-4, msg="x")


def test_moe_dispatch_keeps_each_experts_earliest_tokens():
    # one sequence, k = 1: expert 1 is chosen by tokens 0, 2, 3, 5
    ids = torch.tensor([[1, 0, 1, 1, 2, 1]])
    order, counts, starts, rank = TL.moe_dispatch(ids, 3)
    assert counts.tolist() == [[1, 4, 1]]
    assert starts.tolist() == [[0, 1, 5]]
    assert rank.tolist() == [[0, 0, 1, 2, 0, 3]]
    assert order.tolist() == [[1, 0, 2, 3, 5, 4]]


def test_moe_decode_step_runs_every_expert_at_capacity_one():
    """S = 1: capacity ceil(k / E * 1.25) = 1, so no token is dropped and
    the dense [B, E, 1, D] dispatch reads every expert's weights."""
    _, cfg = _cfgs()
    assert TL.moe_capacity(cfg, 1) == 1
    p, x = _moe_inputs(cfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _, choice, _ = TL.moe_route(tp, torch.from_numpy(x[:, :1]), cfg)
    rank = TL.moe_dispatch(choice.reshape(B, -1), cfg.num_experts)[3]
    assert (rank == 0).all()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_gelu_mlp_layer_norm_and_cross_attention(dt):
    """whisper's blocks: the ungated MLP (gelu, tanh approximation), the
    biased layer norm and cross-attention into a memory (no rope on
    either side) against the reference's."""
    rcfg = ref_get_config("whisper-small").smoke()
    cfg = get_config("whisper-small").smoke()
    tol = DTYPES[dt][2]
    rng = np.random.default_rng(3)
    b, s, t, d, f = 2, 5, 9, cfg.d_model, cfg.d_ff
    x = (2.0 * rng.normal(size=(b, s, d))).astype("float32")
    mem = rng.normal(size=(b, t, d)).astype("float32")
    jx, tx = _pair(x, dt)
    m = {"w_up": rng.normal(size=(d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(f, d)) / np.sqrt(f)}
    jm = {k: _pair(v.astype("float32"), dt)[0] for k, v in m.items()}
    tm = {k: _pair(v.astype("float32"), dt)[1] for k, v in m.items()}
    _close(TL.mlp(tm, tx), RL.mlp(jm, jx), tol)

    scale, bias = (rng.normal(size=(d,)).astype("float32") for _ in range(2))
    _close(TL.layer_norm(tx, _pair(scale, dt)[1], _pair(bias, dt)[1], 1e-5),
           RL.layer_norm(jx, _pair(scale, dt)[0], _pair(bias, dt)[0], 1e-5),
           tol)

    hd, hq, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    a = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
         "wo": (hq * hd, d)}
    a = {k: (rng.normal(size=v) / np.sqrt(v[0])).astype("float32")
         for k, v in a.items()}
    ja = {k: _pair(v, dt)[0] for k, v in a.items()}
    ta = {k: _pair(v, dt)[1] for k, v in a.items()}
    pos = np.arange(s)[None].repeat(b, 0).astype("int32")
    jmem, tmem = _pair(mem, dt)
    want, _ = jax.jit(RL.attention, static_argnums=(2,),
                      static_argnames=("causal",))(
        ja, jx, rcfg, positions=jnp.asarray(pos), causal=False, memory=jmem)
    got, cache = TL.attention(ta, tx, cfg, positions=torch.from_numpy(pos),
                              causal=False, memory=tmem)
    assert cache is None
    _close(got, want, tol)
    # no rope: positions do not move a cross-attention output
    got2, _ = TL.attention(ta, tx, cfg, positions=torch.from_numpy(pos + 7),
                           causal=False, memory=tmem)
    assert torch.equal(got, got2)
    with pytest.raises(ValueError, match="no cache"):
        TL.attention(ta, tx, cfg, positions=torch.from_numpy(pos),
                     memory=tmem, cache={"k": None, "v": None}, cache_pos=0)
