"""The port's layers against the JAX package's, on the same numpy inputs.

f32 at 1e-5 (the same arithmetic in another summation order) and bf16 at
2e-2 (the two frameworks round bf16 at different places).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

# jitted once per shape: the reference's eager ops would each compile apart
ref_attention = jax.jit(RL.attention, static_argnums=(2,),
                        static_argnames=("cache_pos",))

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a, dt):
    """The same numpy array as a reference and as a port tensor of dtype dt."""
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(got, want, dt):
    tol = DTYPES[dt][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rms_norm(dt):
    rng = np.random.default_rng(0)
    x = (3.0 * rng.normal(size=(2, 5, 64))).astype("float32")
    scale = (1.0 + 0.5 * rng.normal(size=(64,))).astype("float32")
    (jx, tx), (js, ts) = _pair(x, dt), _pair(scale, dt)
    _close(TL.rms_norm(tx, ts, 1e-5), RL.rms_norm(jx, js, 1e-5), dt)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_rope_half_split_at_cache_offset(dt):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 4, 16)).astype("float32")
    pos = (7 + np.arange(5))[None].repeat(2, 0).astype("int32")
    jx, tx = _pair(x, dt)
    _close(TL.rope(tx, torch.from_numpy(pos), 500_000.0),
           RL.rope(jx, jnp.asarray(pos), 500_000.0), dt)


def _attn_params(rng, cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    shapes = {"wq": (d, hq * hd), "wk": (d, hkv * hd), "wv": (d, hkv * hd),
              "wo": (hq * hd, d)}
    return {n: (rng.normal(size=s) / np.sqrt(s[0])).astype("float32")
            for n, s in shapes.items()}


# (query length, cache position): a prefill, a chunk after it, a decode step
@pytest.mark.parametrize("s,cache_pos", [(5, 0), (3, 4), (1, 9)])
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_cache_attention(dt, use_flash, s, cache_pos):
    cfg_kw = dict(num_kv_heads=2, use_flash=use_flash)
    cfg = get_config("llama3-8b").smoke().replace(**cfg_kw)
    rcfg = ref_get_config("llama3-8b").smoke().replace(**cfg_kw)
    rng = np.random.default_rng(10 * s + cache_pos)
    b, smax, hd = 2, 12, cfg.resolved_head_dim
    p = _attn_params(rng, cfg)
    x = rng.normal(size=(b, s, cfg.d_model)).astype("float32")
    # stale values past the frontier must be masked out
    ck = rng.normal(size=(b, cfg.num_kv_heads, smax, hd)).astype("float32")
    cv = rng.normal(size=(b, cfg.num_kv_heads, smax, hd)).astype("float32")
    pos = (cache_pos + np.arange(s))[None].repeat(b, 0).astype("int32")

    jp = {n: _pair(w, dt)[0] for n, w in p.items()}
    tp = {n: _pair(w, dt)[1] for n, w in p.items()}
    (jx, tx), (jk, tk), (jv, tv) = _pair(x, dt), _pair(ck, dt), _pair(cv, dt)
    want, wcache = ref_attention(jp, jx, rcfg, positions=jnp.asarray(pos),
                                 cache={"k": jk, "v": jv}, cache_pos=cache_pos)
    got, gcache = TL.attention(tp, tx, cfg, positions=torch.from_numpy(pos),
                               cache={"k": tk, "v": tv}, cache_pos=cache_pos)
    _close(got, want, dt)
    _close(gcache["k"], wcache["k"], dt)
    _close(gcache["v"], wcache["v"], dt)
    assert gcache["k"] is tk                 # updated in place


@pytest.mark.parametrize("dt", list(DTYPES))
def test_no_cache_attention_and_mlp(dt):
    cfg = get_config("llama3-8b").smoke().replace(num_kv_heads=2)
    rcfg = ref_get_config("llama3-8b").smoke().replace(num_kv_heads=2)
    rng = np.random.default_rng(5)
    b, s, d = 2, 7, cfg.d_model
    p = _attn_params(rng, cfg)
    x = rng.normal(size=(b, s, d)).astype("float32")
    pos = np.arange(s)[None].repeat(b, 0).astype("int32")
    jp = {n: _pair(w, dt)[0] for n, w in p.items()}
    tp = {n: _pair(w, dt)[1] for n, w in p.items()}
    jx, tx = _pair(x, dt)
    want, _ = ref_attention(jp, jx, rcfg, positions=jnp.asarray(pos))
    got, cache = TL.attention(tp, tx, cfg, positions=torch.from_numpy(pos))
    assert cache is None
    _close(got, want, dt)

    f = cfg.d_ff
    m = {"w_up": rng.normal(size=(d, f)) / np.sqrt(d),
         "w_gate": rng.normal(size=(d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(f, d)) / np.sqrt(f)}
    jm = {n: _pair(w.astype("float32"), dt)[0] for n, w in m.items()}
    tm = {n: _pair(w.astype("float32"), dt)[1] for n, w in m.items()}
    _close(TL.mlp(tm, tx), RL.mlp(jm, jx), dt)


@pytest.mark.parametrize("impl", ["flash", "blockwise"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_no_cache_attention_impls(dt, impl):
    """blockwise (plain torch) and flash (the kernel's plain version on the
    CPU) against the reference's, whose flash runs the Pallas kernel in
    interpret mode. S = 600 spans two 512-row blocks with a ragged edge."""
    cfg = get_config("llama3-8b").smoke().replace(num_kv_heads=2)
    rcfg = ref_get_config("llama3-8b").smoke().replace(num_kv_heads=2)
    rng = np.random.default_rng(6)
    b, s = 1, 600 if impl == "blockwise" else 70
    p = _attn_params(rng, cfg)
    x = rng.normal(size=(b, s, cfg.d_model)).astype("float32")
    pos = np.arange(s)[None].repeat(b, 0).astype("int32")
    jp = {n: _pair(w, dt)[0] for n, w in p.items()}
    tp = {n: _pair(w, dt)[1] for n, w in p.items()}
    jx, tx = _pair(x, dt)
    want, _ = jax.jit(RL.attention, static_argnums=(2,),
                      static_argnames=("impl",))(
        jp, jx, rcfg, positions=jnp.asarray(pos), impl=impl)
    got, cache = TL.attention(tp, tx, cfg, positions=torch.from_numpy(pos),
                              impl=impl)
    assert cache is None
    _close(got, want, dt)
