"""The port's ``gqa_attention`` against the JAX package's.

The reference's wrapper runs its Pallas kernel in interpret mode, as its own
tests run it; the port's takes the kernel's plain version for CPU tensors.
Inputs come from numpy with a seed. Bar: the reference's f32 2e-3
(tests/test_kernels.py).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import gqa_attention as ref_gqa  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa_pkg  # noqa: E402
from repro_torch.kernels.flash_attention import gqa_attention  # noqa: E402
from repro_torch.models import LM  # noqa: E402

OPS = importlib.import_module("repro_torch.kernels.flash_attention.ops")


def _qkv(rng, b, hq, hkv, s, d):
    return (rng.normal(size=(b, hq, s, d)).astype("float32"),
            rng.normal(size=(b, hkv, s, d)).astype("float32"),
            rng.normal(size=(b, hkv, s, d)).astype("float32"))


@pytest.mark.parametrize("d", [32, 80])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_gqa_attention_matches_reference(d, g, causal, use_kernel):
    rng = np.random.default_rng(d * 10 + g)
    q, k, v = _qkv(rng, 2, 2 * g, 2, 40, d)
    want = ref_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, use_kernel=use_kernel)
    got = gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_gqa_attention_is_exported_and_rejects_ragged_groups():
    assert fa_pkg.gqa_attention is gqa_attention
    q, k, v = (torch.zeros(1, h, 4, 16) for h in (6, 4, 4))
    with pytest.raises(ValueError, match="multiple"):
        gqa_attention(q, k, v)


def test_kernel_path_makes_no_repeated_kv_copy(monkeypatch):
    """With ``use_kernel`` the kernel's wrapper gets K and V as given (it
    reads kv head h // G itself); the plain path repeats them."""
    seen = []
    monkeypatch.setattr(OPS, "flash_attention",
                        lambda q, k, v, causal, q_off=0: seen.append(
                            (k.shape[1], k.data_ptr())) or q)
    q, k, v = torch.zeros(1, 8, 4, 16), torch.ones(1, 2, 4, 16), \
        torch.ones(1, 2, 4, 16)
    gqa_attention(q, k, v)
    assert seen == [(2, k.data_ptr())]


def test_model_flash_branch_goes_through_gqa_attention(monkeypatch):
    """The model's "flash" attention (the no-cache training path) calls
    ``gqa_attention`` once a self-attention layer, with the model's
    [B, S, H, d] activations seen as [B, H, S, d]."""
    layers = importlib.import_module("repro_torch.models.layers")
    calls = []

    def spy(q, k, v, causal=True, q_off=0):
        calls.append((tuple(q.shape), tuple(k.shape), q.stride(1) < q.stride(2)))
        return gqa_attention(q, k, v, causal=causal, q_off=q_off)
    monkeypatch.setattr(layers, "gqa_attention", spy)
    cfg = get_config("llama3-8b").smoke().replace(use_flash=True)
    model = LM(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros(2, 24, dtype=torch.long)
    model.forward(params, {"tokens": tokens})
    hd = cfg.resolved_head_dim
    assert calls == [((2, cfg.num_heads, 24, hd),
                      (2, cfg.num_kv_heads, 24, hd), True)] * cfg.num_layers
