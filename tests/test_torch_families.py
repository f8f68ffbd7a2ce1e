"""The port's six families beyond dense (MoE, RWKV6, Mamba2 hybrid, vision,
audio) against the JAX package, on smoke configs: forward logits and the
MoE aux, the loss and every gradient against ``jax.value_and_grad`` of the
reference's unsharded loss, and the synthetic data's stub embeddings. Bars
and the MoE routing rule: ``_torch_lm``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as RefShape  # noqa: E402
from repro.data.pipeline import SyntheticLMData as RefData  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models import LM  # noqa: E402

from _torch_lm import (DTYPES, NEW_ARCHS, TIE_GAP, all_experts,  # noqa: E402
                       close, flat, hold_bf16, np_batch, pair, port_batch,
                       ref_batch, routing_gaps)

B, S = 2, 16


def _forward(arch, dt, **kw):
    ref, port, rparams, params = pair(arch, dt, **kw)
    nb = np_batch(port.cfg, B, S, seed=3)
    want, want_aux = jax.jit(ref.forward)(rparams, ref_batch(nb, dt))
    with routing_gaps() as gaps:
        got, aux = port.forward(params, port_batch(nb, dt))
    return got, aux, want, want_aux, gaps


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_and_aux_f32(arch):
    got, aux, want, want_aux, gaps = _forward(arch, "f32")
    assert all(g > TIE_GAP for g in gaps), gaps      # no near-tied choice
    assert bool(gaps) == arch.startswith(("granite", "llama4"))
    close(got, want, 1e-4)
    close(aux, want_aux, 1e-4)
    assert got.shape == (B, S, get_config(arch).smoke().padded_vocab)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_bf16(arch):
    kw = all_experts(arch)
    got, aux, want, want_aux, _ = _forward(arch, "bf16", **kw)
    ref, _, rparams, _ = pair(arch, "f32", **kw)
    want32, _ = jax.jit(ref.forward)(
        rparams, ref_batch(np_batch(ref.cfg, B, S, seed=3), "f32"))
    assert got.dtype == torch.bfloat16
    hold_bf16(got, want, want32)
    close(aux, want_aux, DTYPES["bf16"][3])


@pytest.mark.parametrize("arch", ("granite-moe-1b-a400m",
                                  "llama4-maverick-400b-a17b"))
def test_moe_forward_f32_every_expert_routed(arch):
    got, aux, want, want_aux, gaps = _forward(arch, "f32",
                                              **all_experts(arch))
    assert gaps == []
    close(got, want, 1e-4)
    close(aux, want_aux, 1e-4)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_and_every_gradient_f32(arch):
    ref, port, rparams, params = pair(arch, "f32")
    nb = np_batch(port.cfg, B, S, seed=4)
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref.loss))(
        rparams, ref_batch(nb, "f32"))
    names = [n for n, _ in flat(params)]
    leaves = [p.requires_grad_() for _, p in flat(params)]
    with routing_gaps() as gaps:
        loss = port.loss(params, port_batch(nb, "f32"))
    grads = dict(zip(names, torch.autograd.grad(loss, leaves,
                                                allow_unused=True)))
    assert all(g > TIE_GAP for g in gaps), gaps
    close(loss, want_loss, 1e-4)
    want = dict(flat(want_grads))
    assert sorted(want) == sorted(grads)
    for n, g in want.items():
        got = grads[n] if grads[n] is not None else torch.zeros(g.shape)
        close(got, g, 1e-4, msg=n)
    # the MoE aux enters the loss: without it the loss moves
    if port.cfg.num_experts:
        with torch.no_grad():
            base = LM(port.cfg.replace(router_aux_coef=0.0)).loss(
                params, port_batch(nb, "f32"))
            _, aux = port.forward(params, port_batch(nb, "f32"))
        np.testing.assert_allclose(
            loss.item() - base.item(), port.cfg.router_aux_coef * aux.item(),
            rtol=1e-4, atol=1e-7)


def test_zamba2_trains_at_head_dim_80_through_the_kernel(monkeypatch):
    """zamba2's full width has head dim 80. Its smoke config at d = 80 with
    ``use_flash``: every shared-block application in training reaches the
    flash_attention Function once (the hybrid's shared block is not
    remat'd), each call passes both CUDA kernels' launch checks at d = 80
    (here the launch is the plain version, counted), and the loss and every
    gradient match the reference's einsum branch at f32 1e-4 (Sq == Skv, so
    the kernel's top-left mask is the reference's)."""
    import importlib
    fa_mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    ops = importlib.import_module("repro_torch.kernels.flash_attention.ops")
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    def launch(q, k, v, causal, q_off=0):
        fa_mod._check_launch(q, k, v)
        fa_mod._check_launch(*(x.bfloat16() for x in (q, k, v)))
        flash_attention.launches += 1
        return flash_attention_plain(q, k, v, causal=causal, q_off=q_off)
    monkeypatch.setattr(fa_mod, "_launch", launch)
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, causal=True, q_off=0:
                        fa_mod._FlashAttention.apply(q, k, v, causal, q_off))
    monkeypatch.setattr(flash_attention, "launches", 0)
    ref, port, rparams, params = pair("zamba2-2.7b", "f32", head_dim=80)
    port = LM(port.cfg.replace(use_flash=True))
    assert port._impl(S) == "flash" and ref._impl(S) == "einsum"
    nb = np_batch(port.cfg, B, S, seed=9)
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref.loss))(
        rparams, ref_batch(nb, "f32"))
    names = [n for n, _ in flat(params)]
    leaves = [p.requires_grad_() for _, p in flat(params)]
    loss = port.loss(params, port_batch(nb, "f32"))
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    assert flash_attention.launches == port.cfg.num_layers // \
        port.cfg.shared_attn_every
    close(loss, want_loss, 1e-4)
    for n, g in flat(want_grads):
        close(grads[n], g, 1e-4, msg=n)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-small"])
def test_synthetic_data_with_stub_embeddings_is_byte_identical(arch, kind):
    """``SyntheticLMData`` of a vlm or audio model: the reference's tokens
    and its bf16 ``image_embeds`` / ``frames`` byte for byte (none in a
    decode shape)."""
    want = RefData(ref_get_config(arch).smoke(), RefShape("x", 9, 2, kind),
                   seed=3)
    got = SyntheticLMData(get_config(arch).smoke(),
                          ShapeSpec("x", 9, 2, kind), seed=3, device="cpu")
    for step in (0, 5):
        w, g = want.batch(step), got.batch(step)
        assert w.keys() == g.keys()
        assert ("image_embeds" in g or "frames" in g) == (kind != "decode")
        for k in w:
            if g[k].dtype == torch.bfloat16:
                got_bytes = g[k].view(torch.int16).numpy().tobytes()
            else:
                got_bytes = g[k].numpy().astype(np.int32).tobytes()
            assert got_bytes == np.asarray(w[k]).tobytes(), k
