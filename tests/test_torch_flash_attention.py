"""The port's flash_attention against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the reference kernel
runs in Pallas interpret mode, as its own tests run it. Inputs are made with
numpy from a seed and handed to both. Bars: the reference's own (f32 2e-3,
bf16 4e-2, tests/test_kernels.py).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as ref_attention  # noqa: E402
from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention import gqa_attention as ref_gqa  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_ref,  # noqa: E402
                                                 flash_attention,
                                                 flash_attention_plain)

# the wrapper's module (the package exports the function under its name)
FA_MOD = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")


def _qkv(rng, b, h, sq, d, skv=None, hkv=None):
    skv = sq if skv is None else skv
    hkv = h if hkv is None else hkv
    return (rng.normal(size=(b, h, sq, d)).astype("float32"),
            rng.normal(size=(b, hkv, skv, d)).astype("float32"),
            rng.normal(size=(b, hkv, skv, d)).astype("float32"))


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# the shapes of the reference's own kernel test (tests/test_kernels.py)
@pytest.mark.parametrize("b,h,s,d", [(1, 1, 128, 64), (2, 4, 200, 64),
                                     (1, 2, 384, 128), (2, 1, 65, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_kernel(b, h, s, d, causal):
    rng = np.random.default_rng(b * s + d)
    q, k, v = _qkv(rng, b, h, s, d)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal)
    got = flash_attention(*_t(q, k, v), causal=causal)
    _close(got, want, 2e-3)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-3), ("bfloat16", 4e-2)])
def test_flash_attention_dtypes(dtype, tol):
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 1, 2, 130, 64)
    want = ref_flash(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                     causal=True)
    got = flash_attention(*_t(q, k, v, dtype=getattr(torch, dtype)),
                          causal=True)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, tol)


# Sq != Skv, causal included: the kernel's mask is top left (row >= col)
@pytest.mark.parametrize("sq,skv,causal", [(64, 200, False), (64, 200, True),
                                           (8, 20, True), (200, 65, True)])
def test_flash_cross_lengths_match_pallas_kernel(sq, skv, causal):
    rng = np.random.default_rng(sq + skv)
    q, k, v = _qkv(rng, 1, 2, sq, 32, skv=skv)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal)
    got = flash_attention(*_t(q, k, v), causal=causal)
    _close(got, want, 2e-3)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_head_grouping(hq, hkv, causal):
    rng = np.random.default_rng(hq * 10 + hkv)
    q, k, v = _qkv(rng, 2, hq, 96, 32, hkv=hkv)
    want = ref_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal)
    got = flash_attention(*_t(q, k, v), causal=causal)
    _close(got, want, 2e-3)
    # the kernel's plain version reads kv head h // G without repeating
    _close(flash_attention_plain(*_t(q, k, v), causal=causal), want, 2e-3)


@pytest.mark.parametrize("sq,skv,causal", [(40, 40, True), (8, 20, True),
                                           (20, 8, False)])
def test_attention_ref_matches_reference(sq, skv, causal):
    rng = np.random.default_rng(7 * sq + skv)
    q, k, v = _qkv(rng, 2, 3, sq, 16, skv=skv)
    want = ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal)
    _close(attention_ref(*_t(q, k, v), causal=causal), want, 2e-3)


def test_the_two_plain_versions_differ_only_at_causal_cross_lengths():
    """The reference's oracle aligns its causal mask bottom right and its
    kernel top left: at causal Sq != Skv they disagree (a fault of the
    reference, kept as it is). The port keeps both plain versions, each
    equal to its reference counterpart."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 2, 8, 32, skv=20)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_gap = np.abs(np.asarray(ref_attention(jq, jk, jv, causal=True))
                     - np.asarray(ref_flash(jq, jk, jv, causal=True))).max()
    tq, tk, tv = _t(q, k, v)
    gap = (attention_ref(tq, tk, tv) - flash_attention_plain(tq, tk, tv)
           ).abs().max().item()
    assert ref_gap > 0.5 and gap > 0.5
    np.testing.assert_allclose(gap, ref_gap, rtol=1e-3)
    # at Sq == Skv, or without a causal mask, the two are one function
    q2, k2, v2 = _t(*_qkv(rng, 1, 2, 20, 32))
    torch.testing.assert_close(attention_ref(q2, k2, v2),
                               flash_attention_plain(q2, k2, v2))
    torch.testing.assert_close(attention_ref(tq, tk, tv, causal=False),
                               flash_attention_plain(tq, tk, tv,
                                                     causal=False))


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax_grad_of_reference(causal):
    rng = np.random.default_rng(21)
    q, k, v = _qkv(rng, 2, 2, 48, 32)
    w = rng.normal(size=q.shape).astype("float32")

    def ref_loss(q, k, v):
        return jnp.sum(ref_attention(q, k, v, causal=causal) * w)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    (flash_attention(tq, tk, tv, causal=causal)
     * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)


@pytest.fixture
def fake_kernel(monkeypatch):
    """The autograd Function on CPU tensors, its launch replaced by the plain
    version (the CUDA kernel cannot run here) and counted as a launch."""
    def launch(q, k, v, causal):
        flash_attention.launches += 1
        return flash_attention_plain(q, k, v, causal=causal)
    monkeypatch.setattr(FA_MOD, "_launch", launch)
    monkeypatch.setattr(flash_attention, "launches", 0)
    return FA_MOD._FlashAttention.apply


@pytest.mark.parametrize("chunk", [2 ** 28, 1])
def test_function_backward_matches_autograd_of_plain(fake_kernel, chunk,
                                                     monkeypatch):
    # chunk = 1 element forces one kv head per chunk of the backward
    monkeypatch.setattr(FA_MOD, "BACKWARD_CHUNK_ELEMS", chunk)
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 2, 8, 33, 16, skv=33, hkv=2)
    w = torch.from_numpy(rng.normal(size=q.shape).astype("float32"))
    a = [x.requires_grad_() for x in _t(q, k, v)]
    b = [x.requires_grad_() for x in _t(q, k, v)]
    # the model's layout: [B, S, H, d] storage seen through strides
    a_views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in a]
    (fake_kernel(*a_views, True) * w).sum().backward()
    (flash_attention_plain(*b) * w).sum().backward()
    assert flash_attention.launches == 1
    for ga, gb in zip(a, b):
        torch.testing.assert_close(ga.grad, gb.grad, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_never_count_a_launch():
    q, k, v = _t(*_qkv(np.random.default_rng(0), 1, 2, 9, 16))
    before = flash_attention.launches
    flash_attention(q, k, v)
    flash_attention(q, k[:, :1], v[:, :1])       # GQA
    assert flash_attention.launches == before


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "shape", "heads",
                                 "empty", "device", "rank"])
def test_flash_attention_rejects_what_the_kernel_does_not_take(bad):
    rng = np.random.default_rng(4)
    q, k, v = _t(*_qkv(rng, 2, 4, 16, 32))
    if bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "shape":
        v = v[:, :, :-1]
    elif bad == "heads":
        k, v = k[:, :3], v[:, :3]
    elif bad == "empty":
        q = q[:, :, :0]
    elif bad == "device":
        q, k, v = (x.to("meta") for x in (q, k, v))
    elif bad == "rank":
        q = q[0]
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v)


@pytest.mark.parametrize("bad", ["hd", "grid", "misaligned", "last_dim",
                                 "stride"])
def test_kernel_launch_checks_raise_before_building(bad):
    """What only the CUDA kernel refuses is checked before the library is
    built or a pointer is passed (these raise here, with no nvcc)."""
    rng = np.random.default_rng(5)
    d = 16 if bad == "hd" else 32
    q, k, v = _t(*_qkv(rng, 1, 2, 8, d))
    if bad == "grid":                 # B*H past the grid's 65535
        q = torch.zeros(1, 65536, 1, d)
        k = v = torch.zeros(1, 1, 1, d)
    elif bad == "misaligned":         # 4 bytes past a 16-byte boundary
        q = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    elif bad == "last_dim":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "stride":
        big = torch.zeros(1, 2, 8, d + 1)
        q = big[..., :d]              # rows of 33 floats: not 16-byte chunks
    with pytest.raises(ValueError):
        FA_MOD._launch(q, k, v, causal=True)


@pytest.mark.requires_cuda
def test_kernel_on_the_card_matches_plain_version():
    """On the card: the kernel against its plain version (chip_smoke.py
    runs the full set of shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, tol in ((torch.float32, dict(rtol=2e-3, atol=2e-3)),
                       (torch.bfloat16, dict(rtol=1e-2, atol=1e-3))):
        for causal in (True, False):
            q = torch.randn(2, 8, 130, 64, generator=gen, device="cuda")
            k = torch.randn(2, 2, 200, 64, generator=gen, device="cuda")
            v = torch.randn(2, 2, 200, 64, generator=gen, device="cuda")
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            got = flash_attention(q, k, v, causal=causal)
            torch.testing.assert_close(
                got.float(), flash_attention_plain(q, k, v, causal=causal
                                                   ).float(), **tol)

