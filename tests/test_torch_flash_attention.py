"""The port's flash_attention against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the reference kernel
runs in Pallas interpret mode, as its own tests run it. Inputs are made with
numpy from a seed and handed to both. Bars: the reference's own (f32 2e-3,
bf16 4e-2, tests/test_kernels.py); the CUDA kernels' arithmetic, emulated
tile by tile, is held to the kernel bars of ``chip_smoke.py`` (bf16 rtol
1e-2 / atol 1e-3, f32 2e-5).
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import attention_ref as ref_attention  # noqa: E402
from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention import gqa_attention as ref_gqa  # noqa: E402
from repro_torch import trace  # noqa: E402
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


# head dim 16 (the smoke configs'): causal and not, GQA, odd S, S != Skv
@pytest.mark.parametrize("b,h,hkv,sq,skv", [(1, 4, 4, 127, 127),
                                            (2, 4, 2, 129, 129),
                                            (1, 8, 1, 65, 65),
                                            (1, 2, 2, 1, 1),
                                            (1, 4, 2, 64, 200)])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_16_matches_pallas_kernel(b, h, hkv, sq, skv, causal):
    rng = np.random.default_rng(b * sq + h + hkv + skv)
    q, k, v = _qkv(rng, b, h, sq, 16, skv=skv, hkv=hkv)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = (ref_flash(jq, jk, jv, causal=causal) if h == hkv
            else ref_gqa(jq, jk, jv, causal=causal))
    got = flash_attention(*_t(q, k, v), causal=causal)
    _close(got, want, 2e-3)
    FA_MOD._check_launch(*_t(q, k, v))             # the kernels take d = 16
    FA_MOD._check_launch(*_t(q, k, v, dtype=torch.bfloat16))


# head dims that are no power of two (zamba2's 80 among them): the kernels
# take every multiple of 16 up to 128, the plain version any d
@pytest.mark.parametrize("d", [48, 80, 112])
@pytest.mark.parametrize("hkv,causal", [(4, True), (4, False), (2, True)])
def test_new_head_dims_match_pallas_kernel(d, hkv, causal):
    rng = np.random.default_rng(d + hkv)
    q, k, v = _qkv(rng, 2, 4, 130, d, hkv=hkv)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = (ref_flash(jq, jk, jv, causal=causal) if hkv == 4
            else ref_gqa(jq, jk, jv, causal=causal))
    tq, tk, tv = _t(q, k, v)
    _close(flash_attention_plain(tq, tk, tv, causal=causal), want, 2e-3)
    _close(flash_attention(tq, tk, tv, causal=causal), want, 2e-3)
    FA_MOD._check_launch(tq, tk, tv)
    FA_MOD._check_launch(*_t(q, k, v, dtype=torch.bfloat16))


def test_head_dims_are_the_multiples_of_16_up_to_128():
    assert FA_MOD.HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
    for d in (8, 24, 40, 144, 256):
        q = torch.zeros(1, 2, 8, d)
        with pytest.raises(ValueError, match="head dims"):
            FA_MOD._check_launch(q, q, q)


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
    def launch(q, k, v, causal, q_off=0):
        flash_attention.launches += 1
        return flash_attention_plain(q, k, v, causal=causal, q_off=q_off)
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
    (fake_kernel(*a_views, True, 0) * w).sum().backward()
    (flash_attention_plain(*b) * w).sum().backward()
    assert flash_attention.launches == 1
    for ga, gb in zip(a, b):
        torch.testing.assert_close(ga.grad, gb.grad, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_never_count_a_launch():
    q, k, v = _t(*_qkv(np.random.default_rng(0), 1, 2, 9, 16))
    before = (flash_attention.launches, flash_attention.bf16_launches,
              flash_attention.tf32_launches)
    flash_attention(q, k, v)
    flash_attention(q, k[:, :1], v[:, :1])       # GQA
    flash_attention(*(x.bfloat16() for x in (q, k, v)))
    assert (flash_attention.launches, flash_attention.bf16_launches,
            flash_attention.tf32_launches) == before


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
                                 "stride", "grid_bf16", "tma_stride",
                                 "stride_bf16", "grid_x", "tma_stride_f32",
                                 "tma_dim"])
def test_kernel_launch_checks_raise_before_building(bad):
    """What only the CUDA kernels refuse is checked before the library is
    built or a pointer is passed (these raise here, with no nvcc)."""
    rng = np.random.default_rng(5)
    d = 144 if bad == "hd" else 32     # 144: past the kernels' 128
    q, k, v = _t(*_qkv(rng, 1, 2, 8, d))
    if bad == "grid":                 # f32: q tiles of 128 past y's 65535
        q = torch.zeros(1, 1, 1, d).expand(1, 1, 65535 * 128 + 1, d)
        k = v = torch.zeros(1, 1, 1, d)
    elif bad == "grid_x":             # f32: B*H past x's 2^31 - 1
        q = torch.zeros(1, 1, 1, d).expand(1, 2 ** 31, 1, d)
        k = v = torch.zeros(1, 1, 1, d)
    elif bad == "tma_stride_f32":     # f32: a byte stride of 2^40
        q = torch.zeros(1, 2, 8, d).as_strided((1, 2, 8, d),
                                               (2 ** 38, 8 * d, d, 1))
    elif bad == "tma_dim":            # f32: a dim past a tensor map's 2^32
        k = v = torch.zeros(1, 1, 1, d).expand(1, 1, 2 ** 32 + 1, d)
    elif bad == "grid_bf16":          # bf16: q tiles of 128 past y's 65535
        q = torch.zeros(1, 1, 1, d, dtype=torch.bfloat16).expand(
            1, 1, 65535 * 128 + 1, d)
        k = v = torch.zeros(1, 1, 1, d, dtype=torch.bfloat16)
    elif bad == "tma_stride":         # bf16: a byte stride of 2^40
        q = torch.zeros(1, 2, 8, d, dtype=torch.bfloat16).as_strided(
            (1, 2, 8, d), (2 ** 39, 8 * d, d, 1))
        k, v = (x.bfloat16() for x in (k, v))
    elif bad == "stride_bf16":        # rows of 36 bf16: not 16-byte chunks
        q = torch.zeros(1, 2, 8, d + 4, dtype=torch.bfloat16)[..., :d]
        k, v = (x.bfloat16() for x in (k, v))
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
    # the bf16 kernel past one 128-row tile, in the model's strided layout
    q, k, v = (torch.randn(2, 257, heads, 128, generator=gen, device="cuda")
               .bfloat16().transpose(1, 2) for heads in (8, 2, 2))
    bf16 = flash_attention.bf16_launches
    got = flash_attention(q, k, v, causal=True)
    assert flash_attention.bf16_launches == bf16 + 1
    torch.testing.assert_close(got.float(),
                               flash_attention_plain(q, k, v).float(),
                               rtol=1e-2, atol=1e-3)



@pytest.mark.parametrize("hd", FA_MOD.HEAD_DIMS)
def test_bf16_route_takes_head_counts_past_the_f32_grid(hd):
    """Both kernels put B*H on the grid's x axis (2^31 - 1): a head count
    past the y axis's 65535, where the CUDA-core f32 kernel had B*H, passes
    the checks of both routes."""
    q = torch.zeros(1, 65536, 1, hd, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 1, 1, hd, dtype=torch.bfloat16)
    FA_MOD._check_launch(q, k, v)
    FA_MOD._check_launch(q.float(), k.float(), v.float())


class _FakeLib:
    """Stands in for the built library: records which entry was called."""

    def __init__(self, rc=0):
        self.calls, self.rc, self.args = [], rc, {}

    def _entry(self, name, dims=4):
        def fn(*args):
            # B, H, KV, Sq, Skv, d, causal after the entry's pointers
            self.calls.append((name, args[dims:dims + 7]))
            self.args[name] = args
            return self.rc
        return fn

    @property
    def flash_attention_bf16_launch(self):
        return self._entry("bf16")

    @property
    def flash_attention_tf32_launch(self):
        return self._entry("tf32")

    @property
    def flash_attention_bf16_lse_launch(self):
        return self._entry("bf16_lse", 6)

    @property
    def flash_attention_bf16_bwd_launch(self):
        return self._entry("bwd", 11)


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(FA_MOD, "_kernel_lib", lambda: lib)
    monkeypatch.setattr(FA_MOD, "_stream", lambda device: 0)
    for name in ("launches", "bf16_launches", "tf32_launches",
                 "bwd_launches"):
        monkeypatch.setattr(flash_attention, name, 0)
    return lib


def test_dispatch_bf16_and_f32_to_their_tensor_core_kernels(fake_lib):
    """bf16 reaches the bf16 entry, f32 the 3xTF32 entry, and each counts
    its launch by route and in all."""
    q, k, v = _t(*_qkv(np.random.default_rng(6), 2, 4, 16, 64, hkv=2))
    FA_MOD._launch(*(x.bfloat16() for x in (q, k, v)), causal=True)
    assert fake_lib.calls == [("bf16", (2, 4, 2, 16, 16, 64, 1))]
    assert (flash_attention.launches, flash_attention.bf16_launches,
            flash_attention.tf32_launches) == (1, 1, 0)
    FA_MOD._launch(q, k, v, causal=False)
    assert fake_lib.calls[1] == ("tf32", (2, 4, 2, 16, 16, 64, 0))
    assert (flash_attention.launches, flash_attention.bf16_launches,
            flash_attention.tf32_launches) == (2, 1, 1)


@pytest.mark.parametrize("d", [48, 80, 96, 112])
@pytest.mark.parametrize("dtype,entry", [("bfloat16", "bf16"),
                                         ("float32", "tf32")])
def test_new_head_dims_reach_their_kernel_unpadded(fake_lib, dtype, entry,
                                                   d):
    """The model's [B, S, H, d] views go to the kernel as they are: no
    padded copy, the head dim passed through."""
    x = torch.zeros(2, 300, 8, d, dtype=getattr(torch, dtype))
    q, k, v = (x.transpose(1, 2), x[:, :, :2].transpose(1, 2),
               x[:, :, 2:4].transpose(1, 2))
    out = FA_MOD._launch(q, k, v, causal=True)
    assert fake_lib.calls == [(entry, (2, 8, 2, 300, 300, d, 1))]
    assert out.shape == q.shape and out.stride() == q.stride()


@pytest.mark.parametrize("dtype,entry", [("bfloat16", "bf16"),
                                         ("float32", "tf32")])
def test_head_dim_16_reaches_its_kernel(fake_lib, dtype, entry):
    q, k, v = _t(*_qkv(np.random.default_rng(9), 1, 4, 129, 16, hkv=2),
                 dtype=getattr(torch, dtype))
    FA_MOD._launch(q, k, v, causal=True)
    assert fake_lib.calls == [(entry, (1, 4, 2, 129, 129, 16, 1))]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rc,match", [(-1, "cuTensorMapEncodeTiled"),
                                      (-1001, "CUresult 1"),
                                      (98, "CUDA error 98")])
def test_failed_launch_raises_and_counts_nothing(fake_lib, rc, match, dtype):
    fake_lib.rc = rc
    q, k, v = _t(*_qkv(np.random.default_rng(7), 1, 2, 8, 32),
                 dtype=getattr(torch, dtype))
    with pytest.raises(RuntimeError, match=match):
        FA_MOD._launch(q, k, v, causal=True)
    assert (flash_attention.launches, flash_attention.bf16_launches,
            flash_attention.tf32_launches) == (0, 0, 0)


# the port's bar for a kernel against its plain version in bf16
# (chip_smoke.py's KERNEL_TOL)
BF16_KERNEL_TOL = dict(rtol=1e-2, atol=1e-3)


def _emulate_bf16_kernel(q, k, v, *, causal, split_p, tile=128):
    """The bf16 kernel's arithmetic, tile by tile, on the CPU: bf16 inputs;
    f32 scores scaled in log2 units; f32 running max, sum and accumulator
    over 128 x 128 tiles; P fed to P.V as two bf16 halves, hi = bf16(p) and
    lo = bf16(p - hi) (``split_p``), or rounded once to bf16."""
    b, h, sq, d = q.shape
    skv, g = k.shape[2], h // k.shape[1]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(g, 1) for x in (k, v))
    c = math.log2(math.e) / math.sqrt(d)
    out = torch.empty(b, h, sq, d)
    n_kv = -(-skv // tile)
    for q0 in range(0, sq, tile):
        qt = qf[:, :, q0:q0 + tile]
        rows = torch.arange(q0, q0 + qt.shape[2])
        m = torch.full(qt.shape[:3], -1e30)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for k0 in range(0, tile * (min(n_kv, q0 // tile + 1) if causal
                                   else n_kv), tile):
            kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
            s = (qt @ kt.transpose(-1, -2)) * c
            if causal:
                cols = torch.arange(k0, k0 + kt.shape[2])
                s = s.masked_fill(rows[:, None] < cols[None, :], -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            hi = p.bfloat16().float()
            pv = hi @ vt
            if split_p:
                pv = pv + (p - hi).bfloat16().float() @ vt
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, :, q0:q0 + tile] = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.bfloat16()


def test_bf16_kernel_design_needs_p_split_into_two_halves():
    """Why the bf16 kernel feeds P to P.V as hi + lo: at S = 1024, d = 128,
    causal, P rounded once to bf16 misses the port's bar against the plain
    version (where a few large p*v terms cancel), and the two halves keep
    within it."""
    rng = np.random.default_rng(0)
    q, k, v = _t(*_qkv(rng, 1, 4, 1024, 128), dtype=torch.bfloat16)
    want = flash_attention_plain(q, k, v, causal=True).float()
    split = _emulate_bf16_kernel(q, k, v, causal=True, split_p=True)
    torch.testing.assert_close(split.float(), want, **BF16_KERNEL_TOL)
    once = _emulate_bf16_kernel(q, k, v, causal=True, split_p=False)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(once.float(), want, **BF16_KERNEL_TOL)


@pytest.mark.parametrize("sq,skv,causal,hkv", [(1, 1, True, 2),
                                               (129, 129, True, 1),
                                               (127, 255, False, 2),
                                               (255, 128, True, 2)])
def test_bf16_kernel_emulation_matches_plain_version_at_tile_edges(
        sq, skv, causal, hkv):
    """The tile-by-tile emulation (ragged last tiles, skipped causal tiles,
    GQA) computes the plain version's function within the kernel bar."""
    rng = np.random.default_rng(sq + skv)
    q, k, v = _t(*_qkv(rng, 1, 2, sq, 64, skv=skv, hkv=hkv),
                 dtype=torch.bfloat16)
    got = _emulate_bf16_kernel(q, k, v, causal=causal, split_p=True)
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q, k, v, causal=causal).float(),
        **BF16_KERNEL_TOL)


@pytest.mark.parametrize("s", [1, 127, 128, 129])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_emulation_at_head_dim_16(s, causal):
    """At d = 16 the bf16 kernel's Q K^T is one k16 step and its P V one
    n16 product; its tile-by-tile arithmetic (P as hi + lo) stays within the
    kernel bar of the plain version at the 128-row tile's edges."""
    rng = np.random.default_rng(s + 16)
    q, k, v = _t(*_qkv(rng, 2, 4, s, 16, hkv=2), dtype=torch.bfloat16)
    got = _emulate_bf16_kernel(q, k, v, causal=causal, split_p=True)
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q, k, v, causal=causal).float(),
        **BF16_KERNEL_TOL)


@pytest.mark.parametrize("d", [48, 80, 112])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_kernel_emulation_at_the_new_head_dims(d, causal):
    """At d = 48, 80, 112 the bf16 kernel runs d / 16 k16 steps of Q K^T
    and one n = d product of P V a 16-key step; its tile-by-tile arithmetic
    (P as hi + lo) stays within the kernel bar of the plain version past
    one 128-row tile, GQA included."""
    rng = np.random.default_rng(d)
    q, k, v = _t(*_qkv(rng, 1, 4, 257, d, hkv=2), dtype=torch.bfloat16)
    got = _emulate_bf16_kernel(q, k, v, causal=causal, split_p=True)
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q, k, v, causal=causal).float(),
        **BF16_KERNEL_TOL)


# the f32 kernel's own bar against its plain version and the Pallas kernel:
# 3xTF32 is f32's function to within f32's rounding (~1e-6 here), 1xTF32
# misses it by two orders (the reference's 2e-3 passes both)
F32_KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)


def _tf32(x):
    """x truncated to tf32 (sign, exponent, top 10 bits of mantissa): what
    the tensor cores read of an f32 operand."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _tf32_product(a, b, passes):
    """a @ b as the f32 kernel's tensor cores take it: with passes = 3,
    lo.hi + hi.lo + hi.hi of hi = tf32(x), lo = tf32(x - hi) (3xTF32); with
    passes = 1, hi.hi alone (1xTF32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if passes == 1:
        return a_hi @ b_hi
    return _tf32(a - a_hi) @ b_hi + a_hi @ _tf32(b - b_hi) + a_hi @ b_hi


def _emulate_f32_kernel(q, k, v, *, causal, q_off=0, passes=3):
    """The f32 kernel's arithmetic, tile by tile, on the CPU: 128 query rows
    by 64 keys; key tiles up to the causal frontier of the q tile's last
    row (q's row r is key row q_off + r), ragged last tiles; f32 scores
    scaled in log2 units by the kernel's f32 constant; f32 running max, sum
    and accumulator; both products through ``_tf32_product``."""
    b, h, sq, d = q.shape
    skv, g = k.shape[2], h // k.shape[1]
    kf, vf = (x.repeat_interleave(g, 1) for x in (k, v))
    c = float(np.float32(1.0 / d ** 0.5) * np.float32(1.4426950408889634))
    out = torch.empty(b, h, sq, d)
    n_kv = -(-skv // 64)
    for q0 in range(0, sq, 128):
        qt = q[:, :, q0:q0 + 128]
        rows = q_off + torch.arange(q0, q0 + qt.shape[2])
        n_tiles = min(n_kv, int(rows[-1]) // 64 + 1) if causal else n_kv
        m = torch.full(qt.shape[:3], -1e30)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for k0 in range(0, 64 * n_tiles, 64):
            kt, vt = kf[:, :, k0:k0 + 64], vf[:, :, k0:k0 + 64]
            s = _tf32_product(qt, kt.transpose(-1, -2), passes) * c
            if causal:
                cols = torch.arange(k0, k0 + kt.shape[2])
                s = s.masked_fill(rows[:, None] < cols[None, :], -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _tf32_product(p, vt, passes)
            m = m_new
        out[:, :, q0:q0 + 128] = acc / torch.where(l == 0, 1.0,
                                                   l)[..., None]
    return out


def _pallas(q, k, v, causal):
    """The reference's Pallas kernel in interpret mode (GQA through its
    wrapper, which repeats K and V)."""
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if q.shape[1] == k.shape[1]:
        return np.asarray(ref_flash(jq, jk, jv, causal=causal))
    return np.asarray(ref_gqa(jq, jk, jv, causal=causal))


# the f32 kernel's tile edges (64 keys, 128 query rows), Sq != Skv, GQA and
# every kind of head dim: 16 (64-byte swizzle), 32, 64, 96, 128 (128-byte),
# 48, 80, 112 (32-byte boxes of one k8 step)
@pytest.mark.parametrize("b,h,hkv,sq,skv,d", [
    (1, 2, 2, 1, 1, 64), (1, 2, 2, 63, 63, 16), (2, 2, 1, 65, 65, 32),
    (1, 4, 2, 129, 129, 48), (1, 4, 1, 127, 255, 80), (1, 2, 2, 255, 128, 96),
    (1, 2, 2, 200, 64, 112), (1, 4, 2, 257, 257, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_kernel_emulation_matches_pallas_kernel(b, h, hkv, sq, skv, d,
                                                    causal):
    """The f32 kernel's tile-by-tile 3xTF32 arithmetic stays within 2e-5 of
    the Pallas kernel in interpret mode and of the plain version."""
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = _qkv(rng, b, h, sq, d, skv=skv, hkv=hkv)
    tq, tk, tv = _t(q, k, v)
    got = _emulate_f32_kernel(tq, tk, tv, causal=causal)
    _close(got, _pallas(q, k, v, causal), F32_KERNEL_TOL["atol"])
    torch.testing.assert_close(
        got, flash_attention_plain(tq, tk, tv, causal=causal),
        **F32_KERNEL_TOL)


@pytest.mark.parametrize("q_off,rows,d", [(37, 100, 64), (64, 136, 80),
                                          (128, 72, 16), (150, 50, 128)])
def test_f32_kernel_emulation_with_a_row_offset(q_off, rows, d):
    """With ``q_off`` (a rank's slice of a sequence's rows), the emulation
    on rows q_off to q_off + rows equals those rows of the Pallas kernel on
    the whole sequence (causal), within 2e-5, and the plain version's."""
    rng = np.random.default_rng(q_off + d)
    q, k, v = _qkv(rng, 1, 4, 200, d, hkv=2)
    want = _pallas(q, k, v, True)[:, :, q_off:q_off + rows]
    tq, tk, tv = _t(q[:, :, q_off:q_off + rows], k, v)
    got = _emulate_f32_kernel(tq, tk, tv, causal=True, q_off=q_off)
    _close(got, want, F32_KERNEL_TOL["atol"])
    torch.testing.assert_close(
        got, flash_attention_plain(tq, tk, tv, causal=True, q_off=q_off),
        **F32_KERNEL_TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_1xtf32_misses_the_f32_kernel_bar(d):
    """Why the f32 kernel takes three tf32 products where one would do for
    the reference's 2e-3: hi.hi alone (1xTF32) passes 2e-3 and misses the
    2e-5 bar against the Pallas kernel, which 3xTF32 meets."""
    rng = np.random.default_rng(d)
    q, k, v = _qkv(rng, 1, 2, 512, d)
    want = _pallas(q, k, v, True)
    tq, tk, tv = _t(q, k, v)
    one = _emulate_f32_kernel(tq, tk, tv, causal=True, passes=1)
    _close(one, want, 2e-3)
    with pytest.raises(AssertionError):
        _close(one, want, F32_KERNEL_TOL["atol"])
    _close(_emulate_f32_kernel(tq, tk, tv, causal=True), want,
           F32_KERNEL_TOL["atol"])


# ---------------------------------------------------------------------------
# the bf16 backward kernels (csrc/flash_attention_bwd.cu)


def _halves(x, split):
    """x as the tensor cores take it: two bf16 halves, hi = bf16(x) and lo =
    bf16(x - hi) (``split``), or rounded once."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def _o_as_saved(o, low_part):
    """The f32 output as the backward reads it: bf16(o), plus with
    ``low_part`` its low half, bf16(o - bf16(o))."""
    return sum(_halves(o, low_part))


def _saved_by_forward(q, k, v, *, causal, q_off):
    """What the bf16 forward's training launch computes for the backward:
    the f32 output and the row log-sum-exp in log2 units of the scaled
    scores, m + log2(sum exp2(x - m))."""
    g = q.shape[1] // k.shape[1]
    c = math.log2(math.e) / math.sqrt(q.shape[-1])
    x = (q.float() @ k.float().repeat_interleave(g, 1).transpose(-1, -2)) * c
    if causal:
        rows = q_off + torch.arange(q.shape[2])[:, None]
        x = x.masked_fill(rows < torch.arange(k.shape[2])[None, :], -1e30)
    m = x.amax(-1)
    lse = m + torch.log2(torch.exp2(x - m[..., None]).sum(-1))
    o = flash_attention_plain(*(t.float() for t in (q, k, v)), causal=causal,
                              q_off=q_off)
    return o, lse


def _emulate_bf16_backward(q, k, v, do, *, causal, q_off=0, split_p=True,
                           split_ds=True, low_part=True):
    """The backward kernels' arithmetic, tile by tile, on the CPU: D =
    rowsum(dO o O) in f32, O as saved (``_o_as_saved``: with its low half,
    else rounded once to bf16);
    P = exp2(S c - lse) on f32 scores, masked on the tiles that cross the
    causal frontier, Sq or Skv; dS = P o (dP - D). dQ: 128 query rows a
    block, key tiles of 64 up to the frontier of its last row, acc += dS K.
    dK, dV: 128 keys a block, each query head of the group and its query
    tiles of 64 from the first that sees the block's first key, acc += dS^T
    Q and P^T dO. P (dV) and dS (dQ, dK) enter the products as bf16 halves
    (``split_p``, ``split_ds``) or rounded once; gradients stored in
    bf16."""
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1 / math.sqrt(d)
    c = scale * math.log2(math.e)
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o, lse = _saved_by_forward(q, k, v, causal=causal, q_off=q_off)
    D = (dof * _o_as_saved(o, low_part)).sum(-1)

    def p_ds(rows, cols, qt, kt, vt, dot, lse_t, d_t):
        keep = (cols[None, :] < skv) & (rows[:, None] < sq)
        if causal:
            keep &= q_off + rows[:, None] >= cols[None, :]
        p = torch.where(keep, torch.exp2(qt @ kt.transpose(-1, -2) * c
                                         - lse_t[..., None]), 0.0)
        return p, p * (dot @ vt.transpose(-1, -2) - d_t[..., None])

    dq = torch.empty(b, h, sq, d)
    for r0 in range(0, sq, 128):
        rows = torch.arange(r0, min(r0 + 128, sq))
        n_cols = -(-skv // 64)
        if causal:
            n_cols = min(n_cols, (q_off + int(rows[-1])) // 64 + 1)
        acc = torch.zeros(b, h, len(rows), d)
        for c0 in range(0, 64 * n_cols, 64):
            cols = torch.arange(c0, min(c0 + 64, skv))
            kt, vt = (x[:, :, cols].repeat_interleave(g, 1) for x in (kf, vf))
            _, ds = p_ds(rows, cols, qf[:, :, rows], kt, vt, dof[:, :, rows],
                         lse[:, :, rows], D[:, :, rows])
            acc += sum(part @ kt for part in _halves(ds, split_ds))
        dq[:, :, rows] = acc * scale
    dk, dv = torch.empty(b, kvh, skv, d), torch.empty(b, kvh, skv, d)
    for r0 in range(0, skv, 128):
        cols = torch.arange(r0, min(r0 + 128, skv))
        first = max(0, r0 - q_off) // 64 * 64 if causal else 0
        acc_k, acc_v = torch.zeros(b, kvh, len(cols), d), torch.zeros(
            b, kvh, len(cols), d)
        for j in range(g):
            heads = torch.arange(kvh) * g + j
            for c0 in range(first, sq, 64):
                rows = torch.arange(c0, min(c0 + 64, sq))
                qt, dot = (x[:, heads][:, :, rows] for x in (qf, dof))
                p, ds = p_ds(rows, cols, qt, kf[:, :, cols], vf[:, :, cols],
                             dot, lse[:, heads][:, :, rows],
                             D[:, heads][:, :, rows])
                acc_v += sum(part @ dot for part in
                             _halves(p.transpose(-1, -2), split_p))
                acc_k += sum(part @ qt for part in
                             _halves(ds.transpose(-1, -2), split_ds))
        dk[:, :, cols], dv[:, :, cols] = acc_k * scale, acc_v
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _bf16_grad_inputs(seed, b, h, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    q, k, v = _qkv(rng, b, h, sq, d, skv=skv, hkv=hkv)
    do = rng.normal(size=q.shape).astype("float32")
    return _t(q, k, v, do, dtype=torch.bfloat16)


def _plain_grads(q, k, v, do, *, causal, q_off=0):
    """Autograd of the plain version in f32 on the bf16 inputs."""
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    out = flash_attention_plain(*leaves, causal=causal, q_off=q_off)
    return torch.autograd.grad(out, leaves, do.float())


def _within_bar(got, want):
    return all(torch.allclose(a.float(), w, **BF16_KERNEL_TOL)
               for a, w in zip(got, want))


# every kind of head dim (16, 64: 64- and 128-byte swizzles; 80: 32-byte
# boxes; 128: two boxes a row), causal or not, G 1 and 2, Sq not a multiple
# of 128, Sq != Skv, a query-row offset
@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,q_off", [
    (2, 4, 2, 129, 129, 16, True, 0),
    (1, 4, 2, 300, 300, 64, True, 0),
    (1, 2, 2, 130, 70, 64, False, 0),
    (1, 2, 2, 257, 513, 80, False, 0),
    (1, 4, 2, 200, 700, 128, True, 350),
    (1, 2, 1, 100, 200, 80, True, 37),
    (1, 2, 2, 255, 128, 16, True, 0)])
def test_bf16_backward_emulation_matches_autograd_of_plain(b, h, hkv, sq,
                                                          skv, d, causal,
                                                          q_off):
    """The backward kernels' tile-by-tile arithmetic (P and dS as hi + lo,
    D from O with its low half) gives dq, dk and dv within the port's
    bf16 bar of autograd of the plain version in f32."""
    q, k, v, do = _bf16_grad_inputs(sq + skv + d, b, h, hkv, sq, skv, d)
    got = _emulate_bf16_backward(q, k, v, do, causal=causal, q_off=q_off)
    want = _plain_grads(q, k, v, do, causal=causal, q_off=q_off)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape, name
        torch.testing.assert_close(a.float(), w, **BF16_KERNEL_TOL,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("single", ["p", "ds", "o"])
def test_bf16_backward_design_needs_each_split(single):
    """Why the backward takes P and dS as two bf16 halves and D from the
    output with its low half: at S = 1024, d = 128, causal, rounding P once
    (dV), dS once (dQ, dK) or taking D from the bf16 output alone misses the
    port's bar against autograd of the plain version, which the design
    meets."""
    q, k, v, do = _bf16_grad_inputs(0, 1, 4, 4, 1024, 1024, 128)
    want = _plain_grads(q, k, v, do, causal=True)
    assert _within_bar(_emulate_bf16_backward(q, k, v, do, causal=True),
                       want)
    once = _emulate_bf16_backward(q, k, v, do, causal=True,
                                  split_p=single != "p",
                                  split_ds=single != "ds",
                                  low_part=single != "o")
    assert not _within_bar(once, want)


def _model_layout(d=64, s=300, dtype=torch.bfloat16):
    """q, k, v as the model passes them: [B, S, H, d] storage seen as [B, H,
    S, d] through strides (8 query heads, 2 kv heads)."""
    x = torch.zeros(2, s, 8, d, dtype=dtype)
    return (x.transpose(1, 2), x[:, :, :2].transpose(1, 2),
            x[:, :, 2:4].transpose(1, 2))


def test_training_launch_saves_lse_and_the_low_half(fake_lib):
    """bf16 training reaches the forward's lse entry: the output keeps q's
    layout, the log-sum-exp and the output's low half cover every row of
    every 128-row tile, and the launch counts as a bf16 forward."""
    q, k, v = _model_layout()
    out, o_lo, lse = FA_MOD._launch(q, k, v, True, 3, for_backward=True)
    assert fake_lib.calls == [("bf16_lse", (2, 8, 2, 300, 300, 64, 1))]
    assert fake_lib.args["bf16_lse"][13] == 3                   # q_off
    assert out.stride() == q.stride()
    assert o_lo.shape == (2, 8, 384, 64) and o_lo.dtype == torch.bfloat16
    assert lse.shape == (2, 8, 384) and lse.dtype == torch.float32
    assert (flash_attention.launches, flash_attention.bf16_launches,
            flash_attention.tf32_launches) == (1, 1, 0)


def test_backward_launch_takes_each_tensor_in_one_span(fake_lib):
    """The backward entry gets the shapes, the offset and every tensor's
    strides; a gradient a tensor map cannot read (autograd's expanded
    gradient of a sum) goes as a contiguous copy; one call records one
    ``attention.backward`` span and counts one backward launch."""
    q, k, v = _model_layout(d=80)
    out, o_lo, lse = FA_MOD._launch(q, k, v, True, 0, for_backward=True)
    do = torch.ones((), dtype=torch.bfloat16).expand(q.shape)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        dq, dk, dv = FA_MOD._kernel_backward(q, k, v, out, o_lo, lse, do,
                                             True, 5)
    assert fake_lib.calls[-1] == ("bwd", (2, 8, 2, 300, 300, 80, 1))
    args = fake_lib.args["bwd"]
    assert args[18] == 5                                         # q_off
    strides = list(args[-2])
    assert strides[:12] == [*q.stride()[:3], *k.stride()[:3],
                            *v.stride()[:3], *out.stride()[:3]]
    assert strides[12:15] == [8 * 300 * 80, 300 * 80, 80]       # dO copied
    assert strides[15:] == [*dq.stride()[:3], *dk.stride()[:3],
                            *dv.stride()[:3]]
    assert dq.stride() == q.stride()               # the model's layout kept
    assert flash_attention.bwd_launches == 1
    spans = [e for e in prof.events() if e.name == "attention.backward"]
    assert len(spans) == 1


def test_backward_launch_failure_raises(fake_lib):
    q, k, v = _model_layout(d=16)
    out, o_lo, lse = FA_MOD._launch(q, k, v, True, 0, for_backward=True)
    fake_lib.rc = 98
    with pytest.raises(RuntimeError, match="backward failed with CUDA error"):
        FA_MOD._kernel_backward(q, k, v, out, o_lo, lse, out, True, 0)
    assert flash_attention.bwd_launches == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_backward_and_count_it(fake_kernel,
                                                          dtype):
    """The backward is chosen by device and dtype: CPU tensors (of either
    dtype) never reach the kernels; under counting each call counts one
    plain backward."""
    q, k, v = (x.to(dtype).requires_grad_() for x in _t(*_qkv(
        np.random.default_rng(3), 1, 4, 20, 16, hkv=2)))
    with trace.counting():
        fake_kernel(q, k, v, True, 0).float().sum().backward()
        assert trace.counters() == {"attention.backward_plain": 1}
    assert flash_attention.bwd_launches == 0
    assert q.grad is not None and k.grad.shape == k.shape


def test_backward_grid_limits_raise_before_launching():
    q = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16).expand(
        1, 1, 65535 * 128 + 1, 64)
    with pytest.raises(ValueError, match="backward kernels' grid"):
        FA_MOD._check_backward(q, k)
    FA_MOD._check_backward(q, k[:, :, :65535 * 128])
