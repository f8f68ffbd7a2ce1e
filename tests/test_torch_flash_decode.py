"""The port's flash_decode against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the reference kernel
runs in Pallas interpret mode, as its own tests run it. Inputs are made with
numpy from a seed and handed to both.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_decode import flash_decode as ref_flash_decode  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels.flash_decode import (decode_attention,  # noqa: E402
                                              flash_decode, flash_decode_ref)


def _inputs(rng, b, kv, g, t, hd, lens):
    q = rng.normal(size=(b, kv, g, hd)).astype("float32")
    k = rng.normal(size=(b, kv, t, hd)).astype("float32")
    v = rng.normal(size=(b, kv, t, hd)).astype("float32")
    return q, k, v, np.asarray(lens, np.int32)


# the shapes of the reference's own kernel test (tests/test_kernels.py)
@pytest.mark.parametrize("b,kv,g,t,hd,bk", [
    (2, 4, 2, 300, 64, 128), (1, 8, 4, 512, 128, 256),
    (3, 2, 1, 100, 32, 64), (1, 1, 8, 70, 64, 128)])
def test_flash_decode_f32_matches_reference(b, kv, g, t, hd, bk):
    rng = np.random.default_rng(b * t + hd)
    q, k, v, lens = _inputs(rng, b, kv, g, t, hd,
                            rng.integers(1, t, size=(b,)))
    want = ref_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens), bk=bk)
    got = flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(lens), bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-3, atol=2e-3)


def test_flash_decode_bf16_matches_reference():
    rng = np.random.default_rng(1)
    q, k, v, lens = _inputs(rng, 2, 2, 4, 200, 64, [150, 37])
    want = ref_flash_decode(*(jnp.asarray(a).astype(jnp.bfloat16)
                              for a in (q, k, v)), jnp.asarray(lens))
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = flash_decode(*bf, torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=4e-2, atol=4e-2)


def test_decode_attention_kernel_and_plain_agree():
    rng = np.random.default_rng(3)
    q, k, v, lens = (torch.from_numpy(a) for a in
                     _inputs(rng, 2, 2, 2, 64, 32, [64, 9]))
    torch.testing.assert_close(decode_attention(q, k, v, lens),
                               decode_attention(q, k, v, lens,
                                                use_kernel=False))
    torch.testing.assert_close(flash_decode_ref(q, k, v, lens),
                               decode_attention(q, k, v, lens))


@pytest.mark.parametrize("bad", ["hd", "dtype", "lengths", "shape", "bk",
                                 "contiguous", "device"])
def test_flash_decode_rejects_what_the_kernel_does_not_take(bad):
    rng = np.random.default_rng(4)
    hd = 12 if bad == "hd" else 16
    q, k, v, lens = (torch.from_numpy(a) for a in
                     _inputs(rng, 2, 2, 2, 40, hd, [40, 3]))
    kw = {}
    if bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "lengths":
        lens = lens.long()
    elif bad == "shape":
        v = v[:, :, :-1]
    elif bad == "bk":
        kw["bk"] = 0
    elif bad == "contiguous":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "device":
        q, k, v, lens = (x.to("meta") for x in (q, k, v, lens))
    with pytest.raises((ValueError, TypeError)):
        flash_decode(q, k, v, lens, **kw)


def test_cuda_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_is_keyed_by_source_hash(monkeypatch, tmp_path):
    import shutil

    from repro_torch.kernels import _build
    assert _build.kernel_names() == ["flash_attention", "flash_decode",
                                     "maxplus", "sim", "stencil"]
    path = _build.lib_path("flash_decode")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libflash_decode-") and path.suffix == ".so"
    # an edit to the source names a new library, so it rebuilds
    shutil.copytree(_build.KERNELS_DIR / "flash_decode" / "csrc",
                    tmp_path / "flash_decode" / "csrc")
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    assert _build.lib_path("flash_decode") == path
    with open(tmp_path / "flash_decode" / "csrc" / "flash_decode.cu", "a") as f:
        f.write("// edited\n")
    assert _build.lib_path("flash_decode") != path
    # without nvcc the build raises instead of falling back
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


# ---------------------------------------------------------------------------
# the split over the cache (flash-decoding) and its combine

FD_MOD = importlib.import_module("repro_torch.kernels.flash_decode.flash_decode")
SMS = 132                                  # an H100's SMs
# chip_smoke.py's bar for the kernel against its plain version
KERNEL_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
              torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}


def _emulate_split(q, k, v, lens, n_split, bk):
    """The kernel's split and combine rule, in numpy (f64): split y of
    sequence b takes rows [y c, (y + 1) c) of [0, len_b), c = ceil(len_b /
    n_split) rounded up to whole tiles of bk rows; each split's partial
    (m, l, acc) is kept in log2 units, an empty split's is (-inf, 0, 0); the
    combine weighs each partial 2^(m - M) (0 when empty) and keeps a row
    whose every partial is empty at 0. Returns the output and the number of
    empty (b, kv, split) partials."""
    b, kv, g, hd = q.shape
    t = k.shape[2]
    c = np.log2(np.e) / np.sqrt(hd)
    out = np.zeros(q.shape)
    empty = 0
    for bi in range(b):
        ln = min(int(lens[bi]), t)
        per = -(-ln // n_split)
        chunk = -(-per // bk) * bk
        for h in range(kv):
            parts = []
            for y in range(n_split):
                c0 = min(ln, y * chunk)
                c1 = min(ln, c0 + chunk)
                if c1 == c0:
                    parts.append((np.full(g, -np.inf), np.zeros(g),
                                  np.zeros((g, hd))))
                    empty += 1
                    continue
                s = q[bi, h].astype(np.float64) @ k[bi, h, c0:c1].T * c
                m = s.max(axis=1)
                p = np.exp2(s - m[:, None])
                parts.append((m, p.sum(axis=1), p @ v[bi, h, c0:c1]))
            ms = np.stack([pt[0] for pt in parts])       # [n_split, g]
            big = ms.max(axis=0)
            with np.errstate(invalid="ignore"):
                w = np.where(np.isneginf(ms), 0.0, np.exp2(ms - big))
            el = (w * np.stack([pt[1] for pt in parts])).sum(axis=0)
            acc = (w[..., None] * np.stack([pt[2] for pt in parts])).sum(0)
            out[bi, h] = acc / np.where(el == 0, 1.0, el)[:, None]
    return out, empty


@pytest.mark.parametrize("b,kv,g,t,hd,bk", [
    (2, 4, 2, 300, 64, 128), (1, 8, 4, 512, 128, 256),
    (3, 2, 1, 100, 32, 64), (1, 1, 8, 70, 64, 128),
    (4, 8, 4, 160, 128, 32)])
@pytest.mark.parametrize("how", ["plan", "one", "many", "one_row"])
def test_split_and_combine_rule_matches_pallas_kernel(b, kv, g, t, hd, bk,
                                                      how):
    """The split rule, at the plan's n_split, unsplit, at more splits than
    the shortest sequence has tiles (whole splits past its length), and at
    one-row chunks, held to the Pallas kernel in interpret mode (f32, the
    reference's 2e-3; the Pallas kernel at the reference test's bk, the
    split rule at the wrapper's 32-row tiles). The serve shape (T = 160)
    runs at lengths 144."""
    rng = np.random.default_rng(b * t + hd + len(how))
    lens = ([144] * b if t == 160 else rng.integers(1, t, size=(b,)))
    q, k, v, lens = _inputs(rng, b, kv, g, t, hd, lens)
    tile = 1 if how == "one_row" else 32       # the wrapper's default bk
    n_split = {"plan": FD_MOD.plan(b, kv, g, t, hd, 4, tile, SMS).n_split,
               "one": 1, "many": -(-t // 8), "one_row": t}[how]
    got, empty = _emulate_split(q, k, v, lens, n_split, tile)
    want = np.asarray(ref_flash_decode(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lens),
                                       bk=bk))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    if how in ("many", "one_row"):
        assert empty > 0                  # splits past a sequence's length


def test_split_rule_keeps_a_row_of_empty_partials_at_zero():
    """A sequence whose every split is empty (length 0, outside the
    kernel's contract) combines to 0, not NaN: the l == 0 guard."""
    rng = np.random.default_rng(8)
    q, k, v, lens = _inputs(rng, 2, 2, 4, 64, 32, [0, 40])
    got, empty = _emulate_split(q, k, v, lens, 4, 16)
    assert empty >= 2 * 4
    assert np.all(got[0] == 0)
    np.testing.assert_allclose(
        got[1], flash_decode_ref(*(torch.from_numpy(a) for a in
                                   (q, k, v, lens)))[1].numpy(),
        rtol=2e-3, atol=2e-3)


def test_plan_fills_the_card_from_shapes_alone():
    """The serve shape splits its 160-slot cache into its 5 tiles (160
    blocks on 132 SMs) with a one-stage ring; a long cache into as many
    splits as put at most two blocks on each SM (8 for 32 (b, kv) pairs,
    33 for one user's 8), with a four-stage ring; a split never exceeds the
    cache's tiles, and shared memory stays within the card's."""
    p = FD_MOD.plan(4, 8, 4, 160, 128, 2, 32, SMS)
    assert (p.n_split, p.stages, p.tensor_cores) == (5, 1, True)
    assert p.smem == FD_MOD.smem_bytes(2, 128, 32, 1, True)
    p = FD_MOD.plan(4, 8, 4, 32768, 128, 2, 32, SMS)
    assert (p.n_split, p.stages) == (8, FD_MOD.MAX_STAGES)
    assert FD_MOD.plan(1, 8, 4, 8192, 128, 2, 32, SMS).n_split == 33
    for blocks in (1, 8, 32, 40, 100, 132, 133, 300):
        n = FD_MOD.plan(1, blocks, 4, 32768, 128, 2, 32, SMS).n_split
        per_sm = FD_MOD.SPLIT_BLOCKS_PER_SM * SMS
        assert blocks * n <= max(per_sm, blocks) < blocks * (n + 1)
    for shape in [(1, 1, 1, 7, 8, 4, 1), (2, 2, 12, 300, 256, 4, 32),
                  (64, 8, 4, 160, 128, 2, 32), (1, 1, 8, 70, 64, 4, 128)]:
        p = FD_MOD.plan(*shape, SMS)
        t, bk = shape[3], shape[6]
        assert 1 <= p.n_split <= -(-t // bk)
        assert 1 <= p.stages <= FD_MOD.MAX_STAGES
        assert p.smem <= FD_MOD.MAX_SMEM_BYTES
    assert FD_MOD.plan(4, 8, 4, 160, 128, 2, 32, SMS, 3).n_split == 3
    # the tensor cores take bf16 at head dims 16-128 in 16-row units; a
    # block there holds 16 query heads, on the CUDA cores 4
    assert not FD_MOD.plan(4, 8, 4, 160, 128, 4, 32, SMS).tensor_cores
    assert not FD_MOD.plan(4, 8, 4, 160, 128, 2, 24, SMS).tensor_cores
    assert not FD_MOD.plan(4, 8, 4, 160, 256, 2, 32, SMS).tensor_cores
    assert FD_MOD.plan(1, 1, 16, 32768, 64, 2, 32, SMS).n_split == \
        FD_MOD.SPLIT_BLOCKS_PER_SM * SMS
    assert FD_MOD.plan(1, 1, 16, 32768, 64, 4, 32, SMS).n_split == \
        FD_MOD.SPLIT_BLOCKS_PER_SM * SMS // 4
    with pytest.raises(ValueError, match="n_split"):
        FD_MOD.plan(4, 8, 4, 160, 128, 2, 32, SMS, 0)
    with pytest.raises(ValueError, match="shared memory"):
        FD_MOD.plan(1, 8, 4, 512, 128, 4, 256, SMS)   # f32, 256-row tiles
