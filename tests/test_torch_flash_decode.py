"""The port's flash_decode against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the reference kernel
runs in Pallas interpret mode, as its own tests run it. Inputs are made with
numpy from a seed and handed to both.
"""

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
    assert _build.kernel_names() == ["flash_attention", "flash_decode"]
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
