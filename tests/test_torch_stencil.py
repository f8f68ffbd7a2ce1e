"""The port's 3x3 stencil kernel against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version; the reference kernel
runs in Pallas interpret mode, as its own tests run it. Inputs are made with
numpy from a seed and handed to both.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import stencil as ref_stencil  # noqa: E402
from repro_torch.kernels import stencil  # noqa: E402

_WEIGHTS = ("GAUSS3", "SHARPEN3", "SOBEL_X3")
# the shapes x weights of the reference's kernel test at its default
# bh = 128, then its bh sweep on one image (tests/test_kernels.py); the
# port has one tiling, held to each
_CASES = ([(h, w, k, 128) for h, w in [(8, 16), (100, 240), (128, 128),
                                       (77, 515)] for k in _WEIGHTS]
          + [(300, 200, "GAUSS3", bh) for bh in (32, 128, 256)])


@pytest.mark.parametrize("h,w,weights,bh", _CASES)
def test_stencil3x3_matches_pallas_kernel(h, w, weights, bh):
    rng = np.random.default_rng(h * w + bh)
    x = rng.normal(size=(h, w)).astype("float32")
    wr = getattr(ref_stencil, weights)
    want = np.asarray(ref_stencil.stencil3x3(jnp.asarray(x), wr, bh=bh))
    got = stencil.stencil3x3(torch.from_numpy(x), getattr(stencil, weights))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        stencil.stencil3x3_ref(torch.from_numpy(x),
                               getattr(stencil, weights)).numpy(),
        np.asarray(ref_stencil.stencil3x3_ref(jnp.asarray(x), wr)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["gaussian_blur", "sharpen", "sobel_mag2"])
def test_golden_ops_match_reference(op):
    """The dense apps' golden compute on integer pixels 0-255, as the apps
    stream them; the reference's ops go through its Pallas kernel."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(40, 70)).astype(np.float32)
    want = np.asarray(getattr(ref_stencil, op)(jnp.asarray(img)))
    got = getattr(stencil, op)(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_weight_constants_match_reference():
    for name in ("GAUSS3", "SHARPEN3", "SOBEL_X3", "SOBEL_Y3"):
        np.testing.assert_array_equal(
            getattr(stencil, name).numpy(),
            np.asarray(getattr(ref_stencil, name), np.float32))


@pytest.mark.parametrize("bad", ["rank", "weights"])
def test_stencil_rejects_bad_shapes(bad):
    x, w = torch.zeros(8, 8), stencil.GAUSS3
    if bad == "rank":
        x = x[None]
    else:
        w = torch.zeros(3, 2)
    with pytest.raises(ValueError):
        stencil.stencil3x3(x, w)


@pytest.mark.requires_cuda
def test_kernel_on_the_card_matches_plain_version():
    """On the card: the kernel against its plain version at the reference
    test's shapes; other dtypes raise (chip_smoke.py runs the frames)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, w in [(8, 16), (100, 240), (77, 515)]:
        x = torch.randn(h, w, generator=gen, device="cuda")
        for weights in (stencil.GAUSS3, stencil.SHARPEN3, stencil.SOBEL_X3):
            torch.testing.assert_close(stencil.stencil3x3(x, weights),
                                       stencil.stencil3x3_ref(x, weights),
                                       rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        stencil.stencil3x3(x.double(), stencil.GAUSS3)
