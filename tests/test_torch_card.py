"""The port's kernels and its smoke trainer on the card.

Every test here needs an NVIDIA card and skips without one. The module
imports torch, numpy and the port only (no jax), so that it also collects
on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_card.py

Each kernel is held to its plain version at the bars of ``chip_smoke.py``:
f32 within 2e-3, bf16 within rtol 1e-2 / atol 1e-3, max-plus bit for bit.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_plain)
from repro_torch.kernels.flash_decode import (flash_decode,  # noqa: E402
                                              flash_decode_ref)
from repro_torch.kernels.maxplus import (NEG_INF, maxplus_matmul,  # noqa: E402
                                         maxplus_matmul_plain)
from repro_torch.launch import train as T  # noqa: E402

FD_MOD = importlib.import_module("repro_torch.kernels.flash_decode.flash_decode")
MP_MOD = importlib.import_module("repro_torch.kernels.maxplus.maxplus")
KERNEL_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
              torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_properties(0).multi_processor_count


def _nan_equal(got, want):
    """Equal bit for bit where finite, and NaN at the same positions."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got, nan=0.0),
                                  np.nan_to_num(want, nan=0.0))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_head_dim_16_matches_plain_version(card, dtype):
    """On the card: d = 16 through the tensor-core kernel (bf16) or the
    CUDA-core one (f32), at the bf16 kernel's tile edges, against the plain
    version within the kernel bar."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(16)
    route = ("tensor_core_launches" if dt == torch.bfloat16
             else "cuda_core_launches")
    for s in (1, 127, 128, 129):
        for causal in (True, False):
            q = torch.randn(2, 4, s, 16, generator=gen, device="cuda").to(dt)
            k = torch.randn(2, 2, s, 16, generator=gen, device="cuda").to(dt)
            v = torch.randn(2, 2, s, 16, generator=gen, device="cuda").to(dt)
            before = getattr(flash_attention, route)
            got = flash_attention(q, k, v, causal=causal)
            assert getattr(flash_attention, route) == before + 1
            want = flash_attention_plain(q, k, v, causal=causal)
            torch.testing.assert_close(got.float(), want.float(),
                                       **KERNEL_TOL[dt])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_decode_at_several_splits_matches_plain_version(card, dtype):
    """On the card: the kernel at one, the plan's and many splits, with
    lengths that leave whole splits empty, against its plain version within
    the kernel bar; a split call launches two kernels, an unsplit one one;
    bf16 at head dims 16-128 takes the tensor cores."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, kv, g, t, hd, lens in [(4, 8, 4, 160, 128, [144, 1, 37, 160]),
                                  (2, 2, 6, 1000, 64, [1000, 10]),
                                  (2, 1, 20, 97, 16, [97, 5]),
                                  (2, 1, 3, 300, 256, [299, 2])]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((b, kv, g, hd), (b, kv, t, hd),
                                 (b, kv, t, hd)))
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        want = flash_decode_ref(q, k, v, ln).float()
        for n_split in (1, None, 7, -(-t // 16)):
            p = FD_MOD.plan(b, kv, g, t, hd, q.element_size(), 16, card,
                            n_split)
            before = (flash_decode.device_launches,
                      flash_decode.tensor_core_launches)
            got = (flash_decode(q, k, v, ln, bk=16) if n_split is None
                   else FD_MOD._launch(q, k, v, ln, 16, p))
            assert p.tensor_cores == (dt == torch.bfloat16 and hd <= 128)
            assert (flash_decode.device_launches - before[0],
                    flash_decode.tensor_core_launches - before[1]) == \
                (2 if p.n_split > 1 else 1, int(p.tensor_cores))
            torch.testing.assert_close(got.float(), want, **KERNEL_TOL[dt])


@pytest.mark.requires_cuda
def test_maxplus_equals_plain_version_with_nan_and_splits(card):
    """On the card: every tile and K-split choice equals the plain version
    bit for bit, NaN positions included; a split call launches two
    kernels."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for m, k, n in [(1, 257, 1), (100, 130, 70), (579, 579, 579)]:
        a = torch.randn(m, k, generator=gen, device="cuda")
        b = torch.randn(k, n, generator=gen, device="cuda")
        a[:, ::3] = NEG_INF
        a[0, 0] = float("nan")
        b[k // 2, n // 2] = float("nan")
        want = maxplus_matmul_plain(a, b).cpu().numpy()
        for tile in (64, 128):
            for splits in (1, 3, None):
                p = MP_MOD.plan(m, n, k, card, tile=tile, splits=splits)
                before = maxplus_matmul.device_launches
                got = MP_MOD._launch(a, b, p)
                assert maxplus_matmul.device_launches - before == \
                    (2 if p.splits > 1 else 1)
                _nan_equal(got.cpu().numpy(), want)
        _nan_equal(maxplus_matmul(a, b).cpu().numpy(), want)   # plan's


@pytest.mark.requires_cuda
def test_train_smoke_runs_through_the_tensor_cores(card):
    """On the card: ``train --smoke --steps 4`` runs, with finite losses, and
    every flash_attention launch is the bf16 tensor-core kernel at d = 16."""
    for name in ("launches", "tensor_core_launches", "cuda_core_launches"):
        setattr(flash_attention, name, 0)
    r = T.main(["--smoke", "--steps", "4"])
    cfg = r.model.cfg
    want = 4 * (2 if cfg.remat == "full" else 1) * cfg.num_layers
    assert cfg.head_dim == 16
    assert (flash_attention.launches, flash_attention.tensor_core_launches,
            flash_attention.cuda_core_launches) == (want, want, 0)
    assert len(r.losses) == 4 and all(np.isfinite(r.losses))
