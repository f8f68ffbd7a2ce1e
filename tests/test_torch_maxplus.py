"""The port's max-plus kernel against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version (the kernel's function,
floored at NEG_INF); the reference kernel runs in Pallas interpret mode, as
its own tests run it. Inputs are made with numpy from a seed and handed to
both. The longest paths of the paper's Table I designs are taken from the
timing matrix's ``SRC`` vertex, where the input launches start.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.maxplus import longest_path as ref_longest_path  # noqa: E402
from repro.kernels.maxplus import maxplus_matmul as ref_maxplus_matmul  # noqa: E402
from repro.kernels.maxplus import maxplus_matmul_ref as ref_maxplus_matmul_ref  # noqa: E402
from repro_torch.core import DENSE_APPS, CascadeCompiler, PassConfig  # noqa: E402
from repro_torch.core.sta import longest_path_maxplus, timing_matrix  # noqa: E402
from repro_torch.kernels.maxplus import (NEG_INF, longest_path,  # noqa: E402
                                         maxplus_matmul, maxplus_matmul_plain,
                                         maxplus_matmul_ref)

# the (m, k, n) and block shapes of the reference's kernel tests
# (tests/test_kernels.py): the port has one tiling, held to each
_CASES = ([(m, k, n, (128, 128, 128)) for m, k, n in
           [(8, 8, 8), (100, 130, 70), (128, 128, 128), (200, 50, 300),
            (1, 257, 1)]]
          + [(150, 90, 60, bs) for bs in ((128, 128, 128), (64, 128, 32))])


@pytest.mark.parametrize("m,k,n,blocks", _CASES)
def test_maxplus_matmul_matches_pallas_kernel(m, k, n, blocks):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    a = rng.normal(size=(m, k)).astype("float32")
    b = rng.normal(size=(k, n)).astype("float32")
    bm, bn, bk = blocks
    want = np.asarray(ref_maxplus_matmul(jnp.asarray(a), jnp.asarray(b),
                                         bm=bm, bn=bn, bk=bk))
    got = maxplus_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        maxplus_matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref_maxplus_matmul_ref(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-6)


def test_floor_at_neg_inf_is_the_tpu_kernels_not_its_oracles():
    """The Pallas kernel starts each output tile at NEG_INF, so it floors
    the product there; its oracle does not. The port computes the kernel's
    function, and its own unfloored ref equals the reference's oracle."""
    a = np.array([[-1e9, -1e9], [0, 1]], np.float32)
    b = np.array([[-500, 2], [-700, 3]], np.float32)
    tpu = np.asarray(ref_maxplus_matmul(jnp.asarray(a), jnp.asarray(b)))
    oracle = np.asarray(ref_maxplus_matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    got = maxplus_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert tpu[0, 0] == np.float32(NEG_INF)
    assert oracle[0, 0] == np.float32(-1000000512.0)
    np.testing.assert_array_equal(got, tpu)
    assert not np.array_equal(got, oracle)
    np.testing.assert_array_equal(
        maxplus_matmul_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        oracle)
    np.testing.assert_array_equal(
        maxplus_matmul_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        tpu)


def test_plain_version_is_chunked_over_k(monkeypatch):
    """A k chunk that does not divide K gives the same product."""
    from repro_torch.kernels.maxplus import ref as ref_mod
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(9, 23)).astype("float32"))
    b = torch.from_numpy(rng.normal(size=(23, 7)).astype("float32"))
    whole = maxplus_matmul_ref(a, b)
    monkeypatch.setattr(ref_mod, "_CHUNK_ELEMS", 9 * 7 * 4)
    assert torch.equal(maxplus_matmul_ref(a, b), whole)


@pytest.mark.parametrize("n,edges,seed", [(20, 40, 0), (64, 200, 1),
                                          (130, 400, 2)])
def test_longest_path_random_dag_matches_reference(n, edges, seed):
    rng = np.random.default_rng(seed)
    m = np.full((n, n), -1e9, np.float32)
    for _ in range(edges):
        i, j = sorted(rng.integers(0, n, 2))
        if i != j:
            m[j, i] = max(m[j, i], float(rng.uniform(0.05, 3.0)))
    want = np.asarray(ref_longest_path(jnp.asarray(m)))
    got = longest_path(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, longest_path_maxplus(m, 0), rtol=1e-4,
                               atol=1e-3)


@functools.lru_cache(maxsize=None)
def _table1_matrix(app, flow):
    c = CascadeCompiler()
    cfg = getattr(PassConfig, flow)(place_moves=40)
    r = c.compile(DENSE_APPS[app], cfg)
    return timing_matrix(r.design, c.timing)


@pytest.mark.parametrize("flow", ["unpipelined", "full"])
@pytest.mark.parametrize("app", sorted(DENSE_APPS))
def test_longest_path_of_table1_designs_from_src(app, flow):
    m, verts = _table1_matrix(app, flow)
    src = verts.index("SRC")
    got = longest_path(torch.from_numpy(m), src).numpy()
    want = longest_path_maxplus(m, src)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        got, np.asarray(ref_longest_path(jnp.asarray(m), src)),
        rtol=1e-5, atol=1e-4)
    # from SRC the arrivals are real: exactly the vertices reachable over
    # the matrix's edges get one, and that is nearly all of them
    edge = m > NEG_INF / 2                       # edge[i, j]: j -> i
    seen = np.zeros(len(verts), bool)
    seen[src] = True
    while True:
        nxt = seen | edge[:, seen].any(axis=1)
        if (nxt == seen).all():
            break
        seen = nxt
    np.testing.assert_array_equal(got > NEG_INF / 2, seen)
    assert seen.sum() >= 0.9 * len(verts)
    assert 0.5 < float(got.max()) < 50.0


@pytest.mark.parametrize("bad", ["rank", "inner", "dtype", "contiguous",
                                 "empty"])
def test_maxplus_rejects_what_the_kernel_does_not_take(bad):
    a, b = torch.zeros(4, 3), torch.zeros(3, 5)
    if bad == "rank":
        a = a[None]
    elif bad == "inner":
        b = torch.zeros(4, 5)
    elif bad == "dtype":
        a, b = a.double(), b.double()
    elif bad == "contiguous":
        b = torch.zeros(5, 3).T
    elif bad == "empty":
        a, b = torch.zeros(4, 0), torch.zeros(0, 5)
    with pytest.raises((ValueError, TypeError)):
        maxplus_matmul(a, b)


@pytest.mark.requires_cuda
def test_kernel_on_the_card_equals_plain_version():
    """On the card: the kernel equals its plain version bit for bit, ragged
    edges and the floor included (chip_smoke.py runs the full set)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in [(1, 257, 1), (100, 130, 70), (266, 266, 266)]:
        a = torch.randn(m, k, generator=gen, device="cuda")
        b = torch.randn(k, n, generator=gen, device="cuda")
        a[:, ::3] = NEG_INF
        assert torch.equal(maxplus_matmul(a, b), maxplus_matmul_plain(a, b))


# ---------------------------------------------------------------------------
# NaN, and the tile and K-split choice

MP_MOD = importlib.import_module("repro_torch.kernels.maxplus.maxplus")
SMS = 132                                        # an H100's SMs
# the 13 longest paths' closure sizes of Table I and the pins
PATH_SIZES = (69, 71, 87, 89, 130, 143, 235, 249, 266, 347, 355, 411, 579)


def _nan_equal(got, want):
    """Equal bit for bit where finite, and NaN at the same positions."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got, nan=0.0),
                                  np.nan_to_num(want, nan=0.0))


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (100, 130, 70), (1, 257, 1),
                                   (150, 90, 60)])
def test_nan_propagates_as_in_the_pallas_kernel(m, k, n):
    """NaN entries of A and B give NaN at the same outputs as the Pallas
    kernel's jnp.maximum, ragged edges and the floor included."""
    rng = np.random.default_rng(m + k + n)
    a = rng.normal(size=(m, k)).astype("float32")
    b = rng.normal(size=(k, n)).astype("float32")
    a[rng.random((m, k)) < 0.3] = NEG_INF
    a[rng.integers(0, m), rng.integers(0, k)] = np.nan
    b[rng.integers(0, k), rng.integers(0, n)] = np.nan
    want = np.asarray(ref_maxplus_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = maxplus_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.isnan(want).any()
    _nan_equal(got, want)


def _emulate_split(a, b, p):
    """The kernel's K split, on the CPU: each split floors its own partial
    product over K rows [z * k_chunk, (z + 1) * k_chunk), and a second pass
    takes the splits' max."""
    k = a.shape[1]
    parts = [maxplus_matmul_plain(a[:, k0:k0 + p.k_chunk].contiguous(),
                                  b[k0:k0 + p.k_chunk].contiguous())
             for k0 in range(0, k, p.k_chunk)]
    assert len(parts) == p.splits
    out = parts[0]
    for x in parts[1:]:
        out = torch.maximum(out, x)
    return out


@pytest.mark.parametrize("n", PATH_SIZES + (1000,))
def test_plan_fills_the_card_and_its_split_is_exact(n):
    """Below the size where 128 x 128 tiles give every SM a block, the plan
    takes 64 x 64 tiles and splits K into whole 16-deep slices, none empty;
    the split result equals the plain version bit for bit, NaN included."""
    p = MP_MOD.plan(n, n, n, SMS)
    assert p.tile == 64 and p.k_chunk % MP_MOD.K_STEP == 0
    assert (p.splits - 1) * p.k_chunk < n <= p.splits * p.k_chunk
    blocks = -(-n // 64) ** 2 * p.splits
    assert blocks <= MP_MOD.SPLIT_BLOCKS_PER_SM * SMS + -(-n // 64) ** 2
    if n < 1000:
        assert p.splits > 1
    rng = np.random.default_rng(n)
    m = min(n, 150)                         # rows do not enter the split
    a = torch.from_numpy(rng.normal(size=(m, n)).astype("float32"))
    b = torch.from_numpy(rng.normal(size=(n, 40)).astype("float32"))
    a[rng.random((m, n)) < 0.5] = NEG_INF
    a[3, n // 2] = float("nan")
    _nan_equal(_emulate_split(a, b, p), maxplus_matmul_plain(a, b))


def test_plan_keeps_128_tiles_where_they_fill_the_card():
    assert MP_MOD.plan(4096, 4096, 4096, SMS) == MP_MOD.Plan(128, 4096, 1)
    assert MP_MOD.plan(64, 64, 1000, SMS, tile=128, splits=3) == \
        MP_MOD.Plan(128, 336, 3)
    assert MP_MOD.plan(64, 64, 20, SMS, splits=100) == MP_MOD.Plan(64, 16, 2)
    with pytest.raises(ValueError, match="tile"):
        MP_MOD.plan(64, 64, 64, SMS, tile=32)
