"""The port's max-plus kernel against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version (the kernel's function,
floored at NEG_INF); the reference kernel runs in Pallas interpret mode, as
its own tests run it. Inputs are made with numpy from a seed and handed to
both. The longest paths of the paper's Table I designs are taken from the
timing matrix's ``SRC`` vertex, where the input launches start.
"""

import functools

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
