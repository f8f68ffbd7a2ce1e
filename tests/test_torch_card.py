"""The port's kernels, its smoke trainer and its compiler engines on the card.

Every test marked ``requires_cuda`` needs an NVIDIA card and skips without
one. The module imports torch, numpy and the port only (no jax), so that it
also collects on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_card.py

Each kernel is held to its plain version at the bars of ``chip_smoke.py``:
f32 within 2e-3, bf16 within rtol 1e-2 / atol 1e-3, max-plus bit for bit.
The compiler's torch engines are held to the port's host engines: STA bit
for bit, place and route by legality, determinism and A*'s wirelength.
The last test runs anywhere: without CUDA, the torch engines raise unless
the CPU was asked for.
"""

import copy
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
from repro_torch.core import (ALL_APPS, CascadeCompiler,  # noqa: E402
                              IncrementalSTA, PassConfig, PostPnRParams,
                              analyze, analyze_vec, evaluate_design,
                              post_pnr_pipeline)
from repro_torch.core.interconnect import Fabric  # noqa: E402
from repro_torch.core.netlist import extract_netlist  # noqa: E402
from repro_torch.core.place import PlaceParams, place  # noqa: E402
from repro_torch.core.route import RouteParams, check_legal, route  # noqa: E402
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


# ---------------------------------------------------------------------------
# the compiler's torch engines
# ---------------------------------------------------------------------------


def _routed(app, unroll):
    c = CascadeCompiler(device="cpu")
    r = c.compile(ALL_APPS[app], PassConfig(post_pnr=False, place_moves=40),
                  unroll=unroll)
    return r.design, c.timing


def _report(rep):
    return (rep.critical_path_ns, rep.max_freq_mhz, rep.clock_period_ns,
            rep.n_segments, rep.critical_path, rep.arrival_out)


@pytest.mark.requires_cuda
def test_torch_sta_on_the_card_equals_numpy_engine(card):
    """On the card: the float64 level loop gives the numpy engine's report
    bit for bit, and drives the post-PnR loop to the same state."""
    for app, unroll in (("gaussian", 1), ("harris", 1), ("mttkrp", 2)):
        design, tm = _routed(app, unroll)
        want = analyze(design, tm, backend="numpy")
        assert _report(analyze(design, tm)) == _report(want)
        assert _report(analyze(design, tm, backend="torch")) == _report(want)
        assert (_report(analyze_vec(design, tm, backend="torch",
                                    device="cuda")) == _report(want))
        runs = []
        for backend in ("numpy", "torch"):
            d = copy.deepcopy(design)
            res = post_pnr_pipeline(d, tm, PostPnRParams(max_iters=40),
                                    sta_backend=backend)
            runs.append((res.history, res.stop_reason, res.registers_added,
                         {k: sorted(rb.reg_hops)
                          for k, rb in d.routes.items()}))
        assert runs[0] == runs[1]


@pytest.mark.requires_cuda
def test_torch_placer_on_the_card_legal_and_deterministic(card):
    fabric = Fabric()
    nl = extract_netlist(ALL_APPS["harris"].build(1))
    pp = PlaceParams(seed=2, moves_per_node=60, backend="torch")
    s = {}
    a = place(nl, fabric, pp, stats=s)
    check_legal(nl, a, fabric)
    assert place(nl, fabric, pp) == a
    assert s["devices"] == 1 and len(s["replica_costs"]) == s["replicas"]


@pytest.mark.requires_cuda
def test_torch_router_on_the_card_legal_and_at_most_astar(card):
    fabric = Fabric()
    nl = extract_netlist(ALL_APPS["harris"].build(1))
    pl = place(nl, fabric, PlaceParams(seed=2, moves_per_node=60))
    got = route(nl, pl, fabric, RouteParams(backend="torch"))
    check_legal(nl, pl, fabric, got)
    assert got.total_wirelength() <= route(nl, pl, fabric).total_wirelength()
    # no RNG, first-index tie-breaks, the same float32 sums: the same trees
    # run to run, and on the card as on the CPU
    for other in (route(nl, pl, fabric, RouteParams(backend="torch")),
                  route(nl, pl, fabric, RouteParams(backend="torch"),
                        device="cpu")):
        assert all(got.routes[k].hops == other.routes[k].hops
                   for k in got.routes)


_NO_CUDA_CALLS = ("analyze", "analyze_vec", "IncrementalSTA", "post_pnr",
                  "evaluate_design", "place", "route", "compile_pnr",
                  "compile_sta")


@pytest.mark.parametrize("call", _NO_CUDA_CALLS)
def test_torch_engines_raise_without_cuda_unless_cpu_asked(call,
                                                           monkeypatch):
    """No quiet fallback: ``device=None`` means the card, and without one
    every torch engine raises."""
    design, tm = _routed("gaussian", 1)
    nl = extract_netlist(ALL_APPS["vecadd"].build(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "analyze": lambda: analyze(design, tm, backend="torch"),
        "analyze_vec": lambda: analyze_vec(design, tm, backend="torch"),
        "IncrementalSTA": lambda: IncrementalSTA(design, tm,
                                                 backend="torch"),
        "post_pnr": lambda: post_pnr_pipeline(copy.deepcopy(design), tm,
                                              sta_backend="torch"),
        "evaluate_design": lambda: evaluate_design(
            design, tm, CascadeCompiler().energy, 10, sta_backend="torch"),
        "place": lambda: place(nl, Fabric(), PlaceParams(backend="torch")),
        "route": lambda: route(nl, place(nl, Fabric()), Fabric(),
                               RouteParams(backend="torch")),
        "compile_pnr": lambda: CascadeCompiler().compile(
            ALL_APPS["vecadd"], PassConfig(pnr_backend="torch",
                                           place_moves=2)),
        "compile_sta": lambda: CascadeCompiler().compile(
            ALL_APPS["vecadd"], PassConfig(sta_backend="torch",
                                           place_moves=2)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[call]()
