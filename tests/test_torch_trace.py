"""The port's spans and counters (``repro_torch.trace``), on the CPU.

A smoke train step under a CPU ``torch.profiler`` records every span, nested
as the layers nest; with no profiler running no span is entered, and with
counting off no counter is computed; the MoE's counters equal a hand count
on a routing built to overflow one expert; counting changes no number.
"""

import importlib
from collections import defaultdict

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.layers import moe_capacity, moe_ffn, moe_route  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

FA = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
OPS = importlib.import_module("repro_torch.kernels.flash_attention.ops")
B, S_LEN = 2, 16
MOE_PARTS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke shapes run faster on one intra-op thread than on a loaded
    host's many."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fake_kernel(monkeypatch):
    """CPU tensors through the flash_attention autograd Function, its launch
    replaced by the plain version: the backward runs ``_plain_backward``, as
    on the card."""
    monkeypatch.setattr(FA, "_launch", lambda q, k, v, causal, q_off=0:
                        flash_attention_plain(q, k, v, causal=causal,
                                              q_off=q_off))
    monkeypatch.setattr(OPS, "flash_attention",
                        lambda q, k, v, causal=True, q_off=0:
                        FA._FlashAttention.apply(q, k, v, causal, q_off))


def _train(arch, **kw):
    """A smoke model's step, its state and a batch (attention through the
    flash path, remat full)."""
    cfg = get_config(arch).smoke().replace(use_flash=True, num_layers=2,
                                           **kw)
    model = LM(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, torch.device("cpu"))
    opt = S.make_optimizer_config(cfg, total_steps=4)
    state = {"params": params, "opt": adamw_init(params, opt)}
    tokens = torch.randint(0, cfg.vocab_size, (B, S_LEN), generator=gen)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    return cfg, S.make_train_step(model, opt), state, batch


def _span_events(prof):
    """Program span events by name: (thread, start, end)."""
    out = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in trace.SPANS:
            out[e.name()].append((e.start_thread_id(), e.start_ns(),
                                  e.end_ns()))
            assert not e.is_user_annotation()
    return out


def _inside(ev, parents):
    tid, s, e = ev
    return any(t == tid and ps <= s and e <= pe for t, ps, pe in parents)


@pytest.mark.parametrize("arch,ffn", [("granite-moe-1b-a400m", "moe"),
                                      ("llama3-8b", "mlp")])
def test_train_step_records_every_span_nested(fake_kernel, arch, ffn):
    """A dense layer's MLP records no span of its own (no cell runs one)."""
    cfg, step, state, batch = _train(arch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    ev = _span_events(prof)
    want = {"step.forward", "step.backward", "step.optimizer", "embed",
            "attention", "attention.backward", "head", "loss"}
    if ffn == "moe":
        want |= {"moe", *MOE_PARTS}
    assert set(ev) == want
    layers = cfg.num_layers
    # remat "full": each layer's forward runs again in backward
    assert len(ev["attention"]) == 2 * layers
    assert all(len(ev[n]) == 2 * layers for n in want & {"moe", *MOE_PARTS})
    assert len(ev["attention.backward"]) == layers
    for name in ("step.forward", "step.backward", "step.optimizer", "embed",
                 "head", "loss"):
        assert len(ev[name]) == 1, name
    for name in ("embed", "head", "loss"):
        assert _inside(ev[name][0], ev["step.forward"]), name
    phases = ev["step.forward"] + ev["step.backward"]
    for name in ("attention", ffn) if ffn == "moe" else ("attention",):
        fwd = [x for x in ev[name] if _inside(x, ev["step.forward"])]
        rec = [x for x in ev[name] if _inside(x, ev["step.backward"])]
        assert len(fwd) == len(rec) == layers, name
    for x in ev["attention.backward"]:
        assert _inside(x, ev["step.backward"])
        assert not _inside(x, ev["attention"])
    for part in MOE_PARTS if ffn == "moe" else ():
        assert len(ev[part]) == 2 * layers
        assert all(_inside(x, ev["moe"]) for x in ev[part]), part
    assert all(_inside(x, phases) for x in ev["attention"])
    (opt,) = ev["step.optimizer"]
    assert opt[1] >= ev["step.backward"][0][2]


def test_plain_backward_records_attention_backward():
    q, k, v, do = (torch.randn(1, 4, 8, 16) for _ in range(4))
    k, v = k[:, :2], v[:, :2]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dq, dk, dv = FA._plain_backward(q, k, v, do, True)
    ev = _span_events(prof)
    assert list(ev) == ["attention.backward"]
    (tid, s, e), = ev["attention.backward"]
    inner = [x for x in prof.profiler.kineto_results.events()
             if x.name() == "aten::softmax"]
    assert inner and all(x.start_thread_id() == tid
                         and s <= x.start_ns() <= e for x in inner)
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    want = torch.autograd.grad(flash_attention_plain(q, k, v), (q, k, v), do)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w)


def test_no_span_entered_and_nothing_counted_when_off(fake_kernel,
                                                      monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered while off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(trace, "count", refuse)
    cfg, step, state, batch = _train("granite-moe-1b-a400m")
    state, loss = step(state, batch)
    assert torch.isfinite(loss)
    model = LM(cfg)
    cache = model.init_cache(B, S_LEN + 1, torch.device("cpu"))
    S.make_prefill_step(model)(state["params"], batch, cache)
    S.make_decode_step(model)(state["params"],
                              {"tokens": batch["tokens"][:, :1]}, cache,
                              S_LEN)
    assert trace.span("moe") is trace.span("attention")    # one no-op
    assert not trace.counting_on()


def test_serving_records_only_the_layers_it_shares_with_training():
    cfg, _, state, batch = _train("granite-moe-1b-a400m")
    model = LM(cfg)
    cache = model.init_cache(B, S_LEN + 1, torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        S.make_prefill_step(model)(state["params"], batch, cache)
        S.make_decode_step(model)(state["params"],
                                  {"tokens": batch["tokens"][:, :1]}, cache,
                                  S_LEN)
    ev = _span_events(prof)
    assert set(ev) == {"attention", "moe", *MOE_PARTS}
    assert all(len(v) == 2 * cfg.num_layers for v in ev.values())


def _overflowing_moe():
    """A MoE layer whose router sends every token first to expert 0 and
    second to expert 1 + i % 3 (token i): expert 0 takes S pairs a
    sequence against a capacity of S * k / E."""
    cfg = get_config("granite-moe-1b-a400m").smoke().replace(
        num_experts=4, experts_per_token=2, capacity_factor=1.0)
    b, s, d, e, f = 2, 8, cfg.d_model, 4, cfg.d_ff
    x = torch.zeros(b, s, d)
    x[:, torch.arange(s), torch.arange(s)] = 1.0
    router = torch.zeros(d, e)
    router[torch.arange(s), 0] = 4.0
    router[torch.arange(s), 1 + torch.arange(s) % 3] = 2.0
    gen = torch.Generator().manual_seed(1)
    p = {"router": router,
         "w_gate": torch.randn(e, d, f, generator=gen) * 0.1,
         "w_up": torch.randn(e, d, f, generator=gen) * 0.1,
         "w_down": torch.randn(e, f, d, generator=gen) * 0.1}
    return cfg, p, x


def test_moe_counters_equal_a_hand_count():
    cfg, p, x = _overflowing_moe()
    b, s, _ = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = moe_capacity(cfg, s)
    assert cap == 4
    _, choice, _ = moe_route(p, x, cfg)
    dropped = 0
    for row in choice.reshape(b, s * k).tolist():     # token-major pairs
        for ex in range(e):
            dropped += max(0, row.count(ex) - cap)
    assert dropped == b * (s - cap)                   # expert 0's overflow
    with trace.counting():
        moe_ffn(p, x, cfg)
        assert trace.counters() == {"moe.pairs": b * s * k,
                                    "moe.pairs_dropped": dropped,
                                    "moe.slots": b * e * cap}
        moe_ffn(p, x, cfg)                            # totals accumulate
        assert trace.counters()["moe.pairs_dropped"] == 2 * dropped


def test_counting_changes_no_loss_and_no_gradient(fake_kernel):
    cfg, _, state, batch = _train("granite-moe-1b-a400m")
    model = LM(cfg)
    loss0, g0 = S.loss_and_grads(model, state["params"], batch)
    with trace.counting():
        loss1, g1 = S.loss_and_grads(model, state["params"], batch)
        counted = trace.counters()
    assert counted["moe.pairs"] == 2 * cfg.num_layers * B * S_LEN \
        * cfg.experts_per_token                       # forward, recompute
    assert torch.equal(loss0, loss1)
    flat0, flat1 = S.tree_leaves(g0), S.tree_leaves(g1)
    assert len(flat0) == len(flat1)
    assert all(torch.equal(a, b) for a, b in zip(flat0, flat1))


def test_counting_is_a_scope():
    with pytest.raises(RuntimeError):
        trace.count("x", 1)
    with pytest.raises(RuntimeError):
        trace.counters()
    with trace.counting():
        assert trace.counting_on()
        with pytest.raises(RuntimeError):
            with trace.counting():
                pass
        trace.count("host", 3)
        trace.count("device", torch.tensor(2))
        trace.count("device", torch.tensor(5))
        assert trace.counters() == {"device": 7, "host": 3}
    assert not trace.counting_on()
    with trace.counting():
        assert trace.counters() == {}
