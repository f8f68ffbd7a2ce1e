"""The reading of the program's spans and counters (``harness/spans.py``)
on a fixture of raw profiler events: a step's phases on the main thread,
backward on autograd's thread, runtime launches with correlation ids,
kernels, and autograd nodes linked to their forward operations by sequence
number. Then the older readings of ``harness/trace.py`` with and without the
span events, the readers on a trace without spans, and the whole stretch at
the program's smoke size on the CPU."""

import dataclasses
from unittest import mock

import pytest
import torch
from torch.autograd import DeviceType

from harness import readers, spans
from harness import run as hrun
from harness import trace as htrace
from harness.spec import metric_reader

NEW = ("attention_backward_ms.train", "moe_ms.train", "span_coverage.train",
       "moe_dropped_pairs.train", "moe_slot_fill.train")
SPAN_NAMES = ("step.forward", "step.backward", "step.optimizer", "embed",
              "attention", "attention.backward", "moe", "moe.dispatch")
NODE = spans.NODE


@dataclasses.dataclass
class Ev:
    """A raw kineto event, as ``kineto_results.events()`` gives it."""
    n: str
    s: int
    e: int
    tid: int = 1
    cuda: bool = False
    corr: int = 0
    link: int = 0
    seq: int = -1
    fwd: int = 0
    user: bool = False

    def name(self): return self.n
    def start_ns(self): return self.s
    def end_ns(self): return self.e
    def start_thread_id(self): return self.tid
    def correlation_id(self): return self.corr
    def linked_correlation_id(self): return self.link
    def sequence_nr(self): return self.seq
    def fwd_thread_id(self): return self.fwd
    def is_hidden_event(self): return False
    def is_user_annotation(self): return self.user

    def device_type(self):
        return DeviceType.CUDA if self.cuda else DeviceType.CPU


def _launch(corr, op, t, tid, kernel, ks, ke, call="cudaLaunchKernel"):
    """A runtime call at t on thread tid under the host op ``op`` (its
    profiler id), and the kernel it launched."""
    return [Ev(call, t, t + 5, tid, corr=corr, link=op),
            Ev(kernel, ks, ke, tid, cuda=True, corr=corr, link=op)]


def events(with_spans=True):
    """Two threads: the step's (1) and autograd's (2). Times in ns."""
    sp = [Ev("step.forward", 0, 1000), Ev("embed", 10, 40),
          Ev("attention", 100, 400), Ev("moe", 600, 900),
          Ev("moe.dispatch", 610, 700), Ev("step.backward", 1000, 3000),
          Ev("attention.backward", 1800, 2500, 2),
          Ev("step.optimizer", 3000, 3500)]
    ops = [Ev("aten::embedding", 12, 38, corr=1, seq=1),
           Ev("aten::mm", 110, 200, corr=2, seq=5),
           Ev("aten::add", 450, 480, corr=3, seq=6),
           Ev("aten::gather", 620, 680, corr=4, seq=7),
           Ev(NODE + "MmBackward0", 1100, 1400, 2, corr=5, seq=5, fwd=1),
           Ev(NODE + "GatherBackward0", 1500, 1700, 2, corr=6, seq=7,
              fwd=1),
           Ev(NODE + "AddBackward0", 1710, 1790, 2, corr=7, seq=6, fwd=1),
           Ev("aten::softmax_backward", 1850, 2400, 2, corr=8),
           Ev(NODE + "OrphanBackward0", 2600, 2700, 2, corr=9, seq=99,
              fwd=1),
           Ev("aten::_foreach_add_", 3005, 3030, corr=10)]
    dev = (_launch(101, 1, 20, 1, "embedding_kernel", 50, 60)
           + _launch(102, 2, 120, 1, "gemm", 300, 350)
           # launched with no runtime call in the trace: by the host op
           + [Ev("gemm_tail", 360, 370, cuda=True, corr=199, link=2)]
           + _launch(103, 3, 455, 1, "add", 500, 520)
           + _launch(104, 4, 630, 1, "gather", 700, 760)
           + _launch(105, 5, 1160, 2, "gemm", 1200, 1300)
           + _launch(106, 6, 1510, 2, "Memcpy DtoD (Device -> Device)",
                     1600, 1650, call="cudaMemcpyAsync")
           + _launch(107, 7, 1720, 2, "add_bw", 1730, 1760)
           + _launch(108, 8, 1810, 2, "softmax_bw", 1900, 2300)
           + _launch(109, 9, 2610, 2, "orphan", 2650, 2680)
           + _launch(110, 10, 3010, 1, "adam", 3100, 3400)
           + _launch(111, 0, 3600, 1, "dtoh", 3620, 3630))
    return (sp if with_spans else []) + ops + dev


WANT = {
    "embedding_kernel": ("step.forward", "embed", "run"),
    "gemm_tail": ("step.forward", "attention", "run"),
    "add": ("step.forward", "step.forward", "run"),
    "gather": ("step.forward", "moe.dispatch", "run"),
    "Memcpy DtoD (Device -> Device)": ("step.backward", "moe.dispatch",
                                       "grad"),
    "add_bw": ("step.backward", "step.forward", "grad"),
    "softmax_bw": ("step.backward", "attention.backward", "run"),
    "orphan": ("step.backward", None, "run"),
    "adam": ("step.optimizer", "step.optimizer", "run"),
    "dtoh": (None, None, "run"),
}


def _read(evs, counters=None):
    return spans.read_events(evs, 1.0, 2, SPAN_NAMES, counters)


def test_each_kernel_takes_its_launch_phase_and_span():
    t = _read(events())
    got = {}
    for (name, s, _), lab in zip(t.kernels, t.labels):
        got.setdefault(name, []).append((s, lab))
    # the forward's product by its launch, its gradient by the node's
    # sequence number and forward thread
    assert got.pop("gemm") == [
        (300, ("step.forward", "attention", "run")),
        (1200, ("step.backward", "attention", "grad"))]
    assert {n: v[0][1] for n, v in got.items()} == WANT
    assert t.launches == 10 and t.spans == 8
    assert t.span_events["attention.backward"] == 1


def test_time_coverage_and_idle_gaps_by_span():
    t = _read(events())
    by = t.time_by_span()
    assert by[("step.backward", "attention.backward", "run")] == 400e-9
    assert by[("step.backward", "moe.dispatch", "grad")] == 50e-9
    # layer spans own all but the step's own 20 + 30, the orphan's 30 and
    # the copy outside the step's 10, of 1070 ns
    assert spans.coverage(t) == pytest.approx(100 * 980 / 1070)
    gaps = {k: round(v * 1e9) for k, v in t.gaps_by_span.items()}
    assert gaps == {("step.forward", "attention"): 250,
                    ("step.forward", "step.forward"): 570,
                    ("step.forward", "moe.dispatch"): 180,
                    ("step.backward", "step.backward"): 800,
                    ("step.backward", "attention.backward"): 490,
                    (None, None): 220}
    assert sum(gaps.values()) == round((t.span_s - t.busy_s) * 1e9)


def test_device_user_annotations_are_no_kernels():
    """A ``record_function`` span is copied onto the device's timeline; it
    is no device work."""
    plain = _read(events())
    ann = _read(events() + [Ev("attention", 300, 370, cuda=True,
                               user=True)])
    assert ann.kernels == plain.kernels and ann.labels == plain.labels
    assert ann.busy_s == plain.busy_s


def _run(t):
    run = mock.Mock(traced=True, trace=None, bounds={})
    vars(run)["span_trace"] = t
    return run


def test_the_readers():
    counters = {"moe.pairs": 1000, "moe.pairs_dropped": 40,
                "moe.slots": 1200}
    run = _run(_read(events(), counters))
    got = {m: metric_reader(m)(run) for m in NEW}
    assert got == pytest.approx({
        "attention_backward_ms.train": 400e-6 / 2,
        "moe_ms.train": 110e-6 / 2,
        "span_coverage.train": 100 * 980 / 1070,
        "moe_dropped_pairs.train": 4.0,
        "moe_slot_fill.train": 80.0})


@pytest.mark.parametrize("t", [None, "spanless"])
def test_no_spans_no_readings(t):
    run = _run(_read(events(with_spans=False), {"moe.pairs": 1})
               if t else None)
    assert all(metric_reader(m)(run) is None for m in NEW)


def test_a_program_without_spans_is_not_traced_again(monkeypatch):
    monkeypatch.setattr(spans, "program_trace", lambda: None)
    run = mock.Mock(traced=True)
    with mock.patch("harness.spec.driver") as d:
        assert spans.of(run) is None
    d.assert_not_called()


def _old_trace(evs):
    """``harness/trace.py``'s profile over the fixture's events."""
    prof = mock.MagicMock()
    prof.__enter__.return_value = prof
    prof.profiler.kineto_results.events.return_value = evs
    with mock.patch("torch.profiler.profile", return_value=prof), \
            mock.patch("torch.cuda.synchronize"):
        return htrace.profile(lambda: None, 2)


def test_the_older_readings_do_not_see_the_spans():
    with_, without = _old_trace(events()), _old_trace(events(False))
    for f in ("kernels", "launches", "busy_s", "span_s", "units"):
        assert getattr(with_, f) == getattr(without, f), f
    assert with_.breakdown()["device_ops"] == \
        without.breakdown()["device_ops"]
    bounds = {"gemm": 1e-8}
    for read in (readers.idle_share, readers.launches_per_unit,
                 lambda r: readers.roofline(r, "gemm", ["gemm"], ["gemm"])):
        a = read(mock.Mock(trace=with_, bounds=bounds))
        assert a is not None and a == read(mock.Mock(trace=without,
                                                     bounds=bounds))
    # the idle gaps keep their seconds; a gap under no host operation
    # takes the span open there
    assert sum(s for _, s in with_.gaps_by_host_op) == pytest.approx(
        sum(s for _, s in without.gaps_by_host_op))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_stretch_at_smoke_size(one_thread, tmp_path, monkeypatch):
    """The program's train step traced again on the CPU: its spans and its
    counters, and no device time to read there."""
    from smallcells import small_cell, small_run
    run, _, _ = small_run("granite-moe.train_4k")
    run.traced = True
    _, port = small_cell("granite-moe.train_4k")
    monkeypatch.setattr(hrun, "ROOT", tmp_path)
    with mock.patch.object(hrun, "program_config", lambda arch: port):
        got = {m: metric_reader(m)(run) for m in NEW}
    t = spans.of(run)
    mix, cfg = run.cell.mix, run.cfg
    pairs = 2 * cfg["num_layers"] * mix["batch"] * mix["seq_len"] \
        * cfg["experts_per_token"] * mix["trace_steps"]
    assert t.counters["moe.pairs"] == pairs
    assert t.span_events["moe"] == 2 * cfg["num_layers"] * mix["trace_steps"]
    assert not t.kernels
    assert got["moe_dropped_pairs.train"] == pytest.approx(
        100 * t.counters["moe.pairs_dropped"] / pairs)
    assert 0 < got["moe_slot_fill.train"] <= 100
    assert [got[m] for m in NEW[:3]] == [None] * 3
    assert (tmp_path / "build/perfbench/traces"
            / f"{run.cell.name}.{run.seed}.spans.json").is_file()
