"""bench_torch/tools/span_readings.py on the CPU: each metric's reading of
a made-up stretch, None where its data is absent; the idle seconds by span
over synthetic profiler events (two threads, nested `d2p.*` ranges), with
the idle gaps by host op unchanged by the ranges; and the tool's run of
each cell kind at tiny sizes."""

import importlib.util

import pytest

from bench_torch.harness import trace
from bench_torch.tests.conftest import ROOT
from bench_torch.tests.test_trace import Ev, events as plain_events


def _tool():
    path = ROOT / "bench_torch" / "tools" / "span_readings.py"
    spec = importlib.util.spec_from_file_location("span_readings", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TOOL = _tool()

LAYER = {"spans": {
    "d2p.train.forward": {"calls": 1, "ms": 40.0, "self_ms": 10.0},
    "d2p.train.backward": {"calls": 1, "ms": 100.0, "self_ms": 50.0},
    "d2p.train.update": {"calls": 1, "ms": 8.0, "self_ms": 8.0},
    "d2p.lstm.backward": {"calls": 121, "ms": 50.0, "self_ms": 50.0},
    "d2p.score.replay": {"calls": 4, "ms": 30.0, "self_ms": 30.0},
    "d2p.score.vm": {"calls": 4, "ms": 2000.0, "self_ms": 2000.0}},
    "counters": {"vm.steps": 4000.0, "vm.machine_steps": 8e5,
                 "vm.live_machine_steps": 2e5}}
WANT = {"train.forward_host_ms": 40.0, "train.backward_host_ms": 100.0,
        "train.update_host_ms": 8.0, "train.lstm_backward_host_ms": 50.0,
        "eval.replay_ms": 30.0, "eval.vm_steps_per_batch": 4000.0,
        "eval.vm_step_us": 500.0, "eval.vm_live_share": 25.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_metric_reads_a_stretch(name):
    read = TOOL.METRICS[name]
    assert read(LAYER) == pytest.approx(WANT[name])
    assert read({}) is None
    assert read({"spans": {}, "counters": {}}) is None


def test_per_step():
    summary = {"spans": {"d2p.x": {"calls": 10, "seconds": 0.5,
                                   "self_seconds": 0.2}},
               "counters": {"vm.steps": 300}}
    assert TOOL.per_step(summary, 5) == {
        "spans": {"d2p.x": {"calls": 2.0, "ms": 100.0,
                            "self_ms": pytest.approx(40.0)}},
        "counters": {"vm.steps": 60.0}}


def span_events(with_kinds):
    """test_trace's events with `d2p.*` ranges on two threads: on thread 1
    d2p.step [0, 1000) holding d2p.inner [500, 950); on thread 2
    d2p.back [350, 420), started later than any range open there."""
    k = (lambda s: s) if with_kinds else (lambda s: None)
    return plain_events(with_kinds) + [
        Ev("d2p.step", 0, 1000, k("user_annotation"), annotation=True),
        Ev("d2p.inner", 500, 450, k("user_annotation"), annotation=True),
        Ev("d2p.back", 350, 70, k("user_annotation"), annotation=True,
           tid=2),
        Ev("d2p.inner", 500, 20, k("gpu_user_annotation"), device=True,
           annotation=True)]


@pytest.mark.parametrize("with_kinds", [True, False])
def test_idle_spans(with_kinds):
    """Gaps [0, 200) mid 100, [300, 450) mid 375, [520, 1000) mid 760:
    named by the latest-started d2p range open there, on any thread."""
    idle = dict(TOOL.idle_spans(span_events(with_kinds)))
    assert idle == pytest.approx({"d2p.step": 200e-9, "d2p.back": 150e-9,
                                  "d2p.inner": 480e-9})
    # without any range open: "no span"
    idle = dict(TOOL.idle_spans(plain_events(with_kinds)))
    assert idle == pytest.approx({"no span": 830e-9})


@pytest.mark.parametrize("with_kinds", [True, False])
def test_idle_gaps_unchanged_by_spans(with_kinds):
    """The stretch's idle gaps by host op, device ops and busy time read as
    harness/trace.py reads them without the d2p ranges."""
    got = TOOL.reduce_stretch(span_events(with_kinds))
    want = trace.reduce_events(plain_events(with_kinds), "bench.lstm_step")
    assert got["idle_gaps"] == want["idle_gaps"]
    assert got["device_ops"] == want["device_ops"]
    assert got["busy_s"] == want["busy_s"]


@pytest.mark.parametrize("cell", ["karel_full-train", "karel_synthesis-eval"])
def test_tool_runs_a_cell(tiny_ctx, cell):
    """A whole run of the tool at tiny sizes on the CPU: every metric of the
    cell's kind read, the phases within the step, the spans off after."""
    from demo2program_tpu_torch.utils import spans

    out = TOOL.run(tiny_ctx(cell, trace=1))
    kind = cell.split("-")[1].split(".")[0]
    names = {n for n in WANT if n.startswith(kind)}
    assert set(out["metrics"]) == names
    assert all(v >= 0 for v in out["metrics"].values())
    assert not spans.enabled()
    if kind == "train":
        assert 0.9 <= out["coverage"]["phases_of_step_span"] <= 1.0
        assert out["spans"]["d2p.train.step"]["calls"] == 1.0
    else:
        assert 0 < out["metrics"]["eval.vm_live_share"] <= 100
        assert out["spans"]["d2p.eval.step"]["calls"] == 1.0
    assert set(out["span_ns"]) == {"off", "on", "ranged"}
    assert out["span_ns"]["ranged"] == 0
