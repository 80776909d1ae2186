"""The port's spans and counters (demo2program_tpu_torch/utils/spans.py) on
the CPU: off, a span keeps only its totals; on, events with parents and
self times, counters, and ranges under torch.profiler; their placement in
the train step, the LSTM step, the VM and the scorer, with results that
do not change when tracing is on."""

import sys
import threading

import numpy as np
import pytest
import torch

from demo2program_tpu_torch.cli import trainer_cli
from demo2program_tpu_torch.data.karel_memory import (
    SplitConfig, generate_split)
from demo2program_tpu_torch.dsl.karel_bytecode import compile_batch
from demo2program_tpu_torch.dsl.karel_vocab import KarelVocab
from demo2program_tpu_torch.eval.evaler import config_from_dataset
from demo2program_tpu_torch.eval.scorer import KarelScorer
from demo2program_tpu_torch.models.full import FullModel
from demo2program_tpu_torch.ops import reconstruct, vm
from demo2program_tpu_torch.ops.fused_lstm import FusedLSTMCell
from demo2program_tpu_torch.train.step import (
    TrainState, make_train_step, to_device)
from demo2program_tpu_torch.utils import spans

# __graft_entry__._tiny_cfg's sizes: k 3, test_k 2, T 6, L 12, units 64
BS = 4
SPLIT = SplitConfig(num_programs=2 * BS, seed=21, k=3, test_k=2,
                    max_program_len=12, max_demo_len=6, min_demo_len=3)
STEP_SPANS = ("d2p.train.step", "d2p.train.forward", "d2p.train.backward",
              "d2p.train.update")


@pytest.fixture(autouse=True)
def _tracing_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture(scope="module")
def split():
    return generate_split(SPLIT)


def _cfg(split):
    args = trainer_cli.parse_args(["--device", "cpu", "--num_k", "3",
                                   "--num_lstm_cell_units", "64",
                                   "--batch_size", str(BS)])
    return config_from_dataset(args, split)


def _events():
    """{name: (id, parent id, thread)} of the events kept (one a name)."""
    return {name: (id_, parent, thread)
            for id_, parent, name, _, _, thread in spans._events}


def _stub_clock(monkeypatch, times):
    ticks = iter(times)
    monkeypatch.setattr(spans, "clock", lambda: next(ticks))


# -- the module ----------------------------------------------------------------

def test_off_keeps_totals_only(monkeypatch):
    """Off: the totals grow by each span's seconds, no event, no counter."""
    seconds = spans.total("t.off")
    _stub_clock(monkeypatch, [10.0, 10.5, 20.0, 21.0, 30.0, 32.0])
    for _ in range(3):
        with spans.span("t.off"):
            spans.count("t.counter", 5)
    assert spans.total("t.off") - seconds == pytest.approx(3.5)
    assert spans.summary() == {"spans": {}, "counters": {}}


def test_parents_and_self_time(monkeypatch):
    """On, under a stubbed clock: each event's parent is the innermost span
    open on its thread, and self time is inclusive time less the children's
    (outer 0-10 holding a 1-4 and b 5-9, which holds c 6-7)."""
    spans.enable()
    _stub_clock(monkeypatch, [0.0, 1.0, 4.0, 5.0, 6.0, 7.0, 9.0, 10.0])
    with spans.span("t.outer"):
        with spans.span("t.a"):
            pass
        with spans.span("t.b"):
            with spans.span("t.c"):
                pass
    ev = _events()
    assert ev["t.outer"][1] is None
    assert ev["t.a"][1] == ev["t.b"][1] == ev["t.outer"][0]
    assert ev["t.c"][1] == ev["t.b"][0]
    assert len({thread for _, _, thread in ev.values()}) == 1
    got = spans.summary()["spans"]
    want = {"t.outer": (10.0, 3.0), "t.a": (3.0, 3.0), "t.b": (4.0, 3.0),
            "t.c": (1.0, 1.0)}
    for name, (inclusive, self_s) in want.items():
        assert got[name] == {"calls": 1, "seconds": inclusive,
                             "self_seconds": self_s}, name


def test_other_thread_has_no_parent_and_exceptions_close():
    """A span opened on another thread while one is open here has no parent
    (as the LSTM backward on autograd's thread); a span left by an
    exception still closes and counts."""
    spans.enable()
    with spans.span("t.main"):
        t = threading.Thread(target=lambda: spans.span("t.worker")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with pytest.raises(ValueError):
            with spans.span("t.raises"):
                raise ValueError
    ev = _events()
    assert ev["t.worker"][1] is None
    assert ev["t.worker"][2] != ev["t.main"][2]
    assert ev["t.raises"][1] == ev["t.main"][0]
    assert spans.summary()["spans"]["t.raises"]["calls"] == 1
    assert spans._stack() == []


def test_counters_take_ints_and_device_tensors():
    """On, a counter adds ints and 0-d tensors, read as an int by summary;
    reset drops it, the totals stay."""
    spans.enable()
    spans.count("t.n", 2)
    spans.count("t.n", torch.tensor(5))
    spans.count("t.n")
    with spans.span("t.kept"):
        pass
    assert spans.summary()["counters"] == {"t.n": 8}
    seconds = spans.total("t.kept")
    spans.reset()
    assert spans.summary() == {"spans": {}, "counters": {}}
    assert spans.total("t.kept") == seconds > 0


def test_spans_are_ranges_under_the_profiler():
    """On and under a CPU torch.profiler, each span is a record_function
    range of its name; off, or on without the profiler, no range is
    entered."""
    spans.enable()
    with spans.span("t.no_profiler") as s:
        assert s.range is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("t.ranged"):
            with spans.span("t.inner"):
                torch.ones(4).sum()
        spans.disable()
        with spans.span("t.untraced"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"t.ranged", "t.inner"} <= names
    assert "t.untraced" not in names


def test_totals_view_and_no_lost_update(monkeypatch):
    """TotalsView sums its spans' totals; 16 threads on a short switch
    interval lose no update (each thread updates its own totals): under a
    clock that reads 0, 1, 0, 1, ... on each thread, every span adds 1."""
    view = spans.TotalsView(both=("t.x", "t.y"), x=("t.x",))
    before = spans.total("t.x")
    ticks = threading.local()

    def clock():
        ticks.n = getattr(ticks, "n", -1) + 1
        return float(ticks.n % 2)

    monkeypatch.setattr(spans, "clock", clock)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                with spans.span("t.x"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert spans.total("t.x") - before == 16 * 2000
    with spans.span("t.y"):
        pass
    assert list(view) == ["both", "x"]
    assert view["both"] == spans.total("t.x", "t.y")
    assert view["x"] == spans.total("t.x")


# -- the train step ------------------------------------------------------------

def _two_steps(split, traced):
    torch.manual_seed(0)
    cfg = _cfg(split)
    model = FullModel(cfg)
    state = TrainState(model, 1e-3)
    step = make_train_step(state, cfg, "full")
    cell_calls = []
    forward = FusedLSTMCell.forward

    def counted(self, carry, x):
        cell_calls.append(1)
        return forward(self, carry, x)

    FusedLSTMCell.forward = counted
    if traced:
        spans.enable()
    try:
        reports = [step(to_device(split.get_batch_compact(
            split.ids[s * BS:(s + 1) * BS]), "cpu")) for s in range(2)]
    finally:
        FusedLSTMCell.forward = forward
        spans.disable()
    return model, reports, len(cell_calls)


def test_train_step_spans_change_nothing(split):
    """Two steps of the tiny full model with tracing on and off: parameters
    and reports bit-identical; the step, forward, backward and update spans
    once a step; as many LSTM backwards as LSTM steps as the model's cell
    calls (4T + L a step); the phases inside the step."""
    seconds = {n: spans.total(n) for n in STEP_SPANS}
    model_off, reports_off, _ = _two_steps(split, False)
    assert all(spans.total(n) > seconds[n] for n in STEP_SPANS)
    assert spans.summary() == {"spans": {}, "counters": {}}
    model_on, reports_on, cell_calls = _two_steps(split, True)
    for (k, a), b in zip(model_off.state_dict().items(),
                         model_on.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(reports_off, reports_on):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    got = spans.summary()["spans"]
    for name in STEP_SPANS:
        assert got[name]["calls"] == 2, name
    T, L = SPLIT.max_demo_len, SPLIT.max_program_len
    assert cell_calls == 2 * (4 * T + L)
    assert got["d2p.lstm.step"]["calls"] == cell_calls
    assert got["d2p.lstm.backward"]["calls"] == cell_calls
    steps = {e[0] for e in spans._events if e[2] == "d2p.train.step"}
    for _, parent, name, _, _, _ in spans._events:
        if name in STEP_SPANS[1:]:
            assert parent in steps, name


# -- the VM and the scorer ------------------------------------------------------

def _vm_args(split, mutate):
    """run_and_compare's arguments for the split's first batch: each row's
    own program (or, with `mutate`, its tokens shifted one place, so some
    fail) on each of its seen demos."""
    cfg = _cfg(split)
    batch = to_device(split.get_batch_compact(split.ids[:BS]), "cpu")
    rep, bs, k = reconstruct.replay_seen(batch, cfg)
    tokens = batch["program_tokens"].numpy()
    lens = batch["program_len"].numpy()[:, 0].astype(np.int64)
    if mutate:
        tokens = np.roll(tokens, 1, axis=1)
    codes, _ = compile_batch(tokens, lens, KarelVocab())
    codes = torch.as_tensor(np.repeat(codes, k, axis=0))
    return (codes, rep["wall"], rep["y"][:, 0], rep["x"][:, 0],
            rep["d"][:, 0], rep["markers"][:, 0], rep["y"], rep["x"],
            rep["d"], rep["markers"],
            batch["demo_len"].reshape(bs * k).long())


def _stepped(args, max_steps):
    """(lock-step iterations, running machines summed over them) of
    run_and_compare's loop, taken one machine step at a time."""
    m = vm._Machines(*args, True, 8, 8)
    needed = live = 0
    while needed < max_steps and bool(m.running().any()):
        live += int(m.running().sum())
        m.step()
        needed += 1
    blocks = -(-needed // vm.CHECK_EVERY) * vm.CHECK_EVERY
    return min(blocks, max_steps), live


@pytest.mark.parametrize("mutate", [False, True], ids=["own", "shifted"])
def test_vm_counters(split, mutate):
    """vm.steps is the loop's iterations, vm.machine_steps B x those,
    vm.live_machine_steps the running machines summed over them, as
    stepping the machines one step at a time finds; with a step cap under
    what the programs need too. The verdicts do not change when on."""
    args = _vm_args(split, mutate)
    B = args[0].shape[0]
    full = (vm.MAX_FUNC_CALL + 2) * args[0].shape[1]
    needed, _ = _stepped(args, full)
    for max_steps in (full, max(needed - 5, 1)):
        off = vm.run_and_compare(*args, max_steps=max_steps)
        spans.reset()
        spans.enable()
        on = vm.run_and_compare(*args, max_steps=max_steps)
        spans.disable()
        for key in off:
            assert torch.equal(off[key], on[key]), key
        steps, live = _stepped(args, max_steps)
        assert spans.summary()["counters"] == {
            "vm.steps": steps, "vm.machine_steps": B * steps,
            "vm.live_machine_steps": live}
        assert 0 < live <= B * steps


def test_scorer_timings_are_its_spans(split):
    """A batch's timings["vm"] grows by exactly the growth of the replay
    and VM spans' totals, timings["host"] by the host span's; scoring
    with tracing on lands in the spans and counters."""
    cfg = _cfg(split)
    scorer = KarelScorer(cfg, "cpu")
    batch = to_device(split.get_batch_compact(split.ids[:BS]), "cpu")
    tokens = batch["program_tokens"].numpy()
    evals = {"pred_tokens": np.roll(tokens, 1, axis=1),
             "pred_len": batch["program_len"].numpy()[:, 0],
             "pred_is_same_seq": np.zeros(BS, np.float32)}
    vm_names = ("d2p.score.replay", "d2p.score.vm")
    before = dict(scorer.timings)
    totals = (spans.total(*vm_names), spans.total("d2p.score.host"))
    spans.enable()
    scorer.score_batch(batch, evals)
    spans.disable()
    assert scorer.timings["vm"] - before["vm"] == (
        spans.total(*vm_names) - totals[0])
    assert scorer.timings["host"] - before["host"] == (
        spans.total("d2p.score.host") - totals[1])
    assert scorer.timings["vm"] > before["vm"]
    got = spans.summary()
    # seen and unseen demos: two replays and two VM runs; the host work
    # twice in syntax_and_exact's and the bytecode's
    assert {n: got["spans"][n]["calls"] for n in vm_names} == {
        "d2p.score.replay": 2, "d2p.score.vm": 2}
    assert got["spans"]["d2p.score.host"]["calls"] == 3
    assert 0 < got["counters"]["vm.live_machine_steps"] <= (
        got["counters"]["vm.machine_steps"])
