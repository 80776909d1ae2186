"""Host spans and counters of the program's phases.

    from demo2program_tpu_torch.utils import spans

    with spans.span("d2p.train.forward"):
        ...
    spans.count("vm.steps", n)

A span always adds its host seconds (two `time.perf_counter` reads) to a
total of its name, kept for the life of the process: `total`
sums the seconds of some names and `TotalsView` shows such sums under keys
of its own (the scorers' `timings`).

Tracing is off by default. `enable()` turns it on for the process, and
then each span also keeps an event in memory (name, start, end, thread,
and its parent: the innermost span open on the same thread), `count` adds
to its counter (an int, or a 0-d tensor that stays on its device until
`summary()` reads it), and while a torch.profiler runs the span enters a
`record_function` range of its name, so it reaches the profiler's trace
as a range on the trace's own clock. Off, a span costs one flag check,
the two clock reads and its thread's total's update: no lock, no event, no
range, no device work. `summary()` gives, per span name, the events' calls, inclusive
seconds and self seconds (the duration less the part its child spans
cover), and the counters; `reset()` clears events and counters, not the
totals.

The spans the program places and what reads them: `d2p.train.step`,
`d2p.train.forward`, `d2p.train.backward`, `d2p.train.update`
(train/step.py), `d2p.lstm.step`, `d2p.lstm.backward` (ops/fused_lstm.py),
`d2p.eval.step` (train/step.py), `d2p.score.host`, `d2p.score.replay`,
`d2p.score.vm` (eval/scorer.py, eval/vizdoom_scorer.py: their `timings`),
`d2p.encoder.frames`, `d2p.encoder.rn` (models/encoder.py: the frame CNN
and the relation-network pool); the counters `vm.steps`,
`vm.machine_steps`, `vm.live_machine_steps` (ops/vm.py), `encoder.frames`
and `encoder.rn_rows` (models/encoder.py: the frames and the pair rows a
call). The trainer's `--profile_steps` turns tracing on for its
profiled steps and logs the summary; bench_torch/tools/span_readings.py
reads them on the card, and the benchmark's ViZDoom train cell reads the
encoder's (bench_torch/traffic/doom_train_cache.py).
"""

import itertools
import threading
import time
from collections.abc import Mapping

import torch

clock = time.perf_counter

_lock = threading.Lock()
# each thread's totals, name -> seconds, always kept: a thread updates
# only its own, so the hot path takes no lock
_thread_totals = []
# closed events while on: (id, parent id or None, name, start, end,
# thread); plain tuples of numbers and strings, which the collector stops
# tracking, so a long traced stretch does not slow its collections
_events = []
_counters = {}   # name -> int or 0-d tensor, while on
_ids = itertools.count()
_local = threading.local()
_on = False


def _totals():
    """This thread's totals, made and registered at its first span."""
    totals = getattr(_local, "totals", None)
    if totals is None:
        totals = _local.totals = {}
        with _lock:
            _thread_totals.append(totals)
    return totals


def _stack():
    """The ids of this thread's open traced spans, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """`with span(name): ...`: the block's host time under `name`."""

    __slots__ = ("name", "t0", "id", "parent", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.id = self.range = None
        if _on:
            self._open()
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        t1 = clock()
        try:
            totals = _local.totals
        except AttributeError:
            totals = _totals()
        totals[self.name] = totals.get(self.name, 0.0) + (t1 - self.t0)
        if self.id is not None:
            self._close(t1)
        return False

    def _open(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        if torch.autograd.profiler._is_profiler_enabled:
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()

    def _close(self, t1):
        stack = _stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        _events.append((self.id, self.parent, self.name, self.t0, t1,
                        threading.get_ident()))
        if self.range is not None:
            self.range.__exit__(None, None, None)


def count(name, n=1):
    """Add n (an int or a 0-d tensor) to counter `name` while tracing is
    on; nothing when off."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled():
    return _on


def reset():
    """Drop the events and counters kept so far; the totals stay."""
    with _lock:
        _events.clear()
        _counters.clear()


def total(*names):
    """The summed host seconds of every span of these names so far, on
    every thread."""
    with _lock:
        return sum(t[n] for t in _thread_totals for n in names if n in t)


def summary():
    """-> {"spans": {name: {"calls", "seconds", "self_seconds"}},
    "counters": {name: int}} over the events and counters kept since the
    last reset (spans still open are left out)."""
    with _lock:
        events = list(_events)
        counters = dict(_counters)
    covered = {}
    for _, parent, _, start, end, _ in events:
        if parent is not None:
            covered[parent] = covered.get(parent, 0.0) + (end - start)
    out = {}
    for id_, _, name, start, end, _ in events:
        s = out.setdefault(name, {"calls": 0, "seconds": 0.0,
                                  "self_seconds": 0.0})
        s["calls"] += 1
        s["seconds"] += end - start
        s["self_seconds"] += end - start - covered.get(id_, 0.0)
    return {"spans": out,
            "counters": {k: int(v) for k, v in counters.items()}}


class TotalsView(Mapping):
    """A read-only mapping whose value at each key is `total` of the span
    names given for it: TotalsView(vm=("d2p.score.replay", "d2p.score.vm"))
    ["vm"] is the seconds of both spans so far."""

    def __init__(self, **names):
        self._names = names

    def __getitem__(self, key):
        return total(*self._names[key])

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)
