"""The program's own spans and counters (demo2program_tpu_torch/utils/
spans.py) read on a cell: the readings of the per-layer metrics that the
spans are for, where the time of a step or batch goes by span, and what
tracing costs.

    python3 bench_torch/tools/span_readings.py --workload <cell> --seed <n> \
        --seconds <s> [--out FILE]

Sets up as the cell's traffic module does (bench_torch/traffic/), warms up,
and runs a window of `--seconds` with tracing off: the step or batch time
that tracing's cost is taken against. Then two stretches:

  (a) the cell's `profile_steps` train steps, or 4 eval batches, each run
      twice, tracing off and on in turn (an eval batch: the same batch),
      each to a synchronise; profiler off. The metrics (`METRICS`) and
      `spans` (per span name: calls, inclusive and self host ms a step or
      batch) are read from the traced runs;
  (b) tracing on, under the profiler: `profile_steps` / `profile_batches`.
      `idle_spans`: the device's idle seconds by the innermost `d2p.*`
      range open at each gap's middle, on any thread (the latest started),
      "no span" where none is; `idle_gaps`: the same gaps by host op, the
      `d2p.*` ranges left out, as the cell's own trace names them.

Besides: `coverage` (the phases' share of the step span, the step span's
share of a traced step; the scorer's replay and VM share of a traced
batch), tracing's cost (`cost`: a traced step or batch of stretch (a) over
one of the window, less 1; `cost_paired`: over one untraced of stretch
(a)) and the host cost of one span off and on (`span_ns`). Prints one
JSON line. Needs the card, as the benchmark does.
"""

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch.harness import trace  # noqa: E402

EVAL_STRETCH_BATCHES = 4


def _span(layer, name, key="ms"):
    s = layer.get("spans", {}).get(name)
    return None if s is None else s[key]


def _counter(layer, name):
    return layer.get("counters", {}).get(name)


def _vm_step_us(layer):
    vm, steps = _span(layer, "d2p.score.vm"), _counter(layer, "vm.steps")
    return 1e3 * vm / steps if vm is not None and steps else None


def _vm_live_share(layer):
    live = _counter(layer, "vm.live_machine_steps")
    machine = _counter(layer, "vm.machine_steps")
    return 100.0 * live / machine if live is not None and machine else None


# per-layer metric -> its reading from a stretch's `layer` ({"spans":
# {name: {"calls", "ms", "self_ms"} a step or batch}, "counters": {name:
# a step or batch}}); None where the stretch has nothing to read
METRICS = {
    "train.forward_host_ms": lambda l: _span(l, "d2p.train.forward"),
    "train.backward_host_ms": lambda l: _span(l, "d2p.train.backward"),
    "train.update_host_ms": lambda l: _span(l, "d2p.train.update"),
    "train.lstm_backward_host_ms": lambda l: _span(l, "d2p.lstm.backward"),
    "eval.replay_ms": lambda l: _span(l, "d2p.score.replay"),
    "eval.vm_steps_per_batch": lambda l: _counter(l, "vm.steps"),
    "eval.vm_step_us": _vm_step_us,
    "eval.vm_live_share": _vm_live_share,
}


def per_step(summary, n):
    """spans.summary() over n steps or batches -> the stretch's `layer`."""
    return {"spans": {k: {"calls": v["calls"] / n,
                          "ms": 1e3 * v["seconds"] / n,
                          "self_ms": 1e3 * v["self_seconds"] / n}
                      for k, v in summary["spans"].items()},
            "counters": {k: v / n for k, v in summary["counters"].items()}}


def _is_span(name):
    return name.startswith("d2p.")


def idle_spans(events):
    """Device idle seconds of a profiled stretch by the innermost `d2p.*`
    range open at each gap's middle, on any thread, the latest started
    ("no span" where none is) -> [[name, seconds]], the largest first. The
    gaps are harness/trace.py's: between the union of device intervals,
    from the stretch's first host event to its last end."""
    annotations = {e.name() for e in events
                   if "cuda" not in str(e.device_type()).lower()
                   and trace._flag(e, "is_user_annotation")}
    device, host, ranges = [], [], []
    for e in events:
        kind = trace._kind(e, annotations)
        s = e.start_ns()
        end = s + e.duration_ns()
        if kind in trace.DEVICE_KINDS:
            device.append((s, end))
        elif kind in ("runtime", "range", "op"):
            host.append((s, end))
            if kind == "range" and _is_span(e.name()):
                ranges.append((s, end, e.name(), e.start_thread_id()))
    if not device:
        return None
    busy = trace._merge(device)
    t0 = min([s for s, _ in host] + [busy[0][0]])
    t1 = max(busy[-1][1], max((e for _, e in host), default=0))
    gaps = [(a[1], b[0]) for a, b in zip([[t0, t0]] + busy, busy + [[t1, t1]])
            if b[0] > a[1]]
    names = trace._innermost(ranges, [(a + b) / 2 for a, b in gaps])
    idle = collections.Counter()
    for (a, b), name in zip(gaps, names):
        idle["no span" if name == "idle host" else name] += (b - a) / 1e9
    return [[n, v] for n, v in idle.most_common()]


def reduce_stretch(events):
    """A profiled stretch's `idle_spans`, and its `idle_gaps` and
    `device_ops` from harness/trace.py with the `d2p.*` ranges (host and
    device) left out, so a range never names a gap there."""
    ops = trace.reduce_events([e for e in events if not _is_span(e.name())],
                              "bench.lstm_step") or {}
    return {"idle_spans": idle_spans(events),
            "idle_gaps": ops.get("idle_gaps"),
            "device_ops": ops.get("device_ops"),
            "busy_s": ops.get("busy_s")}


def span_ns(n=100000):
    """Host ns of one empty span, tracing off and on (profiler off), and
    how many of the on spans entered a profiler range (0 expected)."""
    from demo2program_tpu_torch.utils import spans

    out = {"ranged": 0}
    for mode in ("off", "on"):
        if mode == "on":
            spans.enable()
        t0 = time.perf_counter()
        for _ in range(n):
            with spans.span("bench.cost") as s:
                pass
        out[mode] = 1e9 * (time.perf_counter() - t0) / n
        out["ranged"] += s.range is not None
        spans.disable()
        spans.reset()
    return out


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(device, fn):
    """Seconds of fn(), from a synchronise to a synchronise."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def _stretches(ctx, do, items, profiled):
    """Stretch (a): do(item) for each of `items` twice, tracing off and on
    in turn (off first on even items), each timed to a synchronise; then
    (b): do(item) for each of `profiled` under the profiler, tracing on ->
    (seconds an item on, the same off, (a)'s readings, (b)'s)."""
    from demo2program_tpu_torch.utils import spans

    seconds = {False: 0.0, True: 0.0}
    spans.reset()
    try:
        for i, item in enumerate(items):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                if on:
                    spans.enable()
                seconds[on] += _timed(ctx.device, lambda: do(item))
                spans.disable()
        layer = per_step(spans.summary(), len(items))
        spans.reset()
        spans.enable()
        with trace.Trace(ctx.device) as tr:
            for item in profiled:
                do(item)
    finally:
        spans.disable()
        spans.reset()
    events = tr.prof.profiler.kineto_results.events()
    n = len(items)
    return seconds[True] / n, seconds[False] / n, layer, reduce_stretch(
        events)


def train(ctx):
    from bench_torch.harness.bench import load_module

    tc = load_module("traffic", "train_cache")
    p = ctx.params
    _, trainer, _, _ = tc.setup(ctx)
    log_step = p["log_step"]
    s = tc._train(trainer, 0, log_step, lambda s: s < p["warmup_steps"])
    _sync(ctx.device)
    t0 = time.perf_counter()
    start = s
    s = tc._train(trainer, s, log_step,
                  lambda _: time.perf_counter() - t0 < ctx.seconds)
    _sync(ctx.device)
    window_s = (time.perf_counter() - t0) / (s - start)
    at = [s]

    def one_step(_):
        at[0] = tc._train(trainer, at[0], log_step, lambda s: s == at[0])

    n = p["profile_steps"]
    on_s, off_s, layer, b = _stretches(ctx, one_step, [None] * n, [None] * n)
    sp = layer["spans"]
    step = sp["d2p.train.step"]["ms"]
    phases = sum(sp[k]["ms"] for k in ("d2p.train.forward",
                                       "d2p.train.backward",
                                       "d2p.train.update"))
    coverage = {"phases_of_step_span": phases / step,
                "step_span_of_step": step / (1e3 * on_s)}
    return window_s, s - start, on_s, off_s, layer, b, coverage


def evaluate(ctx):
    from bench_torch.harness import karel
    from bench_torch.harness.bench import load_module

    eg = load_module("traffic", "eval_greedy")
    p, cfg = ctx.params, ctx.config
    path = eg.checkpoint_path(cfg)
    split = karel.make_split(cfg, p["programs"], p["data_seed"])
    if "pool_sha256" in p and eg.pool_digest(split) != p["pool_sha256"]:
        raise ValueError(f"the pool of data_seed {p['data_seed']} is not "
                         f"the cell's")
    evaler = karel.make_evaler(cfg, ctx, split, path)
    bs = cfg["eval_batch_size"]
    order = eg.batch_order(len(split.ids) // bs, ctx.seed_for("order"))
    for _ in range(p["warmup_batches"]):
        eg._batch(evaler, split, next(order), bs, ctx.device)
    t0 = time.perf_counter()
    done = []
    while time.perf_counter() - t0 < ctx.seconds:
        done.append(eg._batch(evaler, split, next(order), bs, ctx.device))
    window_s = (done[-1]["end"] - t0) / len(done)

    def one_batch(b):
        eg._batch(evaler, split, b, bs, ctx.device)

    on_s, off_s, layer, b = _stretches(
        ctx, one_batch, [next(order) for _ in range(EVAL_STRETCH_BATCHES)],
        [next(order) for _ in range(p["profile_batches"])])
    sp = layer["spans"]
    scored = sum(sp[k]["ms"] for k in ("d2p.score.replay", "d2p.score.vm")
                 if k in sp)
    coverage = {"replay_and_vm_of_batch": scored / (1e3 * on_s)}
    return window_s, len(done), on_s, off_s, layer, b, coverage


def run(ctx):
    """-> the tool's result for ctx's cell."""
    kind = ctx.cell["traffic"]
    window_s, n_window, on_s, off_s, layer, b, coverage = (
        train(ctx) if kind == "train_cache" else evaluate(ctx))
    metrics = {name: read(layer) for name, read in METRICS.items()}
    return {"workload": ctx.name, "seed": ctx.seed,
            "metrics": {k: v for k, v in metrics.items() if v is not None},
            "window_step_ms": 1e3 * window_s, "window_steps": n_window,
            "stretch_a_step_ms": 1e3 * on_s, "stretch_a_off_ms": 1e3 * off_s,
            "cost": on_s / window_s - 1.0, "cost_paired": on_s / off_s - 1.0,
            "coverage": coverage, "spans": layer["spans"],
            "counters": layer["counters"], **b, "span_ns": span_ns()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    from bench_torch.harness.bench import Context
    from demo2program_tpu_torch.train.step import (
        deterministic_cuda, full_precision_matmuls)
    if not torch.cuda.is_available():
        print("span_readings.py needs a CUDA card", file=sys.stderr)
        return 2
    deterministic_cuda()
    full_precision_matmuls()
    ctx = Context(args.workload, args.seed, args.seconds, 1, "cuda")
    result = dict(run(ctx), device=torch.cuda.get_device_name(0))
    line = json.dumps(result)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
