"""Traffic driver: ViZDoom training from the device cache, as
`Trainer.train` runs its loop (train/trainer.py: `cache.batch(s)`,
`train_step(batch)`, and the report's fetch to the host every `log_step`
steps), on the ViZDoom split's DoomDeviceCache.

Parameters (the cell file's `params`):
  programs, data_seed, shards, per_shard
                    the pool: the first `programs` distinct programs of
                    `shards` generator runs of `per_shard` programs from
                    seeds data_seed, data_seed + 1, ... (harness/vizdoom.py)
  pool_sha256, pool_T, pool_L
                    the pool's contents' digest, its longest demo and its
                    longest program, checked at every load
  log_step, reference_steps, warmup_steps, profile_steps
                    as in traffic/train_cache.py

The run is traffic/train_cache.py's: one Trainer from trainer_cli's parser
with the configuration's flags and the benchmark's weights, the early
stretch of `reference_steps` steps, the warm-up, the window, and the late
stretch from a snapshot after it; the cache's batch order is drawn from
the run's seed. The plain reference (reference/vizdoom_model.py) takes
both stretches from the same states on the same items, read from the
generator's arrays rather than from the cache, and the same numbers are
compared.

A `--trace 1` run profiles `profile_steps` steps after the window with the
program's tracing on (utils/spans.py), and reads, besides what the Karel
train cells read, the device time of the kernels launched inside the
`d2p.encoder.frames` and `d2p.encoder.rn` ranges and the `encoder.frames`
and `encoder.rn_rows` counters. A program without those spans leaves the
encoder's metrics out.
"""

import gc
import time

import numpy as np
import torch

from bench_torch.counts import vizdoom_full
from bench_torch.harness import vizdoom, weights
from bench_torch.harness.bench import load_module
from bench_torch.harness.trace import Trace
from bench_torch.reference import vizdoom_model as ref

tc = load_module("traffic", "train_cache")


def setup(ctx):
    """The cell's pool, its Trainer with the benchmark's weights loaded,
    the parameters' names and the reference's configuration."""
    p, cfg = ctx.params, ctx.config
    split = vizdoom.load_pool(cfg, p, check="pool_sha256" in p)
    trainer = vizdoom.make_trainer(cfg, ctx, split, p["log_step"])
    # the configuration with the pool's T and L, as the model sees them
    rcfg = dict(cfg, max_demo_len=split.max_demo_len,
                max_program_len=split.max_program_len)
    mc = trainer.cfg
    seen = {"dim_program_token": mc.dim_program_token,
            "action_space": mc.action_space, "per_dim": mc.per_dim,
            "h": mc.h, "w": mc.w, "depth": mc.depth, "num_k": mc.k,
            "max_demo_len": mc.max_demo_len,
            "max_program_len": mc.max_program_len}
    wrong = {k: v for k, v in seen.items() if v != rcfg[k]}
    if wrong:
        raise ValueError(f"the pool's sizes {wrong} are not the "
                         f"configuration's")
    # the cache draws a fresh permutation whenever the next batch would run
    # past the split: n // bs draws of distinct rows each
    trainer.cache.steps_per_epoch = trainer.cache.n // cfg["batch_size"]
    specs = ref.param_specs(rcfg)
    w0 = weights.make(specs, ctx.seed_for("weights"), ctx.device)
    weights.load(trainer.model, w0)
    return split, trainer, [n for n, _, _ in specs], rcfg


def steps(trainer, names, s, n):
    """traffic/train_cache.py:steps on the ViZDoom cache, whose rows are
    host arrays."""
    cache = trainer.cache
    start = tc.snapshot(trainer, names)
    rows = [np.asarray(cache.indices(s + i)) for i in range(n)]
    losses, first = [], None
    for i in range(n):
        report = trainer.train_step(cache.batch(s + i))
        losses.append(float(report["loss"]))
        if i == 0:
            first = tc._clipped_gradient_norms(trainer, names, start["m"])
    params = dict(trainer.model.named_parameters())
    change = {k: (params[k].detach() - start["params"][k]).cpu()
              for k in names}
    return start, rows, losses, first, change


def traced(trainer, s, n, log_step, device):
    """n steps from s profiled with the program's tracing on -> (the step
    reached, the forward LSTM calls, the trace, the spans' summary)."""
    from demo2program_tpu_torch.utils import spans

    calls, end = [], s + n
    restore = tc._install_lstm_ranges(calls)
    spans.reset()
    spans.enable()
    try:
        with Trace(device) as tr:
            s = tc._train(trainer, s, log_step, lambda t: t < end)
    finally:
        spans.disable()
        restore()
    summary = spans.summary()
    spans.reset()
    return s, calls, tr, summary


def encoder_readings(tr, summary, cfg):
    """The encoder's ranges' device seconds, calls and counters, and the
    shapes their least times need; empty where the program has no such
    spans."""
    out = {}
    calls = {name: s["calls"] for name, s in summary["spans"].items()}
    counters = summary["counters"]
    for key, span, counter in (
            ("frames", "d2p.encoder.frames", "encoder.frames"),
            ("rn", "d2p.encoder.rn", "encoder.rn_rows")):
        if not calls.get(span) or counter not in counters:
            continue
        r = tr.reduce(span)
        if r and r["ranges"]:
            out.update({f"{key}_device_s": r["range_device_s"],
                        f"{key}_calls": calls[span],
                        f"{key}_count": counters[counter]})
    out.update(frame_shape=[cfg["h"], cfg["w"], cfg["depth"]],
               units=cfg["num_lstm_cell_units"], batch_size=cfg[
                   "batch_size"], num_k=cfg["num_k"])
    return out


def run(ctx):
    p = ctx.params
    split, trainer, names, cfg = setup(ctx)
    n_ref, log_step = p["reference_steps"], p["log_step"]
    early = steps(trainer, names, 0, n_ref)
    s = tc._train(trainer, n_ref, log_step, lambda s: s < p["warmup_steps"])
    tc._sync(ctx.device)

    # the window
    setup_s = ctx.setup_s()
    t0 = time.perf_counter()
    start = s
    s = tc._train(trainer, s, log_step,
                  lambda _: time.perf_counter() - t0 < ctx.seconds)
    tc._sync(ctx.device)
    window = time.perf_counter() - t0
    n_steps = s - start
    bs = cfg["batch_size"]

    layer = {}
    if ctx.trace:
        s, calls, tr, summary = traced(trainer, s, p["profile_steps"],
                                       log_step, ctx.device)
        layer = tr.reduce("bench.lstm_step") or {}
        layer.update(encoder_readings(tr, summary, cfg))
        layer.update(
            lstm_calls=calls,
            flops_per_step=vizdoom_full.train_step_flops(cfg),
            steps_off=n_steps, seconds_off=window,
            traced_steps=p["profile_steps"], step_s=window / n_steps)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(ctx.device).type == "cuda" else 0)

    late = steps(trainer, names,
                 tc.epoch_aligned(trainer, s, n_ref, log_step), n_ref)
    del trainer
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()

    numbers = compare(cfg, split, early, late, ctx)
    return {
        "attempted": n_steps * bs, "failed": 0,
        "e2e": {"train_programs_per_s": n_steps * bs / window,
                "setup_s": setup_s},
        "numbers": numbers, "layer": layer, "memory_peak_bytes": peak}


def reference(cfg, split, stretch, ar, device):
    """The plain reference over a stretch of `steps`' readings: from the
    same state, on the generator's arrays of the same items."""
    start, rows = stretch[:2]
    batches = [[split._store[split.ids[i]] for i in r] for r in rows]
    return ref.train(cfg, start, batches, ar, device)


def compare(cfg, split, early, late, ctx):
    """traffic/train_cache.py:compare's numbers, against the ViZDoom
    reference."""
    out = {}
    for prefix, stretch in (("", early), ("late_", late)):
        r = reference(cfg, split, stretch, ref.Arith(), ctx.device)
        out.update({prefix + k: v
                    for k, v in tc.gaps(*stretch[2:], *r).items()})
    return out
