"""Traffic driver: training from the device cache, as `Trainer.train` runs
its loop (train/trainer.py: `cache.batch(s)`, `train_step(batch)`, and the
report's fetch to the host every `log_step` steps).

Parameters (the cell file's `params`):
  programs          the train split's size, generated from the seed
  log_step          the trainer's log cadence: a report fetch every N steps
  reference_steps   the steps the plain reference follows, at the start
                    and again after the window
  warmup_steps      steps taken before the window (the first ones included)
  profile_steps     steps profiled in a `--trace 1` run, after the window

Set-up builds one Trainer from trainer_cli's parser with the configuration's
flags, loads the benchmark's weights into it, and drives its own step
through `reference_steps` steps on the cache's first batches (rows that all
differ), reading each step's loss, the first clipped gradient from Adam's
first moment after one step, and the parameters after the last; then it
warms up to `warmup_steps`. The window trains for `--seconds` and ends at a
synchronise after its last step. After the window the same Trainer takes
`reference_steps` more steps through the window's own call, from a
snapshot of its parameters, Adam's moments and step count, read the same
way: what the window's step does once warmed up is compared too. Once the
program is freed, the plain reference takes both stretches of steps from
the same states on the same rows, and the numbers are compared.
"""

import gc
import time

import numpy as np
import torch

from bench_torch.harness import karel, weights
from bench_torch.harness.trace import Trace
from bench_torch.reference import karel_model as ref
from bench_torch.counts import model_flops


def snapshot(trainer, names):
    """The train state the next step starts from: {"params", "m", "v"}
    by leaf name (the moments None before the first update) and "t", the
    updates applied."""
    opt = trainer.state.optimizer
    params = dict(trainer.model.named_parameters())
    out = {"params": {n: params[n].detach().clone() for n in names},
           "m": None, "v": None, "t": int(trainer.state.step)}
    if all(p in opt.state for p in params.values()):
        for key, moment in (("m", "exp_avg"), ("v", "exp_avg_sq")):
            out[key] = {n: opt.state[params[n]][moment].detach().clone()
                        for n in names}
    return out


def _clipped_gradient_norms(trainer, names, m0):
    """Per leaf, the norm of the clipped gradient of the step just taken,
    from Adam's first moment before it (m0, None for zeros) and after it:
    m1 = b1 m0 + (1 - b1) g."""
    opt = trainer.state.optimizer
    b1 = opt.param_groups[0]["betas"][0]
    params = dict(trainer.model.named_parameters())
    out = {}
    for n in names:
        m1 = opt.state.get(params[n], {}).get("exp_avg")
        if m1 is None:  # no update was taken
            out[n] = 0.0
            continue
        g = m1 if m0 is None else m1 - b1 * m0[n]
        out[n] = float(g.norm()) / (1 - b1)
    return out


def _install_lstm_ranges(calls):
    """Wrap FusedLSTMCell.forward in a `bench.lstm_step` range and log each
    call's (B, D, H, dtype) -> a function that takes the wrapper away."""
    from demo2program_tpu_torch.ops.fused_lstm import FusedLSTMCell

    original = FusedLSTMCell.forward

    def forward(self, carry, x):
        with torch.profiler.record_function("bench.lstm_step"):
            calls.append((x.shape[0], x.shape[1], self.kernel.shape[1] // 4,
                          str(self.kernel.dtype).replace("torch.", "")))
            return original(self, carry, x)

    FusedLSTMCell.forward = forward

    def restore():
        FusedLSTMCell.forward = original
    return restore


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def setup(ctx):
    """The cell's split, its Trainer with the benchmark's weights loaded,
    those weights, and the parameters' names."""
    p, cfg = ctx.params, ctx.config
    split = karel.make_split(cfg, p["programs"], ctx.seed_for("data"))
    trainer = karel.make_trainer(cfg, ctx, split, p["log_step"])
    names = [n for n, _, _ in ref.param_specs(cfg)]
    w0 = weights.make(ref.param_specs(cfg), ctx.seed_for("weights"),
                      ctx.device)
    weights.load(trainer.model, w0)
    return split, trainer, w0, names


def steps(trainer, names, s, n):
    """The Trainer's own step over the cache's batches s .. s + n - 1 ->
    (the state they start from, their rows, each step's loss, the first
    step's clipped gradient norms, the parameters' change on the CPU)."""
    cache = trainer.cache
    start = snapshot(trainer, names)
    rows = [cache.indices(s + i).cpu().numpy() for i in range(n)]
    losses, first = [], None
    for i in range(n):
        report = trainer.train_step(cache.batch(s + i))
        losses.append(float(report["loss"]))
        if i == 0:
            first = _clipped_gradient_norms(trainer, names, start["m"])
    params = dict(trainer.model.named_parameters())
    change = {k: (params[k].detach() - start["params"][k]).cpu()
              for k in names}
    return start, rows, losses, first, change


def epoch_aligned(trainer, s, n, log_step):
    """Step s, or the next epoch's first, so that the n steps from it
    train on rows that all differ: the trainer's loop is driven there."""
    per_epoch = trainer.cache.steps_per_epoch
    if s % per_epoch + n <= per_epoch:
        return s
    end = (s // per_epoch + 1) * per_epoch
    return _train(trainer, s, log_step, lambda s: s < end)


def _train(trainer, s, log_step, more):
    """The trainer's loop body from step s while more(s) -> the step
    reached."""
    while more(s):
        report = trainer.train_step(trainer.cache.batch(s))
        s += 1
        if s % log_step == 0:
            trainer._fetch(report)
    return s


def run(ctx):
    p, cfg = ctx.params, ctx.config
    split, trainer, w0, names = setup(ctx)
    n_ref, log_step = p["reference_steps"], p["log_step"]
    early = steps(trainer, names, 0, n_ref)
    s = _train(trainer, n_ref, log_step, lambda s: s < p["warmup_steps"])
    _sync(ctx.device)

    # the window
    setup_s = ctx.setup_s()
    t0 = time.perf_counter()
    start = s
    s = _train(trainer, s, log_step,
               lambda _: time.perf_counter() - t0 < ctx.seconds)
    _sync(ctx.device)
    window = time.perf_counter() - t0
    n_steps = s - start
    bs = cfg["batch_size"]

    layer = {}
    if ctx.trace:
        calls = []
        restore = _install_lstm_ranges(calls)
        end = s + p["profile_steps"]
        try:
            with Trace(ctx.device) as tr:
                s = _train(trainer, s, log_step, lambda s: s < end)
        finally:
            restore()
        layer = tr.reduce("bench.lstm_step") or {}
        layer.update(
            lstm_calls=calls, flops_per_step=model_flops.train_step_flops(
                cfg), steps_off=n_steps, seconds_off=window,
            traced_steps=p["profile_steps"], step_s=window / n_steps)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(ctx.device).type == "cuda" else 0)

    late = steps(trainer, names, epoch_aligned(trainer, s, n_ref, log_step),
                 n_ref)
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
    same state, on the same rows."""
    start, rows = stretch[:2]
    batches = [{k: v[r] for k, v in split.arr.items()} for r in rows]
    return ref.train(cfg, start, batches, ar, device)


def compare(cfg, split, early, late, ctx):
    """The program's readings against the plain reference's, over the
    first steps and over the steps after the window (`late_` before each
    name) -> {number: value}; a cell compares those its `limits` name:

      loss_gap         the widest relative gap of a step's loss;
      grad_gap         the worst leaf's gap between the norms of the first
                       clipped gradient, over the larger of that leaf's
                       reference norm and the median leaf's;
      grad_gap_median  the median leaf's of those gaps: steady where one
                       leaf's long reduction (the first conv's weight
                       gradient, summed over every frame) swings the worst;
      change_gap       the worst leaf's gap for the norm of each leaf's
                       change over the steps, leaving out what moves by
                       rounding alone under Adam: leaves whose first
                       reference gradient is under a thousandth of the
                       median leaf's, and elements whose first reference
                       gradient is under a thousandth of their leaf's root
                       mean square (a conv bias whose channel the leaky
                       ReLU passes whole is one: batch norm cancels it,
                       and Adam turns its rounding into a step that can
                       carry the channel across the ReLU's kink)."""
    out = {}
    for prefix, stretch in (("", early), ("late_", late)):
        r = reference(cfg, split, stretch, ref.Arith(), ctx.device)
        out.update({prefix + k: v
                    for k, v in gaps(*stretch[2:], *r).items()})
    return out


def moved_norms(change, r_change, r_grad):
    """-> ({leaf: the norm of the program's change}, the same of the
    reference's), each over the elements whose first reference gradient is
    at least a thousandth of their leaf's root mean square (in float64:
    the CPU's float32 norm of a large leaf is off by some 1e-4)."""
    prog, ref_ = {}, {}
    for n, g in r_grad.items():
        g = g.double()
        keep = g.abs() >= 1e-3 * g.norm() / g.numel() ** 0.5
        prog[n] = float(change[n][keep].double().norm())
        ref_[n] = float(r_change[n][keep].double().norm())
    return prog, ref_


def gaps(losses, first, change, r_losses, r_first, r_change, r_grad):
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
    med_g = float(np.median(list(r_first.values())))
    grad = [abs(first[n] - r_first[n]) / max(r_first[n], med_g)
            for n in r_first]
    change, r_change = moved_norms(change, r_change, r_grad)
    med_c = float(np.median(list(r_change.values())))
    moved = [n for n in r_change if r_first[n] >= 1e-3 * med_g]
    change_gap = max(abs(change[n] - r_change[n]) / max(r_change[n], med_c)
                     for n in moved)
    return {"loss_gap": loss_gap, "grad_gap": max(grad),
            "grad_gap_median": float(np.median(grad)),
            "change_gap": change_gap}
