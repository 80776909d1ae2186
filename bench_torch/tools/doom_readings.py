"""Readings that set the ViZDoom train cell's limits: the program's numbers
on many seeds, the control's (the plain reference in TF32, in the
program's place) and the half batch's (half of each batch left out, the
mean taken over the rest), at the cell's own size, as tools/readings.py
reads the Karel train cells.

    python3 bench_torch/tools/doom_readings.py --workload vizdoom_full-train \
        --seeds 1,2,3 --window_steps 0,150,300,450 \
        [--modes program,control,half] [--out FILE]

The numbers are read over the first steps and, `late_` before each name,
over as many steps after `--window_steps` more, which stand in for the
window; seed i takes the i-th entry of the list (cycled), so the late
stretches start at step counts spread over what a window reaches. Prints
one JSON line a seed. The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def readings(ctx, modes, window_steps):
    """{mode: {number: gap}} of one seed, and where its late stretch
    started."""
    from bench_torch.harness.bench import load_module
    from bench_torch.reference import vizdoom_model as ref

    dc = load_module("traffic", "doom_train_cache")
    tc = dc.tc
    n, log_step = ctx.params["reference_steps"], ctx.params["log_step"]
    out = {}
    for mode in ["program"] + (["half"] if "half" in modes else []):
        split, trainer, names, cfg = dc.setup(ctx)
        if mode == "half":
            batch = trainer.cache.batch

            def half(step, _batch=batch):
                b = _batch(step)
                return {k: v[:v.shape[0] // 2] for k, v in b.items()}
            trainer.cache.batch = half
        early = dc.steps(trainer, names, 0, n)
        s = tc._train(trainer, n, log_step, lambda s: s < n + window_steps)
        s = tc.epoch_aligned(trainer, s, n, log_step)
        late = dc.steps(trainer, names, s, n)
        del trainer
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        out[mode] = (early, late)
    res = {"late_start": s}
    for prefix, i in (("", 0), ("late_", 1)):
        r = dc.reference(cfg, split, out["program"][i], ref.Arith(),
                         ctx.device)
        for mode, stretches in out.items():
            res.setdefault(mode, {}).update(
                {prefix + k: v for k, v in tc.gaps(
                    *stretches[i][2:], *r).items()})
        if "control" in modes:
            c = dc.reference(cfg, split, out["program"][i],
                             ref.Arith(True), ctx.device)
            res.setdefault("control", {}).update(
                {prefix + k: v for k, v in tc.gaps(*c[:3], *r).items()})
    return res


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="vizdoom_full-train")
    p.add_argument("--seeds", required=True)
    p.add_argument("--window_steps", default="150",
                   help="steps between the early and the late readings, "
                   "one entry a seed, cycled")
    p.add_argument("--modes", default="program,control")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    from bench_torch.harness.bench import Context
    if args.device == "cuda":
        from demo2program_tpu_torch.train.step import (
            deterministic_cuda, full_precision_matmuls)
        deterministic_cuda()
        full_precision_matmuls()
    modes = args.modes.split(",")
    windows = [int(w) for w in args.window_steps.split(",")]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        ctx = Context(args.workload, seed, 0, 0, args.device)
        w = windows[i % len(windows)]
        res = readings(ctx, modes, w)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "window_steps": w, **res})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
