"""Readings that set a cell's limits: the program's numbers on many seeds,
the control's (the plain reference in TF32, in the program's place), and
faults planted in the program, each at the cell's own size.

    python3 bench_torch/tools/readings.py --workload <cell> \
        --seeds 1,2,3 --modes program,control,half [--window_steps 150] \
        [--out FILE]

Modes: program (sound runs), control, half (half of each batch left out,
the mean taken over the rest), token (eval: one served token altered where
it is produced), leaves (the worst leaves), direct (train: the late first
gradient's median gap read from the parameters' .grad, beside the one
worked out from Adam's moments). A train cell's numbers are read over its first steps and,
`late_` before each name, over as many steps after `--window_steps` more,
which stand in for the window. Prints one JSON line a seed. The benchmark's
own runs never run this.
"""

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def train_readings(ctx, modes, window_steps=150):
    """Early and late (after `window_steps` steps that stand in for the
    window) readings of the program, and of the modes asked for."""
    from bench_torch.harness.bench import load_module
    from bench_torch.reference import karel_model as ref

    tc = load_module("traffic", "train_cache")
    n, log_step = ctx.params["reference_steps"], ctx.params["log_step"]
    out = {}
    for mode in ["program"] + (["half"] if "half" in modes else []):
        split, trainer, w0, names = tc.setup(ctx)
        if mode == "half":
            batch = trainer.cache.batch

            def half(step, _batch=batch):
                b = _batch(step)
                return {k: v[:v.shape[0] // 2] for k, v in b.items()}
            trainer.cache.batch = half
        early = tc.steps(trainer, names, 0, n)
        s = tc._train(trainer, n, log_step, lambda s: s < n + window_steps)
        s = tc.epoch_aligned(trainer, s, n, log_step)
        if mode == "program" and "direct" in modes:
            direct = _direct_first_gradient(trainer, names)
        late = tc.steps(trainer, names, s, n)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        out[mode] = (early, late)
    res = {}
    late = out["program"][1][2:]
    for prefix, i in (("", 0), ("late_", 1)):
        r = tc.reference(ctx.config, split, out["program"][i], ref.Arith(),
                         ctx.device)
        for mode, stretches in out.items():
            res.setdefault(mode, {}).update(
                {prefix + k: v for k, v in tc.gaps(
                    *stretches[i][2:], *r).items()})
        med = float(np.median(list(r[1].values())))
        res[prefix + "left_out"] = sorted(
            k for k, g in r[1].items() if g < 1e-3 * med)
        # elements that change_gap leaves out in the leaves it keeps, and
        # those of them whose reference gradient is not exactly 0
        kept = [g for k, g in r[3].items() if r[1][k] >= 1e-3 * med]
        small = [g.abs() < 1e-3 * g.double().norm() / g.numel() ** 0.5
                 for g in kept]
        res[prefix + "elements_left_out"] = [
            int(sum(int(m.sum()) for m in small)),
            int(sum(int((m & (g != 0)).sum()) for m, g in zip(small, kept)))]
        if "leaves" in modes:  # the worst leaves of the program's readings
            res[prefix + "leaves"] = worst_leaves(
                *out["program"][i][2:], *r)
        if prefix and "direct" in modes:
            # the late first gradient as the optimizer got it, read from
            # the parameters' .grad rather than from Adam's moments
            res["program"]["late_grad_gap_direct"] = tc.gaps(
                late[0], direct, late[2], *r)["grad_gap_median"]
        if "control" in modes:
            c = tc.reference(ctx.config, split, out["program"][i],
                             ref.Arith(True), ctx.device)
            res.setdefault("control", {}).update(
                {prefix + k: v for k, v in tc.gaps(*c[:3], *r).items()})
    return res


def _direct_first_gradient(trainer, names):
    """-> {name: norm}, filled at the next optimizer step with the clipped
    gradients it is given."""
    opt = trainer.state.optimizer
    params = dict(trainer.model.named_parameters())
    out, step = {}, opt.step

    def first_step(*a, **kw):
        if not out:
            out.update({n: float(params[n].grad.norm()) for n in names})
        return step(*a, **kw)
    opt.step = first_step
    return out


def worst_leaves(losses, first, change, r_losses, r_first, r_change, r_grad,
                 n=4):
    """The leaves behind grad_gap and change_gap: (name, gap, the
    program's and the reference's norms), worst first."""
    from bench_torch.harness.bench import load_module

    tc = load_module("traffic", "train_cache")
    change, r_change = tc.moved_norms(change, r_change, r_grad)
    med_g = float(np.median(list(r_first.values())))
    med_c = float(np.median(list(r_change.values())))
    out = {}
    for key, prog, ref_, med in (("grad", first, r_first, med_g),
                                 ("change", change, r_change, med_c)):
        rows = sorted(((abs(prog[k] - ref_[k]) / max(ref_[k], med), k,
                        prog[k], ref_[k]) for k in ref_), reverse=True)
        out[key] = [[k, g, a, b] for g, k, a, b in rows[:n]]
    out["median"] = [med_g, med_c]
    return out


def eval_readings(ctx, modes):
    from bench_torch.harness import karel
    from bench_torch.harness.bench import load_module
    from bench_torch.reference import karel_model as ref

    eg = load_module("traffic", "eval_greedy")
    cfg, p = ctx.config, ctx.params
    path = eg.checkpoint_path(cfg)
    bs = cfg["eval_batch_size"]
    split = karel.make_split(cfg, p["sample_batches"] * bs,
                             ctx.seed_for("data"))
    evaler = karel.make_evaler(cfg, ctx, split, path)
    # programs from the seed, so that the readings cover more programs
    # than the cell's fixed pool
    records = [eg._batch(evaler, split, b, bs, ctx.device)
               for b in range(p["sample_batches"])]
    res = {"program": eg.compare(cfg, path, split, records, ctx.device)}
    if "half" in modes:
        from demo2program_tpu_torch.train.step import to_device
        half = []
        for r in records:
            raw = split.get_batch_compact(r["ids"][:bs // 2])
            report, _ = evaler.eval_step(to_device(raw, ctx.device))
            half.append(dict(r, loss=float(report["program_loss"])))
        res["half"] = eg.compare(cfg, path, split, half, ctx.device)
    if "token" in modes:
        bad = []
        for r in records:
            tokens = r["tokens"].copy()
            tokens[0, 0] = (tokens[0, 0] + 1) % cfg["dim_program_token"]
            bad.append(dict(r, tokens=tokens))
        res["token"] = {k: v for k, v in eg.compare(
            cfg, path, split, bad, ctx.device).items() if "token" in k
            or "gap" in k}
    del evaler
    gc.collect()
    torch.cuda.empty_cache()
    if "control" in modes:
        w, stats = eg.reference_weights(path, cfg, ctx.device)
        gap = {"loss_gap": 0.0, "greedy_loss_gap": 0.0, "token_gap": 0.0}
        for r in records:
            compact = split.get_batch_compact(r["ids"])
            f, along, fg = ref.eval_logits(w, stats, cfg, compact,
                                           r["tokens"], ref.Arith(),
                                           ctx.device)
            c, along_c, cg = ref.eval_logits(w, stats, cfg, compact,
                                             r["tokens"], ref.Arith(True),
                                             ctx.device)
            gap["loss_gap"] = max(gap["loss_gap"], abs(c - f) / f)
            gap["greedy_loss_gap"] = max(gap["greedy_loss_gap"],
                                         abs(cg - fg) / fg)
            gap["token_gap"] = max(gap["token_gap"], float(ref.widest_gaps(
                along, along_c.argmax(-1).cpu().numpy(), r["len"]).max()))
        res["control"] = gap
    return res


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program,control")
    p.add_argument("--device", default="cuda")
    p.add_argument("--window_steps", type=int, default=150,
                   help="train cells: steps between the early and the late "
                   "readings, standing in for the window")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    from bench_torch.harness.bench import Context
    if args.device == "cuda":
        from demo2program_tpu_torch.train.step import (
            deterministic_cuda, full_precision_matmuls)
        deterministic_cuda()
        full_precision_matmuls()
    modes = args.modes.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(args.workload, seed, 0, 0, args.device)
        kind = ctx.cell["traffic"]
        if kind == "train_cache":
            res = train_readings(ctx, modes, args.window_steps)
        else:
            res = eval_readings(ctx, modes)
        line = json.dumps({"workload": args.workload, "seed": seed, **res})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
