"""Where a cell's runs spread: each run a new process, as the benchmark's,
with what the host did in its windows read beside the rate.

    python3 bench_torch/tools/steady.py --workload <train cell> \
        --seeds 1,2,3 --seconds 15 [--windows 2] [--out FILE]
    python3 bench_torch/tools/steady.py --workload <eval cell> \
        --data_seeds 1,2,3 [--out FILE]

A train cell's run sets up as the benchmark does, then trains `--windows`
windows of `--seconds` each back to back, and reads for each: the rate,
every step's host seconds (the loop is host-bound, so a step's call
returns about when the host has dispatched it), the collector's pauses,
the CPU the process ran on, its context switches, its user and system
seconds, and the machine's steal and load.

An eval cell's run scores every batch of a 400-program pool from each data
seed once, in order, and reads each batch's seconds, VM seconds and longest
decoded program: the pool's rate, and the spread that a window of
`--seconds` over seeded batch orders would read.
"""

import argparse
import gc
import json
import os
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def _proc():
    """This process's CPU, user and system seconds, context switches, and
    the machine's steal seconds and 1-minute load (None where the kernel
    does not say)."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    out = {"user_s": use.ru_utime, "sys_s": use.ru_stime,
           "vol_cs": use.ru_nvcsw, "invol_cs": use.ru_nivcsw,
           "cpu": None, "steal_s": None, "load": None}
    try:
        with open("/proc/self/stat") as f:
            out["cpu"] = int(f.read().rsplit(")", 1)[1].split()[36])
        with open("/proc/stat") as f:
            out["steal_s"] = int(f.readline().split()[8]) / os.sysconf(
                "SC_CLK_TCK")
        with open("/proc/loadavg") as f:
            out["load"] = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        pass
    return out


def _delta(a, b):
    return {k: ([a[k], b[k]] if k in ("cpu", "load") or a[k] is None
                else b[k] - a[k]) for k in a}


def train_child(args):
    import torch
    from bench_torch.harness.bench import Context, load_module
    from demo2program_tpu_torch.train.step import (
        deterministic_cuda, full_precision_matmuls)
    if args.device == "cuda":
        deterministic_cuda()
        full_precision_matmuls()
    ctx = Context(args.workload, args.seed, args.seconds, 0, args.device)
    tc = load_module("traffic", "train_cache")
    p = ctx.params
    _, trainer, _, names = tc.setup(ctx)
    tc.steps(trainer, names, 0, p["reference_steps"])
    s = tc._train(trainer, p["reference_steps"], p["log_step"],
                  lambda s: s < p["warmup_steps"])
    tc._sync(ctx.device)
    setup_s = ctx.setup_s()
    pauses = []

    def on_gc(phase, info):
        if phase == "start":
            on_gc.t = time.perf_counter()
        else:
            pauses.append((info["generation"], time.perf_counter() - on_gc.t))
    gc.callbacks.append(on_gc)
    windows = []
    for _ in range(args.windows):
        del pauses[:]
        before = _proc()
        t0 = time.perf_counter()
        marks = []
        while time.perf_counter() - t0 < args.seconds:
            report = trainer.train_step(trainer.cache.batch(s))
            s += 1
            if s % p["log_step"] == 0:
                trainer._fetch(report)
            marks.append(time.perf_counter())
        tc._sync(ctx.device)
        seconds = time.perf_counter() - t0
        steps = [b - a for a, b in zip([t0] + marks, marks)]
        half = len(steps) // 2
        windows.append({
            "rate": len(steps) * ctx.config["batch_size"] / seconds,
            "steps": len(steps), "seconds": seconds,
            "step_ms_q": [1e3 * q for q in statistics.quantiles(steps, n=4)],
            "first_half_ms": 1e3 * statistics.mean(steps[:half]),
            "second_half_ms": 1e3 * statistics.mean(steps[half:]),
            "gc": [len(pauses), sum(d for _, d in pauses),
                   sum(1 for g, _ in pauses if g == 2)],
            "proc": _delta(before, _proc()), "step_s": steps})
    return {"seed": args.seed, "setup_s": setup_s,
            "windows": windows}


def eval_child(args):
    import numpy as np
    from bench_torch.harness import karel
    from bench_torch.harness.bench import Context, load_module
    from demo2program_tpu_torch.train.step import (
        deterministic_cuda, full_precision_matmuls)
    if args.device == "cuda":
        deterministic_cuda()
        full_precision_matmuls()
    ctx = Context(args.workload, 1, args.seconds, 0, args.device)
    eg = load_module("traffic", "eval_greedy")
    cfg, p = ctx.config, ctx.params
    path = eg.checkpoint_path(cfg)
    bs = cfg["eval_batch_size"]
    out = []
    evaler = None
    for data_seed in args.data_seeds:
        split = karel.make_split(cfg, p["programs"], data_seed)
        if evaler is None:
            evaler = karel.make_evaler(cfg, ctx, split, path)
            eg._batch(evaler, split, 0, bs, ctx.device)
        recs = []
        for b in range(len(split.ids) // bs):
            t0 = time.perf_counter()
            r = eg._batch(evaler, split, b, bs, ctx.device)
            recs.append({"s": time.perf_counter() - t0, "vm_s": r["vm_s"],
                         "longest": int(r["len"].max()),
                         "parsed": float(np.mean(r["syntax"]))})
        times = [r["s"] for r in recs]
        # windows of `seconds` over batch orders drawn from seeds 0..199
        rates = []
        for seed in range(200):
            order = eg.batch_order(len(times), seed)
            t = n = 0
            while t < args.seconds:
                t += times[next(order)]
                n += 1
            rates.append(n * bs / t)
        q1, med, q3 = statistics.quantiles(rates, n=4)
        out.append({"data_seed": data_seed,
                    "pool_rate": len(times) * bs / sum(times),
                    "window_rate_median": med,
                    "window_rate_spread": (q3 - q1) / med,
                    "batches": recs})
    return {"pools": out}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--data_seeds", default="1")
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for var, sub in {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
                     "torch_extensions", "CUDA_CACHE_PATH":
                     "cuda_cache"}.items():
        os.environ[var] = str(ROOT / "build" / sub)
    args.data_seeds = [int(s) for s in args.data_seeds.split(",")]
    if args.child:
        from bench_torch.harness.bench import load_cell
        traffic = load_cell(args.workload)[1]["traffic"]
        res = (train_child if traffic == "train_cache" else
               eval_child)(args)
        print(json.dumps(dict(res, workload=args.workload)), flush=True)
        return
    base = [sys.executable, __file__, "--child", "--workload",
            args.workload, "--device", args.device,
            "--seconds", str(args.seconds), "--windows",
            str(args.windows), "--data_seeds",
            ",".join(map(str, args.data_seeds))]
    for seed in [int(s) for s in args.seeds.split(",")]:
        proc = subprocess.run(base + ["--seed", str(seed)], cwd=ROOT,
                              capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(json.dumps({"seed": seed, "rc": proc.returncode,
                              "stderr": proc.stderr[-1500:]}), flush=True)
            continue
        line = lines[-1]
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        res = json.loads(line)
        for w in res.get("windows", []):
            w.pop("step_s")
        for pool in res.get("pools", []):
            pool["batches"] = [[round(b["s"], 3), b["longest"]]
                               for b in pool["batches"]]
        print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
