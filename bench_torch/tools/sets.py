"""Two sets of runs of one cell, with the same seeds in both, each run a
new process, and the spread of each metric: what a bound is set from.

    python3 bench_torch/tools/sets.py --workload <cell> --seeds 1,2,3,4,5,6 \
        --seconds 30 [--sets 2] [--out FILE]

Prints every run's result line, then per metric each set's median and the
distance between its first and third quartiles (statistics.quantiles,
n=4) as a share of the median.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def one_run(workload, seed, seconds, trace):
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch" / "run.py"),
         "--workload", workload, "--seed", str(seed), "--seconds",
         str(seconds), "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"seed": seed, "trace": trace, "rc": proc.returncode,
            "wall_s": time.time() - t0, "result": result,
            "stderr_tail": proc.stderr[-1500:] if result is None or not
            result["correct"] else ""}


def spread(values):
    q1, med, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), (q3 - q1) / statistics.median(values)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            r = dict(one_run(args.workload, seed, args.seconds, args.trace),
                     set=k)
            runs.append(r)
            line = json.dumps(r)
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    ok = [r for r in runs if r["result"] is not None]
    names = sorted({m for r in ok for m in r["result"]["metrics"]})
    for name in names:
        for k in range(args.sets):
            vals = [r["result"]["metrics"][name]["value"] for r in ok
                    if r["set"] == k and name in r["result"]["metrics"]]
            if len(vals) >= 2:
                med, sp = spread(vals)
                print(f"{args.workload} set {k} {name}: median {med!r} "
                      f"spread {sp!r} values {vals}", flush=True)
    print(f"{args.workload}: {len(ok)} of {len(runs)} runs gave a result, "
          f"{sum(r['result']['correct'] for r in ok)} correct", flush=True)


if __name__ == "__main__":
    main()
