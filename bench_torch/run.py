"""The benchmark of demo2program_tpu_torch on NVIDIA H100 cards.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json once: makes its data and weights from the
seed, warms up, measures for --seconds, checks what the timed path
produced against the plain reference (bench_torch/reference/), and prints
one JSON line as the last line of its output. With --trace 0 the line holds
the cell's end-to-end metrics, with --trace 1 its per-layer metrics, read
from a profiled stretch after the window. The numbers compared, each with
its limit, end standard error and the result line (`checks`).

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits with 2. Build products stay in fixed directories of the
checkout (build/), so only a checkout's first run builds.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the caches of compilers the program may use, at fixed paths of the
# checkout (its own nvcc and g++ builds go to build/kernels, build/native)
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "cuda_cache"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_record(count, peak):
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def execute(ctx):
    """Run the cell's driver -> the result dict (without `device`)."""
    from bench_torch.harness.bench import judge, load_module, read_per_layer

    out = load_module("traffic", ctx.cell["traffic"]).run(ctx)
    correct, checks = judge(out["numbers"], ctx.limits)
    if ctx.trace:
        metrics = read_per_layer(ctx, out["layer"])
    else:
        units = {m["name"]: m["unit"] for m in ctx.e2e}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in out["e2e"].items() if k in units}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics}
    return result, out, checks


def main(argv=None):
    args = parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    from bench_torch.harness.bench import Context, load_cell

    _, entry, _, _, _ = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); this "
              f"host has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from demo2program_tpu_torch.train.step import (
        deterministic_cuda, full_precision_matmuls)
    deterministic_cuda()
    full_precision_matmuls()

    ctx = Context(args.workload, args.seed, args.seconds, args.trace,
                  "cuda")
    result, out, checks = execute(ctx)
    result["device"] = device_record(entry["chips"],
                                     out["memory_peak_bytes"])
    if args.trace:
        layer = out["layer"]
        result["device"].update(busy_s=layer.get("busy_s", 0.0),
                                window_s=layer.get("window_s", 0.0))
        result["breakdown"] = {k: layer[k] for k in ("device_ops",
                                                     "idle_gaps")
                               if k in layer}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
