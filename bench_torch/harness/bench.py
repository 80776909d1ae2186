"""The benchmark's loader and result: cells, configurations, traffic
drivers and per-layer metrics found by name, seeds, set-up time and the
result line.

Everything that belongs to one configuration, cell, driver or metric sits
in a file of its own, found by the name `BENCHMARK.json` gives it:

  * a configuration: the JSON file its `configs` entry names;
  * a cell: `bench_torch/workloads/<cell>.json`, which names its
    configuration, its driver (`traffic`), the driver's parameters and the
    limits of the correctness comparison;
  * a driver: `bench_torch/traffic/<traffic>.py`, with `run(ctx)`;
  * a per-layer metric: `bench_torch/metrics/<metric>.py`, with
    `read(layer)`, which returns None when the run has nothing to read.
"""

import importlib.util
import json
import os
import time
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(kind, name, bench_dir=BENCH_DIR):
    """bench_torch/<kind>/<name>.py as a module (names may hold dots)."""
    path = Path(bench_dir) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_torch_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name, benchmark=None, root=ROOT):
    """-> (benchmark, its workloads entry, the cell file, the configuration
    entry, the configuration file), each checked against the others;
    `root` holds BENCHMARK.json and bench_torch/."""
    root = Path(root)
    benchmark = benchmark or load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in benchmark["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    cell = load_json(root / "bench_torch" / "workloads" / f"{name}.json")
    configs = {c["name"]: c for c in benchmark["configs"]}
    config_entry = configs[entry["config"]]
    config = load_json(root / config_entry["file"])
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: the cell file's {key} {cell[key]!r} "
                             f"is not BENCHMARK.json's {entry[key]!r}")
    if config["name"] != config_entry["name"]:
        raise ValueError(f"{config_entry['file']} holds configuration "
                         f"{config['name']!r}, not {config_entry['name']!r}")
    return benchmark, entry, cell, config_entry, config


def metrics_of(benchmark, cell_name):
    """The cell's end-to-end metrics (those whose `workloads` list it, or
    that list none) and its per-layer metrics (listing it, or listing none
    while moving one of its end-to-end metrics)."""
    def listed(m):
        return cell_name in m.get("workloads", [cell_name])

    e2e = [m for m in benchmark["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in benchmark["per_layer"]
             if m["moves"] in names and listed(m)]
    return e2e, layer


def sub_seed(seed, tag, bits=31):
    """A seed for one use (`tag`) of the run's seed, below 2**bits."""
    state = np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), int(seed) >> 64,
         *tag.encode()]).generate_state(2, np.uint64)
    return int(state[0]) % (2 ** bits)


def process_start():
    """The epoch time at which this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + int(fields[19]) / ticks


class Context:
    """What a driver gets: the cell, its configuration, the run's flags,
    its device, and where its per-layer readings go."""

    def __init__(self, name, seed, seconds, trace, device, benchmark=None,
                 config_override=None, started=None):
        (self.benchmark, self.entry, self.cell, self.config_entry,
         self.config) = load_cell(name, benchmark)
        if config_override:
            self.config = dict(self.config, **config_override)
        self.name = name
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.params = self.cell["params"]
        self.limits = self.cell["limits"]
        self.started = process_start() if started is None else started
        self.e2e, self.per_layer = metrics_of(self.benchmark, name)

    def seed_for(self, tag, bits=31):
        return sub_seed(self.seed, tag, bits)

    def setup_s(self):
        """Seconds from the process's start to now (the window's start)."""
        return time.time() - self.started


def judge(numbers, limits):
    """-> (correct, {name: {"value", "limit"}}): every number at or under
    its limit, and finite."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and bool(np.isfinite(value)) and (
            value <= limit)
        correct = correct and ok
        checks[name] = {"value": None if value is None else float(value),
                        "limit": limit}
    return correct, checks


def read_per_layer(ctx, layer):
    """Each per-layer metric of the cell read from the driver's `layer`
    readings; a metric with nothing to read is left out."""
    out = {}
    for m in ctx.per_layer:
        value = load_module("metrics", m["name"]).read(layer)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
