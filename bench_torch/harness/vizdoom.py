"""ViZDoom data and the program's Trainer, built as its CLIs build them.

The pool of programs comes from the program's own generator
(data/vizdoom_memory.generate_split) at the configuration's generator
settings and a fixed data seed: traffic, not yardstick. DoomLite renders
in Python, so the pool is made once, on a checkout's first run, in a
spawn pool of processes, and kept under build/bench_torch/ (as the kernel
builds are); every run checks the contents' sha256, T and L against the
cell's parameters before it trains on them, so a changed pool fails
set-up rather than running other traffic."""

import hashlib
import json
import os
import pickle
from pathlib import Path

import numpy as np

from bench_torch.harness.bench import ROOT
from bench_torch.harness.karel import TRAIN_DIR

POOL_DIR = ROOT / "build" / "bench_torch" / "vizdoom_pool"


def generator_config(cfg):
    from demo2program_tpu_torch.data.vizdoom_generator import (
        VizdoomGeneratorConfig)

    return VizdoomGeneratorConfig(
        max_program_length=cfg["max_program_length"],
        max_demo_length=cfg["max_demo_length"],
        num_demo_per_program=cfg["num_k"],
        num_test_demo_per_program=cfg["test_k"],
        width=cfg["w"], height=cfg["h"],
        perception_type=cfg["perception_type"],
        sprite_style=cfg["sprite_style"])


def generate_pool(cfg, p, processes):
    """-> (ids, store, info): the first p["programs"] distinct programs of
    p["shards"] generator runs of p["per_shard"] programs each, from seeds
    data_seed, data_seed + 1, ...; frames as uint8."""
    from demo2program_tpu_torch.data.vizdoom_memory import generate_split

    split = generate_split(
        generator_config(cfg), num_programs=p["per_shard"],
        shard_seeds=[p["data_seed"] + i for i in range(p["shards"])],
        processes=processes)
    ids, seen = [], set()
    for id_ in split.ids:
        program = bytes(np.asarray(split._store[id_]["program"]))
        if program not in seen:
            seen.add(program)
            ids.append(id_)
    if len(ids) < p["programs"]:
        raise ValueError(f"the generator made {len(ids)} distinct programs, "
                         f"the cell needs {p['programs']}")
    ids = ids[:p["programs"]]
    store = {}
    for id_ in ids:
        item = dict(split._store[id_])
        for key in ("s_h", "test_s_h"):
            frames = np.asarray(item[key])
            if frames.min() < 0 or frames.max() > 255:
                raise ValueError(f"{id_}: {key} outside 0..255")
            item[key] = frames.astype(np.uint8)
        store[id_] = item
    info = dict(split.info)
    info["max_demo_length"] = max(int(np.max(store[i]["s_h_len"]))
                                  for i in ids)
    info["max_program_length"] = max(len(store[i]["program"]) for i in ids)
    info["num_train"] = len(ids)
    return ids, store, info


def digest(ids, store, info):
    """sha256 of the pool: its ids in order, each item's arrays (name,
    dtype, shape, bytes) and its data_info."""
    h = hashlib.sha256()
    h.update(json.dumps(ids).encode())
    for id_ in ids:
        for key in sorted(store[id_]):
            a = np.ascontiguousarray(store[id_][key])
            h.update(f"{key} {a.dtype.str} {a.shape}".encode())
            h.update(a.tobytes())
    h.update(json.dumps(info, sort_keys=True, default=str).encode())
    return h.hexdigest()


def pool_path(cfg, p):
    return POOL_DIR / (f"seed{p['data_seed']}_{p['shards']}x{p['per_shard']}"
                       f"_n{p['programs']}_k{cfg['num_k']}_{cfg['test_k']}"
                       f".pkl")


def load_pool(cfg, p, check=True):
    """The cell's pool as an in-memory split: read from build/bench_torch/,
    or generated and kept there by the first run; with `check`, its
    sha256, T and L held to the cell's `pool_sha256`, `pool_T`,
    `pool_L`."""
    from demo2program_tpu_torch.data.vizdoom_memory import (
        InMemoryVizdoomSplit)

    path = Path(pool_path(cfg, p))
    if path.is_file():
        with open(path, "rb") as f:
            ids, store, info = pickle.load(f)
    else:
        ids, store, info = generate_pool(
            cfg, p, min(8, os.cpu_count() or 1, p["shards"]))
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump((ids, store, info), f, protocol=4)
        os.replace(tmp, path)
    if check:
        got = {"pool_sha256": digest(ids, store, info),
               "pool_T": info["max_demo_length"],
               "pool_L": info["max_program_length"]}
        wrong = {k: v for k, v in got.items() if v != p[k]}
        if wrong:
            raise ValueError(
                f"the ViZDoom pool {path} is not the cell's: {wrong} against "
                f"{ {k: p[k] for k in wrong} }; the generator has changed, "
                f"or the file")
    return InMemoryVizdoomSplit(store, info, ids)


def make_trainer(cfg, ctx, split, log_step):
    """A Trainer on `split` (the ViZDoom device cache), its weights to be
    replaced by the caller; it writes nothing but an empty train dir."""
    from demo2program_tpu_torch.cli import trainer_cli
    from demo2program_tpu_torch.train.trainer import Trainer

    Path(TRAIN_DIR).mkdir(parents=True, exist_ok=True)
    argv = ["--model", cfg["model"], "--dataset_type", "vizdoom",
            "--dataset_path", "in-memory", "--num_k", str(cfg["num_k"]),
            "--batch_size", str(cfg["batch_size"]),
            "--num_lstm_cell_units", str(cfg["num_lstm_cell_units"]),
            "--cell_impl", cfg["cell_impl"],
            "--compute_dtype", cfg["compute_dtype"],
            "--learning_rate", str(cfg["learning_rate"]),
            "--seed", str(ctx.seed_for("program")),
            "--log_step", str(log_step), "--train_dir", str(TRAIN_DIR),
            "--device", str(ctx.device)]
    if cfg["lr_weight_decay"]:
        argv.append("--lr_weight_decay")
    args = trainer_cli.parse_args(argv)
    return Trainer(args, split, split, device=args.device)
