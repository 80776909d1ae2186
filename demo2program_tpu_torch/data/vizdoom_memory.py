"""In-memory ViZDoom split, made from a seed.

Runs the generator's loop (data/vizdoom_generator.py:iter_items) and keeps
its items in memory instead of writing `data.hdf5`: the split serves the
same arrays as the HDF5 reader (`get_data`, `get_batch`, `_store`), so the
trainer, the evaler and the device cache take it like a dataset split, on a
host without h5py. DoomLite renders in Python, so a split can be made in
shards: each shard is the generator's run from its own seed, shards are
made in a process pool and concatenated, and a shard's ids get the prefix
`<shard>_`, as demo2program_tpu/data/merge_datasets.py renames them.
"""

import dataclasses
import multiprocessing

from demo2program_tpu_torch.data.vizdoom_dataset import VizdoomSplit
from demo2program_tpu_torch.data.vizdoom_generator import (
    VizdoomGeneratorConfig, iter_items)


class InMemoryVizdoomSplit(VizdoomSplit):
    """Items of the generator held in memory (`store`: id -> group)."""

    def __init__(self, store, info, ids=None, name="in-memory", num_k=None):
        self._store = store
        self.info = info
        self.ids = list(store) if ids is None else list(ids)
        self.name = name
        self._set_info(info)
        self.num_k = self.num_demo if num_k is None else num_k

    def subset(self, ids, name, num_k=None):
        """The split of `ids` (same items, same data_info), reading num_k
        seen demos (default: this split's)."""
        return InMemoryVizdoomSplit(self._store, self.info, ids, name,
                                    self.num_k if num_k is None else num_k)


def generate_shard(cfg, num_programs, seed):
    """(store, info) of `num_programs` items of the generator's run from
    `seed` with cfg's other settings."""
    cfg = dataclasses.replace(cfg, num_train=num_programs, num_test=0,
                              num_val=0, seed=seed)
    info = {}
    store = dict(iter_items(cfg, info))
    return store, info


def _shard(job):
    return generate_shard(*job)


def generate_split(cfg=VizdoomGeneratorConfig(), num_programs=None,
                   shard_seeds=None, processes=1):
    """-> InMemoryVizdoomSplit. With `shard_seeds`, `num_programs` items
    from each seed, made by `processes` workers and concatenated (ids
    `<shard>_<id>`); else cfg.num_train + num_test + num_val items from
    cfg.seed, ids as the generator writes them."""
    if shard_seeds is None:
        info = {}
        return InMemoryVizdoomSplit(dict(iter_items(cfg, info)), info)
    jobs = [(cfg, num_programs, seed) for seed in shard_seeds]
    if processes > 1:
        with multiprocessing.get_context("spawn").Pool(processes) as pool:
            shards = pool.map(_shard, jobs)
    else:
        shards = [_shard(job) for job in jobs]
    store = {}
    for i, (items, _) in enumerate(shards):
        store.update({f"{i}_{id_}": item for id_, item in items.items()})
    info = dict(shards[0][1])
    # the dataset-wide maxima, as merge_datasets.py takes them
    for key in ("max_demo_length", "max_program_length",
                "vizdoom_max_init_pos_len"):
        info[key] = max(s[1][key] for s in shards)
    info["num_train"] = len(store)
    return InMemoryVizdoomSplit(store, info)
