"""In-memory Karel split in the compact wire format, made from a seed.

`generate_split` runs the Karel generator (data/karel_generator.py, python
backend) and keeps only what `get_batch_compact` (data/dataset.py:283-312)
serves: token ids, initial states and recorded actions. No HDF5 file and
no h5py are involved, so a split can be made on any host and handed to the
Evaler like a dataset split; `split_from_records` does the same for the
records of either backend.

`generate_splits` / `splits_from_records` make the three splits of a whole
generated dataset, (train, test, val), with the ids, the order and the
batches that the HDF5 reader gives for the file the generator would have
written (data/dataset.py:all_ids, `get_batch_compact`): the columns are
trimmed to the data_info record's longest program and demo, as the reader's
are. `id_list_sha256` hashes the id list as the generator's id.txt holds
it. `save_splits` / `load_splits` keep the three splits in one .npz, and
`splits_sha256` hashes their contents, so a split made once can be used
again and shown to be the same.
"""

import hashlib
import os
from dataclasses import dataclass

import numpy as np

from demo2program_tpu_torch.data.karel_generator import (
    GeneratorConfig, generate_records)


@dataclass(frozen=True)
class SplitConfig:
    num_programs: int = 96
    seed: int = 123
    k: int = 10
    test_k: int = 5
    max_program_len: int = 45
    max_demo_len: int = 20
    min_demo_len: int = 8

    def generator_config(self):
        """The generator's settings for this split: every program in the
        train part, the generator's defaults for the rest."""
        return GeneratorConfig(
            num_train=self.num_programs, num_test=0, num_val=0,
            seed=self.seed, max_program_length=self.max_program_len,
            min_demo_length=self.min_demo_len,
            max_demo_length=self.max_demo_len,
            num_demo_per_program=self.k,
            num_test_demo_per_program=self.test_k)


class InMemoryKarelSplit:
    """A Karel split held as compact arrays: `ids`, `get_batch_compact`."""

    dsl_type = "prob"
    env_type = None

    def __init__(self, arrays, ids):
        self.arr = arrays
        self.ids = list(ids)
        self.index = {id_: i for i, id_ in enumerate(self.ids)}

    def get_batch_compact(self, id_list):
        idx = np.fromiter((self.index[i] for i in id_list), np.int64,
                          count=len(id_list))
        batch = {key: v[idx] for key, v in self.arr.items()}
        batch["id"] = np.asarray(id_list)
        return batch


def generate_split(cfg=SplitConfig()):
    """Sample cfg.num_programs unique programs with k seen and test_k unseen
    demos each -> InMemoryKarelSplit."""
    records = generate_records(cfg.generator_config(), "python",
                               progress_every=0)
    return split_from_records(records, cfg.max_program_len,
                              cfg.max_demo_len)


def _compact_item(grp, max_program_len, max_demo_len):
    """One generator record -> its compact arrays, token rows padded to
    `max_program_len` and action rows to `max_demo_len`."""
    from demo2program_tpu_torch.data.dataset import _CompactStore

    compact = _CompactStore._compact_of(grp, max_demo_len)
    prog = grp["program"]
    program = np.zeros(max_program_len, np.int32)
    program[:len(prog)] = prog
    item = {"program_tokens": program,
            "program_len": np.array([len(prog)], np.float32)}
    for pfx in ("", "test_"):
        for key in ("wall", "marker", "agent", "a_raw"):
            item[f"{pfx}c_{key}"] = compact[pfx + key]
        item[pfx + "c_a_row_len"] = np.array(
            [compact[pfx + "a_row_len"]], np.int32)
        item[pfx + "demo_len"] = compact[pfx + "demo_len"].astype(
            np.float32)
    return item


def _columns(records, max_program_len, max_demo_len):
    """Records -> ({key: stacked compact column}, ids in record order,
    the data_info record or None)."""
    cols, ids, info = {}, [], None
    for id_, grp in records:
        if id_ == "data_info":
            info = grp
            continue
        item = _compact_item(grp, max_program_len, max_demo_len)
        for key, v in item.items():
            cols.setdefault(key, []).append(v)
        ids.append(id_)
    return {k: np.stack(v) for k, v in cols.items()}, ids, info


def split_from_records(records, max_program_len, max_demo_len):
    """data/karel_generator.py:generate_records' items (data_info skipped)
    -> InMemoryKarelSplit in the compact form the HDF5 reader serves
    (data/dataset.py:_CompactStore), token rows padded to
    `max_program_len` and action rows to `max_demo_len`."""
    cols, ids, _ = _columns(records, max_program_len, max_demo_len)
    return InMemoryKarelSplit(cols, ids)


def id_list_sha256(ids):
    """sha256 (hex) of the id.txt that data/karel_generator.py:generate
    writes for these ids: each id and a newline."""
    h = hashlib.sha256()
    for id_ in ids:
        h.update((id_ + "\n").encode())
    return h.hexdigest()


def splits_from_records(records, max_program_len=50, max_demo_len=20):
    """The records of a whole generated dataset, data_info last (as
    generate_records yields them) -> (train, test, val) InMemoryKarelSplits,
    each with the ids in data/dataset.py:all_ids' order for the file the
    generator would have written.

    Each record is compacted as it arrives, its rows padded to the
    generator's caps `max_program_len` and `max_demo_len` (a record's full
    state history is never kept); the columns are then trimmed to
    data_info's `max_program_length` and `max_demo_length`, the longest
    seen, where the reader takes its dims (the padding beyond them is
    zeros). Each split carries `id_sha256`, the id list's hash of the whole
    dataset (id_list_sha256)."""
    from demo2program_tpu_torch.data.dataset import split_ids

    cols, ids, info = _columns(records, max_program_len, max_demo_len)
    if info is None:
        raise ValueError("the records end without their data_info record")
    L = int(info["max_program_length"])
    T = int(info["max_demo_length"])
    if L > max_program_len or T > max_demo_len:
        raise ValueError(f"data_info's lengths ({L}, {T}) exceed the caps "
                         f"({max_program_len}, {max_demo_len})")
    cols["program_tokens"] = cols["program_tokens"][:, :L]
    for pfx in ("", "test_"):
        cols[pfx + "c_a_raw"] = cols[pfx + "c_a_raw"][..., :T]
    row = {id_: i for i, id_ in enumerate(ids)}
    sha = id_list_sha256(ids)
    splits = []
    for part in split_ids(ids, int(info["num_train"]), int(info["num_test"]),
                          int(info["num_val"])):
        idx = np.fromiter((row[i] for i in part), np.int64, count=len(part))
        split = InMemoryKarelSplit(
            {k: np.ascontiguousarray(v[idx]) for k, v in cols.items()}, part)
        split.id_sha256 = sha
        splits.append(split)
    return tuple(splits)


def generate_splits(gen_cfg=GeneratorConfig(), backend="native",
                    progress_every=0):
    """Generate the dataset of `gen_cfg` in memory -> (train, test, val)
    (splits_from_records). The defaults are karel_25k's: 25000 / 5000 /
    5000 programs from seed 123. `native` raises when the engine does not
    build: nothing falls back to the python backend."""
    records = generate_records(gen_cfg, backend,
                               progress_every=progress_every)
    return splits_from_records(records, gen_cfg.max_program_length,
                               gen_cfg.max_demo_length)


SPLIT_NAMES = ("train", "test", "val")


def splits_sha256(splits):
    """sha256 (hex) of the contents of (train, test, val): each split's ids
    in order and every compact array's name, dtype, shape and bytes."""
    h = hashlib.sha256()
    for split in splits:
        h.update("\n".join(split.ids).encode())
        for key in sorted(split.arr):
            v = np.ascontiguousarray(split.arr[key])
            h.update(f"{key} {v.dtype.str} {v.shape}".encode())
            h.update(v.tobytes())
    return h.hexdigest()


def save_splits(splits, path):
    """(train, test, val) of splits_from_records -> one compressed .npz at
    `path`, written through a temporary file."""
    arrays = {"id_sha256": np.array(splits[0].id_sha256)}
    for name, split in zip(SPLIT_NAMES, splits):
        arrays[f"{name}.ids"] = np.array(split.ids)
        for key, v in split.arr.items():
            arrays[f"{name}.{key}"] = v
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_splits(path):
    """save_splits' file -> (train, test, val)."""
    with np.load(path, allow_pickle=False) as z:
        sha = str(z["id_sha256"])
        splits = []
        for name in SPLIT_NAMES:
            arrays = {k.split(".", 1)[1]: z[k] for k in z.files
                      if k.startswith(name + ".") and k != name + ".ids"}
            split = InMemoryKarelSplit(arrays, z[name + ".ids"].tolist())
            split.id_sha256 = sha
            splits.append(split)
    return tuple(splits)
