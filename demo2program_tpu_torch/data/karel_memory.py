"""In-memory Karel split in the compact wire format, made from a seed.

`generate_split` runs the Karel generator (data/karel_generator.py, python
backend) and keeps only what `get_batch_compact` (data/dataset.py:283-312)
serves: token ids, initial states and recorded actions. No HDF5 file and
no h5py are involved, so a split can be made on any host and handed to the
Evaler like a dataset split; `split_from_records` does the same for the
records of either backend.
"""

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


def split_from_records(records, max_program_len, max_demo_len):
    """data/karel_generator.py:generate_records' items (data_info skipped)
    -> InMemoryKarelSplit in the compact form the HDF5 reader serves
    (data/dataset.py:_CompactStore), token rows padded to
    `max_program_len` and action rows to `max_demo_len`."""
    from demo2program_tpu_torch.data.dataset import _CompactStore

    cols, ids = {}, []
    for id_, grp in records:
        if id_ == "data_info":
            continue
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
        for key, v in item.items():
            cols.setdefault(key, []).append(v)
        ids.append(id_)
    return InMemoryKarelSplit({k: np.stack(v) for k, v in cols.items()},
                              ids)
