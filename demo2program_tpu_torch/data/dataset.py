"""HDF5 Karel dataset reader, compact wire format.

The port's own copy of the part of demo2program_tpu/data/dataset.py that the
CLIs use: the split membership (`all_ids`, `create_default_splits`), the
`--id_list` check (`check_data_id`) and `KarelDataset.get_batch_compact`, served from the same sidecar compact cache
(`compact_cache_v1.npz`, written beside data.hdf5 and read by both packages).
Batches equal the JAX reader's bit for bit. The full-tensor `get_data` and
the in-memory preload behind it are not copied: the port expands compact
batches on the device (ops/reconstruct.py).

h5py is imported where a file is opened, never at import: a host without
h5py (the GPU machine) imports this module and uses the in-memory split of
data/karel_memory.py instead.

Split membership: id.txt order -> first num_train / next num_test / next
num_val, each shuffled by a fixed RandomState(123) (`dataset_karel.py:11,
143-160`); a `splits.json` beside data.hdf5 may override the three counts.
"""

import json
import os
import os.path as osp
import time

import numpy as np

from demo2program_tpu_torch.utils import log

_SPLIT_RNG_SEED = 123
_COMPACT_CACHE_NAME = "compact_cache_v1.npz"
_COMPACT_STORES = {}


def _h5py():
    import h5py
    return h5py


def _scalar(ds):
    v = ds[()]
    if isinstance(v, bytes):
        return v.decode()
    return v


def _h5_fingerprint(h5file):
    """(size, mtime_ns) of the backing HDF5: the sidecar's staleness key."""
    st = os.stat(h5file.filename)
    return np.array([st.st_size, st.st_mtime_ns], np.int64)


class _CompactStore:
    """Every item's compact arrays, packed as a few large numpy arrays and
    kept in the sidecar `compact_cache_v1.npz` (rebuilt when data.hdf5's
    size or mtime changes)."""

    def __init__(self, dataset_path, h5file, max_demo_len):
        path = osp.join(dataset_path, _COMPACT_CACHE_NAME)
        self._fp = _h5_fingerprint(h5file)
        if osp.exists(path):
            z = np.load(path, allow_pickle=False)
            if ("h5_fingerprint" in z.files
                    and np.array_equal(z["h5_fingerprint"], self._fp)):
                self.arr = {k: z[k] for k in z.files}
                self.index = {id_: i
                              for i, id_ in enumerate(self.arr["ids"])}
                return
            log.warn("compact cache %s is stale (data.hdf5 changed); "
                     "rebuilding", path)
        self._build(path, h5file, max_demo_len)

    @staticmethod
    def _compact_of(grp, max_demo_len):
        out = {}
        for pfx, s_key, a_key in (("", "s_h", "a_h"),
                                  ("test_", "test_s_h", "test_a_h")):
            first = grp[s_key][:, :1][:, 0]       # (n, h, w, 16) partial read
            n, h, w, _ = first.shape
            out[pfx + "wall"] = first[:, :, :, 4].astype(np.uint8)
            out[pfx + "marker"] = np.argmax(
                first[:, :, :, 5:], axis=-1).astype(np.uint8)
            flat = np.argmax(first[:, :, :, :4].reshape(n, h * w * 4),
                             axis=-1)
            out[pfx + "agent"] = np.stack(
                [flat // (w * 4), (flat // 4) % w, flat % 4],
                axis=1).astype(np.uint8)
            a_rows = grp[a_key][()]
            a_raw = np.zeros((n, max_demo_len), np.int8)
            a_raw[:, :a_rows.shape[1]] = a_rows
            out[pfx + "a_raw"] = a_raw
            out[pfx + "a_row_len"] = np.int32(a_rows.shape[1])
            out[pfx + "demo_len"] = grp[
                ("test_s_h_len" if pfx else "s_h_len")][()].astype(np.int16)
        return out

    def _build(self, path, h5file, max_demo_len):
        log.info("building compact cache %s ...", path)
        t0 = time.time()
        ids = [k for k in h5file.keys() if k != "data_info"]
        Lmax = max(h5file[i]["program"].shape[0] for i in ids)
        cols = {k: [] for k in (
            "program", "program_len", "wall", "marker", "agent", "a_raw",
            "a_row_len", "demo_len", "test_wall", "test_marker",
            "test_agent", "test_a_raw", "test_a_row_len", "test_demo_len")}
        for id_ in ids:
            grp = h5file[id_]
            prog = grp["program"][()]
            padded = np.zeros(Lmax, np.int32)
            padded[:len(prog)] = prog
            cols["program"].append(padded)
            cols["program_len"].append(np.int32(len(prog)))
            for k, v in self._compact_of(grp, max_demo_len).items():
                cols[k].append(v)
        arrs = {k: np.stack(v) for k, v in cols.items()}
        arrs["ids"] = np.array(ids)
        arrs["h5_fingerprint"] = self._fp
        try:
            # through a file of this process's own: the ranks of a
            # data-parallel run may build the sidecar at once
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **arrs)
            os.replace(tmp, path)
            log.info("compact cache built in %.1f s (%d items)",
                     time.time() - t0, len(ids))
        except OSError:
            log.warn("compact cache not writable; keeping in memory only")
        self.arr = arrs
        self.index = {id_: i for i, id_ in enumerate(ids)}


class KarelDataset:
    def __init__(self, ids, dataset_path, name="default", num_k=10,
                 is_train=True):
        self._ids = list(ids)
        self.name = name
        self.num_k = num_k
        self.is_train = is_train
        self.dataset_path = dataset_path

        filename = osp.join(dataset_path, "data.hdf5")
        log.info("Reading %s ...", filename)
        self.data = _h5py().File(filename, "r")
        info = self.data["data_info"]
        self.dsl_type = _scalar(info["dsl_type"])
        self.num_demo = int(_scalar(info["num_demo_per_program"]))
        self.max_demo_len = int(_scalar(info["max_demo_length"]))
        self.max_program_len = int(_scalar(info["max_program_length"]))
        self.num_program_tokens = int(_scalar(info["num_program_tokens"]))
        self.num_action_tokens = int(_scalar(info["num_action_tokens"]))
        self.env_type = (_scalar(info["env_type"])
                         if "env_type" in info else None)

    @property
    def compact_store(self):
        """Lazy file-level _CompactStore shared by all splits."""
        key = osp.abspath(osp.join(self.dataset_path, "data.hdf5"))
        if key not in _COMPACT_STORES:
            _COMPACT_STORES[key] = _CompactStore(
                self.dataset_path, self.data, self.max_demo_len)
        return _COMPACT_STORES[key]

    def get_batch_compact(self, id_list):
        """Compact wire-format batch: token ids, initial states and raw
        action rows; the full tensors are rebuilt on the device
        (ops/reconstruct.py)."""
        cs = self.compact_store
        a = cs.arr
        idx = np.fromiter((cs.index[i] for i in id_list), np.int64,
                          count=len(id_list))
        k = self.num_k
        L = self.max_program_len
        return {
            "id": np.asarray(id_list),
            "program_tokens": a["program"][idx][:, :L],
            "program_len": a["program_len"][idx][:, None].astype(np.float32),
            "demo_len": a["demo_len"][idx][:, :k].astype(np.float32),
            "test_demo_len": a["test_demo_len"][idx].astype(np.float32),
            "c_wall": a["wall"][idx][:, :k],
            "c_marker": a["marker"][idx][:, :k],
            "c_agent": a["agent"][idx][:, :k],
            "c_a_raw": a["a_raw"][idx][:, :k],
            "c_a_row_len": a["a_row_len"][idx][:, None],
            "test_c_wall": a["test_wall"][idx],
            "test_c_marker": a["test_marker"][idx],
            "test_c_agent": a["test_agent"][idx],
            "test_c_a_raw": a["test_a_raw"][idx],
            "test_c_a_row_len": a["test_a_row_len"][idx][:, None],
        }

    @property
    def ids(self):
        return self._ids

    def __len__(self):
        return len(self._ids)

    def __repr__(self):
        return f"KarelDataset ({self.name}, {len(self)} examples)"


def check_data_id(dataset, data_id):
    """Raise unless every requested id exists in the dataset
    (`input_ops_karel.py:7-21`)."""
    if not data_id:
        return
    wrong = [i for i in data_id if i not in dataset.data]
    if wrong:
        raise RuntimeError("There are %d invalid ids, including %s" % (
            len(wrong), wrong[:5]))


def all_ids(dataset_path, rng_seed=_SPLIT_RNG_SEED):
    with _h5py().File(osp.join(dataset_path, "data.hdf5"), "r") as f:
        num_train = int(_scalar(f["data_info"]["num_train"]))
        num_test = int(_scalar(f["data_info"]["num_test"]))
        num_val = int(_scalar(f["data_info"]["num_val"]))
    sp = osp.join(dataset_path, "splits.json")
    if osp.exists(sp):
        with open(sp) as f:
            ov = json.load(f)
        num_train = int(ov.get("num_train", num_train))
        num_test = int(ov.get("num_test", num_test))
        num_val = int(ov.get("num_val", num_val))
    with open(osp.join(dataset_path, "id.txt")) as fp:
        ids_total = [s.strip() for s in fp.readlines() if s.strip()]
    return split_ids(ids_total, num_train, num_test, num_val, rng_seed)


def split_ids(ids_total, num_train, num_test, num_val,
              rng_seed=_SPLIT_RNG_SEED):
    """The ids in id.txt order -> (train, test, val): the first num_train,
    the next num_test, the next num_val, each shuffled by one shared
    RandomState(rng_seed) in that call order (`dataset_karel.py:156-158`;
    demo2program_tpu/data/dataset.py:362-372)."""
    ids_total = list(ids_total)
    ids_train = ids_total[:num_train]
    ids_test = ids_total[num_train:num_train + num_test]
    ids_val = ids_total[num_train + num_test:num_train + num_test + num_val]
    rs = np.random.RandomState(rng_seed)
    rs.shuffle(ids_train)
    rs.shuffle(ids_test)
    rs.shuffle(ids_val)
    return ids_train, ids_test, ids_val


def create_default_splits(dataset_path, num_k=10, is_train=True):
    ids_train, ids_test, ids_val = all_ids(dataset_path)
    return (KarelDataset(ids_train, dataset_path, "train", num_k, is_train),
            KarelDataset(ids_test, dataset_path, "test", num_k, is_train),
            KarelDataset(ids_val, dataset_path, "val", num_k, is_train))
