"""ViZDoom dataset reader, full wire format.

Port of demo2program_tpu/data/vizdoom_dataset.py (`vizdoom_env/
dataset_vizdoom.py`) with the parts of the JAX KarelDataset it inherits:
`get_data` (padded demos, perception histories, the reference's quirky
action one-hots, and the per-pos-key initial actor positions padded to
vizdoom_max_init_pos_len, which the engine scorer re-initialises episodes
from), `_action_onehots` and the in-memory preload of files under
D2P_PRELOAD_LIMIT_BYTES (3 GiB). ViZDoom demos are engine-rendered video,
so there is no compact format: a batch is the stack of `get_data` items
(`get_batch`), as the JAX BatchPipeline stacks them.

`VizdoomSplit` holds what the trainer, the evaler and the device cache read
(`ids`, the data_info fields, `_store`: id -> the arrays of one HDF5
group); `VizdoomDataset` fills it from `data.hdf5`, data/vizdoom_memory.py
from the generator's loop. num_k slices the seen demos at read time
(`dataset_vizdoom.py:62, 73, 107, 113, 125`).

h5py is imported where a file is opened, never at import.
"""

import os
import os.path as osp
import time

import numpy as np

from demo2program_tpu_torch.data.dataset import _h5py, _scalar, all_ids
from demo2program_tpu_torch.utils import log

_PRELOAD_LIMIT_BYTES = int(os.environ.get(
    "D2P_PRELOAD_LIMIT_BYTES", 3 * 1024 ** 3))
_PRELOAD_CACHE = {}


class VizdoomSplit:
    """A ViZDoom split: `ids`, the data_info fields, `_store` and the
    full-wire `get_data` / `get_batch`."""

    dsl_type = "vizdoom_default"
    env_type = "vizdoom_default"
    dataset_path = None  # no HDF5 behind the split: no device cache sidecar

    def _set_info(self, info):
        """The data_info fields (values as the HDF5 reader returns them)."""
        self.num_demo = int(info["num_demo_per_program"])
        self.max_demo_len = int(info["max_demo_length"])
        self.max_program_len = int(info["max_program_length"])
        self.num_program_tokens = int(info["num_program_tokens"])
        self.num_action_tokens = int(info["num_action_tokens"])
        self.vizdoom_pos_keys = [
            k.decode() if isinstance(k, bytes) else str(k)
            for k in info["vizdoom_pos_keys"]]
        self.vizdoom_max_init_pos_len = int(info["vizdoom_max_init_pos_len"])
        self.perception_type = info["perception_type"]
        self.sprite_style = info.get("sprite_style", "v2")
        self.level = info.get("level", "not_simple")
        self.k = self.num_demo
        self.test_k = int(info["num_test_demo_per_program"])
        self.s_h_h = int(info["s_h_h"])
        self.s_h_w = int(info["s_h_w"])
        self.s_h_c = int(info["s_h_c"])

    def _action_onehots(self, a_h_rows):
        """Reference-exact action one-hots incl. the padded-'move' + fixed
        <e> position quirk (`dataset_karel.py:66-94`)."""
        out = []
        row_len = a_h_rows.shape[1]
        for row in a_h_rows:
            oh = np.zeros([self.max_demo_len, self.num_action_tokens + 1],
                          dtype=bool)
            oh[np.arange(row_len), row] = True
            oh[row_len, self.num_action_tokens] = True  # <e>
            out.append(oh)
        onehot = np.stack(out, axis=0)
        tokens = np.argmax(onehot, axis=2)
        return onehot, tokens

    def get_data(self, id_):
        grp = self._store[id_]
        k = self.num_k
        program_tokens = grp["program"][()]
        program = np.zeros(
            [self.num_program_tokens, self.max_program_len], dtype=bool)
        program[program_tokens, np.arange(len(program_tokens))] = True
        padded_program_tokens = np.zeros(
            [self.max_program_len], dtype=program_tokens.dtype)
        padded_program_tokens[:len(program_tokens)] = program_tokens

        def pad_demo(arr):
            sz = arr.shape
            out = np.zeros([sz[0], self.max_demo_len] + list(sz[2:]),
                           dtype=arr.dtype)
            out[:, :sz[1]] = arr
            return out

        demo = pad_demo(grp["s_h"][()][:k])
        test_demo = pad_demo(grp["test_s_h"][()])
        per = pad_demo(grp["p_v_h"][()][:k])
        test_per = pad_demo(grp["test_p_v_h"][()])

        a_h, a_h_tokens = self._action_onehots(grp["a_h"][()][:k])
        test_a_h, test_a_h_tokens = self._action_onehots(
            grp["test_a_h"][()])

        def pad_init_pos(arr):
            sz = arr.shape
            out = np.zeros([sz[0], sz[1], self.vizdoom_max_init_pos_len, 2],
                           dtype=arr.dtype)
            out[:, :, :sz[2], :] = arr
            return out

        init_pos = pad_init_pos(grp["vizdoom_init_pos"][()][:k])
        init_pos_len = grp["vizdoom_init_pos_len"][()][:k]
        test_init_pos = pad_init_pos(grp["test_vizdoom_init_pos"][()])
        test_init_pos_len = grp["test_vizdoom_init_pos_len"][()]

        return {
            "id": id_,
            "program": program.astype(np.uint8),
            "program_tokens": padded_program_tokens.astype(np.int32),
            # raw 0..255 pixel values, as the reference feeds them; uint8
            # here, cast to float on the device
            "s_h": demo.astype(np.uint8),
            "test_s_h": test_demo.astype(np.uint8),
            "a_h": a_h.astype(np.uint8),
            "a_h_tokens": a_h_tokens.astype(np.int32),
            "test_a_h": test_a_h.astype(np.uint8),
            "test_a_h_tokens": test_a_h_tokens.astype(np.int32),
            "program_len": np.array([len(program_tokens)], np.float32),
            "demo_len": grp["s_h_len"][()][:k].astype(np.float32),
            "test_demo_len": grp["test_s_h_len"][()].astype(np.float32),
            "per": per.astype(np.uint8),
            "test_per": test_per.astype(np.uint8),
            "init_pos": init_pos.astype(np.int32),
            "init_pos_len": init_pos_len.astype(np.int32),
            "test_init_pos": test_init_pos.astype(np.int32),
            "test_init_pos_len": test_init_pos_len.astype(np.int32),
        }

    def get_batch(self, id_list):
        """The stacked `get_data` items of `id_list` (the JAX
        BatchPipeline's full-wire batch), `id` an array of the ids."""
        items = [self.get_data(i) for i in id_list]
        batch = {"id": np.asarray(id_list)}
        for key in items[0]:
            if key != "id":
                batch[key] = np.stack([it[key] for it in items], axis=0)
        return batch

    def __len__(self):
        return len(self.ids)

    def __repr__(self):
        return f"{type(self).__name__} ({self.name}, {len(self)} examples)"


class _PreloadedFile:
    """Every group's datasets as numpy arrays, read once per file."""

    def __init__(self, h5file, ids):
        self._groups = {}
        for id_ in ids:
            g = h5file[id_]
            self._groups[id_] = {k: g[k][()] for k in g.keys()}

    def __getitem__(self, id_):
        return self._groups[id_]

    def __contains__(self, id_):
        return id_ in self._groups


class VizdoomDataset(VizdoomSplit):
    def __init__(self, ids, dataset_path, name="default", num_k=10,
                 is_train=True):
        self.ids = list(ids)
        self.name = name
        self.num_k = num_k
        self.is_train = is_train
        self.dataset_path = dataset_path

        filename = osp.join(dataset_path, "data.hdf5")
        log.info("Reading %s ...", filename)
        self.data = _h5py().File(filename, "r")
        info = self.data["data_info"]
        self._set_info({key: (_scalar(info[key]) if info[key].ndim == 0
                              else info[key][()]) for key in info})
        self._store = self._maybe_preload(filename)

    def _maybe_preload(self, filename):
        fsize = os.path.getsize(filename)
        if fsize > _PRELOAD_LIMIT_BYTES:
            return self.data
        # one preload per file, shared by the train/test/val splits
        key = os.path.abspath(filename)
        if key not in _PRELOAD_CACHE:
            log.info("preloading %s (%.0f MB) into memory", filename,
                     fsize / 1e6)
            t0 = time.time()
            ids = [k for k in self.data.keys() if k != "data_info"]
            _PRELOAD_CACHE[key] = _PreloadedFile(self.data, ids)
            log.info("preloaded %d groups in %.1f s", len(ids),
                     time.time() - t0)
        return _PRELOAD_CACHE[key]


def create_vizdoom_splits(dataset_path, num_k=10, is_train=True):
    ids_train, ids_test, ids_val = all_ids(dataset_path)
    return (VizdoomDataset(ids_train, dataset_path, "train", num_k, is_train),
            VizdoomDataset(ids_test, dataset_path, "test", num_k, is_train),
            VizdoomDataset(ids_val, dataset_path, "val", num_k, is_train))
