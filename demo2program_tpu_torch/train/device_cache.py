"""Device-resident train splits, with batches gathered on the device.

Port of KarelDeviceCache and the batch selection of make_chunked_train_step
(demo2program_tpu/train/device_cache.py:30-94, train/step.py:146-195). The
compact train split (tens of MB for 25k programs) is copied to the device
once; each step gathers its rows there, so no batch crosses from the host.

The batch of step s is a pure function of (seed, s): epoch e = s //
steps_per_epoch shuffles the split with a permutation drawn from numpy's
generator seeded by (seed, e), and step s takes rows [s_in_e * bs,
(s_in_e + 1) * bs) of it. A run resumed at any step replays the same
batches. The order is not the JAX package's (jax.random.permutation has no
counterpart here), only its rule. Each epoch's permutation is copied to the
device once, so a step makes no host-to-device copy.

Under a data mesh (parallel/mesh.py) the Karel split is replicated, as the
JAX cache's is (demo2program_tpu/train/device_cache.py:78-80): every rank
draws the global batch's rows of step s and gathers its own slice of them,
the counterpart of the JAX chunked step's batch-sharding constraint
(demo2program_tpu/train/step.py:184-187). On a 2-D `data x demo` mesh the
rank gathers the rows of its data index and, of the seen-demo keys, only
its demos: shard_batch_2d of the global batch.

DoomDeviceCache does the same for a ViZDoom split, whose frames cannot be
replayed on the device, and shards it over the mesh: see its docstring.
"""

import contextlib
import json
import os
import os.path as osp

import numpy as np
import torch

from demo2program_tpu_torch.parallel.mesh import (
    demo_group_rows, shard_demos, shard_rows)
from demo2program_tpu_torch.utils import log
from demo2program_tpu_torch.train.step import to_device


class KarelDeviceCache:
    """The compact split of `dataset` (anything with `ids` and
    `get_batch_compact(ids)`: an HDF5 KarelDataset or an
    InMemoryKarelSplit) on `device`. The unseen-demo `test_*` arrays are
    kept only with `include_test`: the induction baseline trains on the
    test demos' actions, the other models do not read them. `batch_size` is
    the global batch's; with a data `mesh`, batch(s) is the rank's part of
    it (shard_batch_2d: its rows, and on a 2-D mesh its demos)."""

    def __init__(self, dataset, device, batch_size, seed, include_test=False,
                 mesh=None):
        host = dataset.get_batch_compact(list(dataset.ids))
        host = {k: v for k, v in host.items()
                if include_test or not k.startswith("test_")}
        self.n = len(dataset.ids)
        self.steps_per_epoch = self.n // batch_size
        if self.steps_per_epoch < 1:
            raise ValueError(
                f"batch_size {batch_size} exceeds split size {self.n}")
        self.batch_size = batch_size
        self.seed = seed
        self.mesh = mesh
        self.device = torch.device(device)
        self.data = to_device(host, self.device)
        log.info("karel device cache: %.1f MB (%d items, replicated) on %s",
                 sum(t.nbytes for t in self.data.values()) / 1e6, self.n,
                 self.device)
        # views of the rank's demos of the split (all of it on a 1-D mesh)
        self._local = shard_demos(self.data, mesh)
        self._epoch, self._perm = None, None

    def permutation(self, epoch):
        """Row order of `epoch` (host int64 array)."""
        return np.random.default_rng((self.seed, epoch)).permutation(self.n)

    def indices(self, step):
        """Rows of the global batch of step `step` (int64 tensor on the
        device)."""
        epoch, s_in_e = divmod(step, self.steps_per_epoch)
        if epoch != self._epoch:
            self._epoch = epoch
            self._perm = torch.as_tensor(self.permutation(epoch),
                                         device=self.device)
        bs = self.batch_size
        return self._perm[s_in_e * bs:(s_in_e + 1) * bs]

    def batch(self, step):
        """The compact batch of step `step` (the rank's part of it),
        gathered on the device."""
        idx = shard_rows(self.indices(step), self.mesh)
        return {k: v.index_select(0, idx) for k, v in self._local.items()}


# the sidecar is built at the dataset's full k when the host arrays fit this
# budget (so one build serves every num_k), else at num_k only
HOST_BUDGET_BYTES = int(os.environ.get(
    "D2P_DOOM_HOST_CACHE_BYTES", 48 * 1024 ** 3))


def estimate_cache_bytes(dataset, k=None):
    """Bytes of the cached arrays of `dataset` at k demos (frames, and 32
    bytes a frame for percepts and actions)."""
    k = dataset.num_k if k is None else k
    h, w, c = dataset.s_h_h, dataset.s_h_w, dataset.s_h_c
    return len(dataset.ids) * k * dataset.max_demo_len * (h * w * c + 32)


@contextlib.contextmanager
def _replaced(path, mode="wb"):
    """A file written through a temporary name of this process's own and
    then renamed to `path`: the ranks of a data-parallel run may build the
    sidecar at once, and each file appears whole."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, mode) as f:
        yield f
    os.replace(tmp, path)


def _h5_fingerprint(ds):
    st = os.stat(osp.join(ds.dataset_path, "data.hdf5"))
    return [st.st_size, st.st_mtime_ns]


class DoomDeviceCache:
    """The ViZDoom train split on `device`, batches gathered there.

    Port of DoomDeviceCache (demo2program_tpu/train/device_cache.py:
    96-358). ViZDoom demos are engine video that cannot be replayed on the
    device, so the split's frames (uint8), percepts and raw action rows are
    copied to the device once and each step gathers its rows by index;
    `ops/reconstruct.expand_doom_batch` rebuilds the one-hots. A split that
    does not fit the device's free memory raises: there is no streaming
    path to fall back to here (the trainer streams instead when its
    estimate does not fit).

    One device (no `mesh`, or a mesh of one): batches follow the JAX
    cache's index stream, numpy RandomState(seed), a fresh permutation
    whenever the next batch would run past the split, consecutive slices of
    it. Over a data mesh of N ranks the split is SHARDED as JAX's is
    (:135-168, 287-358): the item axis is padded to a multiple of N with
    copies of items 0, 1, ... (`_per_shard` items a shard, `_shard_counts`
    real ones), each rank holds only its shard on its device, and every
    rank keeps the one RandomState(seed) and draws for ALL shards exactly as
    `_draw_sharded` does (a permutation per shard over its real items; a
    shard with none samples its pad rows), then gathers its own draw: the
    global ids of every step are JAX's, pad rows included. On a 2-D `data x
    demo` mesh the items are sharded over all its ranks in rank order, as
    JAX's cache shards them over every device (:135-168, P(("data",
    "demo"))), so the rows of data index i are the draws of shards i * D ..
    i * D + D - 1, one on each rank of its demo group; the group exchanges
    them (parallel/mesh.py:demo_group_rows, an all_to_all) and each rank
    keeps its demos of the seen-demo keys: shard_batch_2d of JAX's global
    batch, which JAX's jit reshards to P("data", "demo").

    The batch of step s is the stream's s-th draw (`batch(s)`;
    `fast_forward(n)` skips n draws on the host), so a resumed run, or a
    later stage started at step s, replays what an uninterrupted run from
    step 0 would draw. `set_batch_size` re-aims the cache at another global
    batch size (the bs 32 -> 8 second stage) without copying the split
    again; the stream restarts from the seed.

    A split read from HDF5 keeps its packed host arrays in the
    `device_cache_v1/` sidecar beside data.hdf5 (per-key .npy files and
    meta.json with the item count, data.hdf5's (size, mtime_ns) and the
    built k; any mismatch rebuilds), built at the dataset's full k when that
    fits HOST_BUDGET_BYTES. The sidecar is the JAX package's: either
    package reads the other's. An in-memory split (no dataset_path) packs
    its arrays in memory."""

    # keys whose leading demo axis is sliced to num_k at load time
    _K_SLICED = ("dc_s_h", "dc_per", "c_a_raw", "demo_len")

    def __init__(self, dataset, device, batch_size, seed,
                 include_test_actions=False, mesh=None):
        self.device = torch.device(device)
        self.seed = seed
        self.ids = np.asarray(dataset.ids)
        self.n = n = len(self.ids)
        self.mesh = mesh
        self.n_shards = 1 if mesh is None else mesh.world
        self.rank = 0 if mesh is None else mesh.rank
        self._check_batch_size(batch_size)
        if mesh is not None and dataset.num_k % mesh.demo_par:
            raise ValueError(f"{dataset.num_k} demos do not split over "
                             f"{mesh.demo_par} demo indices")
        self.batch_size = batch_size
        pad = (-n) % self.n_shards
        if pad > n:
            raise ValueError(f"a split of {n} items cannot be padded to "
                             f"{self.n_shards} shards")
        self._per_shard = (n + pad) // self.n_shards
        self._shard_counts = [
            min(self._per_shard, max(0, n - s * self._per_shard))
            for s in range(self.n_shards)]
        host = self._load_or_build(dataset, include_test_actions)
        if self.n_shards > 1:  # this rank's shard; pad rows copy items 0..
            rows = np.arange(self.rank * self._per_shard,
                             (self.rank + 1) * self._per_shard)
            rows = np.where(rows < n, rows, rows - n)
            host = {k: v[rows] for k, v in host.items()}
        nbytes = sum(v.nbytes for v in host.values())
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if nbytes > free:
                raise RuntimeError(
                    f"the ViZDoom train split needs {nbytes} bytes on "
                    f"{self.device}, {free} are free; use fewer programs or "
                    f"a smaller --num_k")
        log.info("doom device cache: %.2f GB (%d items%s) on %s",
                 nbytes / 1e9, n, "" if self.n_shards == 1 else
                 f", shard {self.rank} of {self.n_shards}", self.device)
        self.data = to_device(host, self.device)
        self._reset()

    def _check_batch_size(self, batch_size):
        if batch_size > self.n:
            raise ValueError(
                f"batch_size {batch_size} exceeds split size {self.n}")
        if batch_size % self.n_shards:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"{self.n_shards} mesh devices")

    def _load_or_build(self, ds, include_test_actions):
        if ds.dataset_path is None:
            arrays = self._build_host_arrays(ds, True)
        else:
            arrays = self._sidecar(ds)
        out = {}
        for key, v in arrays.items():
            if not include_test_actions and key.startswith("test_"):
                continue
            v = v[:, :ds.num_k] if key in self._K_SLICED else v
            out[key] = np.ascontiguousarray(v)
        return out

    def _sidecar(self, ds):
        """The packed host arrays of an HDF5 split, from the sidecar or
        built and written there."""
        cache_dir = osp.join(ds.dataset_path, "device_cache_v1")
        meta_path = osp.join(cache_dir, "meta.json")
        split = "".join(c for c in ds.name if c.isalnum()) or "split"
        fp = _h5_fingerprint(ds)
        entry = None
        if osp.exists(meta_path):
            with open(meta_path) as f:
                entry = json.load(f).get(split)
        fresh = (isinstance(entry, dict) and entry.get("n") == len(ds.ids)
                 and entry.get("fp") == fp and entry.get("k", 0) >= ds.num_k)
        if fresh:
            return {fn[len(split) + 1:-4]: np.load(osp.join(cache_dir, fn),
                                                   mmap_mode="r")
                    for fn in os.listdir(cache_dir)
                    if fn.startswith(split + "_") and fn.endswith(".npy")}
        if entry is not None:
            log.warn("device cache sidecar for %s is stale (dataset or "
                     "num_k changed); rebuilding", split)
        build_k = ds.num_demo
        if estimate_cache_bytes(ds, k=build_k) > HOST_BUDGET_BYTES:
            build_k = ds.num_k
            log.warn("full-k host cache would exceed %.0f GB; building at "
                     "num_k=%d only", HOST_BUDGET_BYTES / 1e9, build_k)
        arrays = self._build_host_arrays(ds, True, k=build_k)
        try:
            os.makedirs(cache_dir, exist_ok=True)
            for key, v in arrays.items():
                with _replaced(osp.join(cache_dir, f"{split}_{key}.npy")) \
                        as f:
                    np.save(f, v)
            meta = {}
            if osp.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
            meta[split] = {"n": len(ds.ids), "fp": fp, "k": build_k}
            with _replaced(meta_path, "w") as f:
                json.dump(meta, f)
        except OSError:
            log.warn("device cache sidecar not writable; in memory only")
        return arrays

    @staticmethod
    def _build_host_arrays(ds, include_test_actions, k=None):
        k = ds.num_k if k is None else k
        T, L = ds.max_demo_len, ds.max_program_len
        n = len(ds.ids)
        first = ds._store[ds.ids[0]]
        h, w, c = first["s_h"].shape[2:5]
        P = first["p_v_h"].shape[2]
        out = {
            "dc_s_h": np.zeros((n, k, T, h, w, c), np.uint8),
            "dc_per": np.zeros((n, k, T, P), np.uint8),
            "c_a_raw": np.zeros((n, k, T), np.int8),
            "c_a_row_len": np.zeros((n, 1), np.int32),
            "demo_len": np.zeros((n, k), np.float32),
            "program_tokens": np.zeros((n, L), np.int32),
            "program_len": np.zeros((n, 1), np.float32),
        }
        if include_test_actions:
            tk = ds.test_k
            out["test_c_a_raw"] = np.zeros((n, tk, T), np.int8)
            out["test_c_a_row_len"] = np.zeros((n, 1), np.int32)
            out["test_demo_len"] = np.zeros((n, tk), np.float32)
        for i, id_ in enumerate(ds.ids):
            g = ds._store[id_]
            s_h = g["s_h"][:k]
            out["dc_s_h"][i, :, :s_h.shape[1]] = s_h.astype(np.uint8)
            pv = g["p_v_h"][:k]
            out["dc_per"][i, :, :pv.shape[1]] = pv.astype(np.uint8)
            a = g["a_h"][:k]
            out["c_a_raw"][i, :, :a.shape[1]] = a
            out["c_a_row_len"][i, 0] = a.shape[1]
            out["demo_len"][i] = g["s_h_len"][:k]
            prog = g["program"][()]
            out["program_tokens"][i, :len(prog)] = prog
            out["program_len"][i, 0] = len(prog)
            if include_test_actions:
                ta = g["test_a_h"][()]
                out["test_c_a_raw"][i, :, :ta.shape[1]] = ta
                out["test_c_a_row_len"][i, 0] = ta.shape[1]
                out["test_demo_len"][i] = g["test_s_h_len"][()]
            if i and i % 2000 == 0:
                log.info("doom device cache: read %d / %d items", i, n)
        return out

    def _reset(self):
        self.rng = np.random.RandomState(self.seed)
        self._order, self._pos, self._next = None, 0, 0
        self._orders = [None] * self.n_shards
        self._shard_pos = [0] * self.n_shards

    def set_batch_size(self, batch_size):
        """Draw global batches of `batch_size` from now on (the stream
        restarts from the seed); the split stays where it is."""
        self._check_batch_size(batch_size)
        if batch_size != self.batch_size:
            self.batch_size = batch_size
            self._reset()

    def _draw(self):
        """The stream's next draw -> (local rows, global rows), one array
        of each per shard."""
        self._next += 1
        if self.n_shards > 1:
            return self._draw_sharded()
        if self._order is None or self._pos + self.batch_size > self.n:
            self._order = self.rng.permutation(self.n)
            self._pos = 0
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return [idx], [idx]

    def _draw_sharded(self):
        """demo2program_tpu/train/device_cache.py:337-358, draw for draw."""
        bs_local = self.batch_size // self.n_shards
        local, global_ = [], []
        for s in range(self.n_shards):
            cnt = self._shard_counts[s]
            if cnt == 0:  # a tiny split: the shard samples its pad rows
                li = self.rng.randint(0, self._per_shard, size=bs_local)
            else:
                if (self._orders[s] is None
                        or self._shard_pos[s] + bs_local > cnt):
                    self._orders[s] = self.rng.permutation(cnt)
                    self._shard_pos[s] = 0
                li = self._orders[s][
                    self._shard_pos[s]:self._shard_pos[s] + bs_local]
                if len(li) < bs_local:  # shard smaller than bs_local
                    li = np.resize(li, bs_local)
                self._shard_pos[s] += bs_local
            local.append(li)
            r = s * self._per_shard + li  # pad rows copy items 0..pad-1
            global_.append(np.where(r < self.n, r, r - self.n))
        return local, global_

    def fast_forward(self, n):
        """Skip the next `n` draws of the stream (host only)."""
        for _ in range(n):
            self._draw()

    def draws(self, step):
        """The stream's step-th draw -> (local rows, global rows) of every
        shard."""
        if step < self._next:
            self._reset()
        self.fast_forward(step - self._next)
        return self._draw()

    def indices(self, step):
        """This rank's rows of its shard in step `step` (host int64
        array)."""
        return self.draws(step)[0][self.rank]

    def batch(self, step):
        """The rank's part of the batch of step `step` (its rows, and on a
        2-D mesh its demos), gathered on the device."""
        idx = torch.as_tensor(self.indices(step), device=self.device)
        return demo_group_rows({k: v.index_select(0, idx)
                                for k, v in self.data.items()}, self.mesh)
