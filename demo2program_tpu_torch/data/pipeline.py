"""Host -> device input pipeline: batches assembled and copied ahead of the
step that reads them.

Port of demo2program_tpu/data/pipeline.py. A thread pool assembles numpy
batches from a split (Karel: the compact wire format, `get_batch_compact`;
ViZDoom: the full wire, `get_batch`, as eval/evaler.py:fetch_batch serves
them) and, on the card, copies each one to the device inside the worker,
so the copy overlaps the training step instead of blocking it (`_ship`, the
counterpart of the JAX worker's `jax.device_put`): the host arrays are
pinned, copied with non_blocking=True on a CUDA stream the pipeline owns,
and an event is recorded after the copies. `__next__` makes the caller's
current stream wait on that event and marks every tensor as used there
(`record_stream`), so the caching allocator does not hand its memory to
another tensor before the step that reads it has run. A failed copy raises
in `__next__`; nothing falls back to the CPU. On the CPU a batch becomes
tensors that share the numpy arrays' memory.

The id stream is the JAX pipeline's: numpy RandomState(seed) shuffles the
split's order every epoch and the ragged tail is dropped; with
shuffle=False it walks one epoch in order. `fast_forward(n)` skips n
batches without loading them (exact resume); batches already queued count
as drawn. `close()` shuts the worker threads down.

Under a data mesh (parallel/mesh.py) every rank walks the global id stream
of `batch_size` ids a batch and makes and ships only its own rows of each
batch, [r * bs / N, (r + 1) * bs / N), as the JAX pipeline's sharded
device_put leaves each chip its rows (demo2program_tpu/data/pipeline.py:
108-119). On a 2-D `data x demo` mesh those are the rows of its data index,
and the worker cuts the seen-demo keys to the rank's demos before the
pinned copy: shard_batch_2d of the global batch, a D-th of the demos'
bytes shipped.
"""

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from demo2program_tpu_torch.parallel.mesh import shard_demos, shard_rows
from demo2program_tpu_torch.train.step import NON_TENSOR_KEYS


class BatchPipeline:
    """Iterates dict batches over a split (`ids` and `get_batch_compact`
    with compact=True, else `get_batch`): tensors on `device` and the
    batch's ids under "id" (a numpy array).

    shuffle=True -> epoch-reshuffled infinite stream (training);
    shuffle=False -> one epoch in order (eval), dropping the ragged tail
    like the reference's fixed `max_steps = len(ids) // batch_size`
    (`evaler.py:448-449`). `batch_size` is the global batch's; with a data
    `mesh` a batch holds the rank's part of it (its rows, and on a 2-D
    mesh its demos).
    """

    def __init__(self, dataset, batch_size, device, shuffle=True, seed=0,
                 num_threads=4, prefetch=4, drop_keys=(), compact=False,
                 mesh=None):
        self.dataset = dataset
        self.batch_size = batch_size
        if batch_size > len(dataset.ids):
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size "
                f"{len(dataset.ids)} ({getattr(dataset, 'name', '?')})")
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.device = torch.device(device)
        self.drop_keys = frozenset(drop_keys)
        self.mesh = mesh
        self._compact = compact
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._pool = ThreadPoolExecutor(max_workers=num_threads)
        self._prefetch = prefetch
        self._queue = deque()
        self._id_iter = self._make_id_iter()
        self._lock = threading.Lock()
        self.bytes_shipped = 0  # of the batches handed out

    def _make_id_iter(self):
        ids = list(self.dataset.ids)
        while True:
            order = list(range(len(ids)))
            if self.shuffle:
                self.rng.shuffle(order)
            n_full = len(order) // self.batch_size
            for b in range(n_full):
                yield [ids[i] for i in
                       order[b * self.batch_size:(b + 1) * self.batch_size]]
            if not self.shuffle:
                return  # single epoch for eval

    def fast_forward(self, n):
        """Skip the next `n` batches without loading them (exact resume: a
        relaunched trainer replays the id stream past the batches the dead
        run consumed). Queued batches count as drawn: they are discarded
        first (one already being made runs to its end, unread)."""
        with self._lock:
            while self._queue and n > 0:
                self._queue.popleft().cancel()
                n -= 1
            for _ in range(n):
                try:
                    next(self._id_iter)
                except StopIteration:
                    break

    def _load_batch(self, id_batch):
        id_batch = shard_rows(np.asarray(id_batch), self.mesh).tolist()
        if self._compact:
            host = self.dataset.get_batch_compact(id_batch)
        else:
            host = self.dataset.get_batch(id_batch)
        return self._ship(shard_demos({k: v for k, v in host.items()
                                       if k not in self.drop_keys},
                                      self.mesh))

    def _ship(self, batch):
        """numpy batch -> (batch of tensors on the device, the event that
        follows their copies, or None on the CPU)."""
        arrays = {k: np.ascontiguousarray(v) for k, v in batch.items()
                  if k not in NON_TENSOR_KEYS}
        if self._stream is None:
            out = {k: torch.from_numpy(v) for k, v in arrays.items()}
            event = None
        else:
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                out = {k: torch.from_numpy(v).pin_memory().to(
                    self.device, non_blocking=True)
                    for k, v in arrays.items()}
                event = torch.cuda.Event()
                event.record(self._stream)
        for key in NON_TENSOR_KEYS:
            if key in batch:
                out[key] = batch[key]
        return out, event

    def _ensure_prefetch(self):
        with self._lock:
            while len(self._queue) < self._prefetch:
                try:
                    id_batch = next(self._id_iter)
                except StopIteration:
                    break
                self._queue.append(
                    self._pool.submit(self._load_batch, id_batch))

    def __iter__(self):
        return self

    def __next__(self):
        self._ensure_prefetch()
        if not self._queue:
            raise StopIteration
        batch, event = self._queue.popleft().result()
        self.bytes_shipped += sum(t.nbytes for k, t in batch.items()
                                  if k not in NON_TENSOR_KEYS)
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for key, t in batch.items():
                if key not in NON_TENSOR_KEYS:
                    t.record_stream(stream)
        self._ensure_prefetch()
        return batch

    def close(self):
        """Drop the queued batches and stop the worker threads."""
        with self._lock:
            while self._queue:
                self._queue.popleft().cancel()
        self._pool.shutdown(wait=True, cancel_futures=True)
