"""Device-resident Karel train split, with batches drawn on the device.

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
"""

import numpy as np
import torch

from demo2program_tpu_torch.utils import log
from demo2program_tpu_torch.train.step import to_device


class KarelDeviceCache:
    """The compact split of `dataset` (anything with `ids` and
    `get_batch_compact(ids)`: an HDF5 KarelDataset or an
    InMemoryKarelSplit) on `device`. The unseen-demo `test_*` arrays are
    kept only with `include_test`: the induction baseline trains on the
    test demos' actions, the other models do not read them."""

    def __init__(self, dataset, device, batch_size, seed, include_test=False):
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
        self.device = torch.device(device)
        self.data = to_device(host, self.device)
        log.info("karel device cache: %.1f MB (%d items) on %s",
                 sum(t.nbytes for t in self.data.values()) / 1e6, self.n,
                 self.device)
        self._epoch, self._perm = None, None

    def permutation(self, epoch):
        """Row order of `epoch` (host int64 array)."""
        return np.random.default_rng((self.seed, epoch)).permutation(self.n)

    def indices(self, step):
        """Rows of step `step` (int64 tensor on the device)."""
        epoch, s_in_e = divmod(step, self.steps_per_epoch)
        if epoch != self._epoch:
            self._epoch = epoch
            self._perm = torch.as_tensor(self.permutation(epoch),
                                         device=self.device)
        bs = self.batch_size
        return self._perm[s_in_e * bs:(s_in_e + 1) * bs]

    def batch(self, step):
        """The compact batch of step `step`, gathered on the device."""
        idx = self.indices(step)
        return {k: v.index_select(0, idx) for k, v in self.data.items()}
