"""Host-side batching loader (counterpart of ``gavit_tpu/data/loader.py``'s
``DataLoader``, without its process sharding).

Seeded per-epoch shuffles (``np.random.default_rng(seed + epoch)``, the
order the JAX loader gives), ``set_epoch``, ``drop_last`` off by default
with a ragged last batch, and the next batch assembled on a worker thread
while the current one is consumed. A dataset with a ``batch(indices)``
method (the synthetic set) is read a batch at a time, any other item by
item through ``__getitem__``. :func:`to_device` moves a host batch to the
card as pinned uint8 with ``non_blocking`` copies.

Like the JAX ``DataLoader`` it has no ``get_state``: a mid-epoch
checkpoint restarts that epoch's data order. The checkpointable sampler
waits for ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 42):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self._pool = ThreadPoolExecutor(max_workers=1)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def _load_batch(self, idx):
        if hasattr(self.dataset, "batch"):
            images, labels = self.dataset.batch(idx)
            return np.ascontiguousarray(images), np.ascontiguousarray(labels)
        items = [self.dataset[int(i)] for i in idx]
        return (np.stack([it[0] for it in items]),
                np.stack([it[1] for it in items]))

    def __iter__(self):
        indices = self._indices()
        bs = self.batch_size
        slices = [indices[i * bs:(i + 1) * bs] for i in range(len(self))]
        # one-batch lookahead: assemble batch i+1 while batch i is consumed
        pending = self._pool.submit(self._load_batch, slices[0]) \
            if slices else None
        for i in range(len(slices)):
            batch = pending.result()
            if i + 1 < len(slices):
                pending = self._pool.submit(self._load_batch, slices[i + 1])
            yield batch
        self.epoch += 1


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory with a
    non-blocking copy to a card, as it is on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
