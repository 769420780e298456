"""Host-side batching loader with threaded decode and device prefetch
(counterpart of ``gavit_tpu/data/loader.py``).

``DataLoader``: seeded per-epoch shuffles (``np.random.default_rng(seed +
epoch)``, the order the JAX loader gives), ``set_epoch``, ``drop_last``
off by default with a ragged last batch, and the next batch assembled on a
lookahead thread while the current one is consumed. A dataset with a
``batch(indices)`` method (the synthetic and packed sets) is read a batch
at a time; any other is read item by item through ``__getitem__`` on a
pool of ``num_workers`` decode threads, separate from the lookahead thread
(PIL's decode and resize release the GIL, so threads decode in parallel).
Process sharding (the JAX loader's ``shard_by_process``) waits for ROADMAP
Queue 1 item 13.

Unlike the JAX ``DataLoader``, and as its ``GrainLoader``, the loader
keeps its position (the epoch, the records of it handed out): batches
never straddle an epoch, ``set_epoch`` is idempotent (the current epoch
keeps a restored mid-epoch position, another starts from its first
record), and ``get_state`` / ``set_state`` carry the position as bytes,
so a mid-epoch checkpoint resumes on the next unseen record
(``data/checkpointable.py`` names it as GrainLoader's counterpart).

:func:`device_iterator` keeps ``prefetch`` batches in flight on the device
ahead of the step that consumes them: pinned uint8 with ``non_blocking``
copies (:func:`to_device`). With ``pin_memory`` a loader hands out torch
tensors in pinned memory, copied there on its lookahead thread, so the
consumer's thread only issues the copies to the card.
"""

from __future__ import annotations

import collections
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def read_batch(dataset, indices, pool=None, pin_memory: bool = False):
    """uint8 images ``[B, S, S, 3]`` and labels ``[B, C]`` of ``indices``:
    the dataset's ``batch`` where it has one, else its items, mapped over
    ``pool`` when given; numpy arrays, or with ``pin_memory`` CPU tensors
    in pinned memory."""
    if hasattr(dataset, "batch"):
        batch = dataset.batch(indices)
    else:
        idx = [int(i) for i in indices]
        items = list(pool.map(dataset.__getitem__, idx) if pool is not None
                     else map(dataset.__getitem__, idx))
        batch = (np.stack([it[0] for it in items]),
                 np.stack([it[1] for it in items]))
    batch = tuple(np.ascontiguousarray(a) for a in batch)
    if pin_memory:
        return tuple(torch.from_numpy(a).pin_memory() for a in batch)
    return batch


_STATE_VERSION = 1


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False,
                 seed: int = 42, pin_memory: bool = False):
        """``num_workers``: decode threads for a dataset read item by item
        (0: on the lookahead thread); ``pin_memory``: hand out pinned CPU
        tensors (for a card)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self._consumed = 0  # records of `epoch` handed out
        # separate pools: the lookahead task waits on the decode tasks it
        # fans out, so it must not occupy one of their threads
        self._item_pool = (ThreadPoolExecutor(max_workers=num_workers)
                           if num_workers > 0 else None)
        self._pool = ThreadPoolExecutor(max_workers=1)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        if epoch != self.epoch:
            self.epoch, self._consumed = epoch, 0

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def _load_batch(self, idx):
        return read_batch(self.dataset, idx, self._item_pool,
                          self.pin_memory)

    def __iter__(self):
        """The remaining batches of the current epoch; the loader then
        stands at the start of the next. The position advances as each
        batch is handed out, so ``get_state`` between two batches is the
        resume point whatever the lookahead has assembled."""
        epoch, indices = self.epoch, self._indices()
        bs = self.batch_size
        end = len(self) * bs if self.drop_last else len(indices)
        starts = range(self._consumed, end, bs)
        slices = [indices[s:min(s + bs, end)] for s in starts]
        # one-batch lookahead: assemble batch i+1 while batch i is consumed
        pending = self._pool.submit(self._load_batch, slices[0]) \
            if slices else None
        for i, start in enumerate(starts):
            batch = pending.result()
            if i + 1 < len(slices):
                pending = self._pool.submit(self._load_batch, slices[i + 1])
            if self.epoch != epoch:  # set_epoch moved the loader away
                return
            self._consumed = min(start + bs, end)
            yield batch
        self.epoch, self._consumed = epoch + 1, 0

    def get_state(self) -> bytes:
        """The position: the epoch and the records consumed in it."""
        return json.dumps({"loader_state": _STATE_VERSION,
                           "epoch": self.epoch,
                           "consumed": self._consumed,
                           "seed": self.seed,
                           "records": len(self.dataset)}).encode()

    def set_state(self, state: bytes):
        try:
            payload = json.loads(state)
            if payload.get("loader_state") != _STATE_VERSION:
                raise ValueError(payload.get("loader_state"))
        except ValueError as e:
            raise ValueError("unrecognized loader state") from e
        if (payload["seed"], payload["records"]) != (self.seed,
                                                    len(self.dataset)):
            raise ValueError(
                f"loader state of seed {payload['seed']} over "
                f"{payload['records']} records does not fit this loader "
                f"(seed {self.seed}, {len(self.dataset)} records)")
        self.epoch = payload["epoch"]
        self._consumed = payload["consumed"]


def to_device(array, device) -> torch.Tensor:
    """A host array or CPU tensor on ``device``: through pinned memory
    (pinned here unless it is already) with a non-blocking copy to a card,
    as it is on the CPU."""
    t = array if torch.is_tensor(array) else torch.from_numpy(
        np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type != "cuda":
        return t
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def prefetched_iter(it, place, prefetch: int):
    """Keep ``prefetch`` placed items in flight ahead of consumption:
    ``place(item)`` runs as each item is pulled, so its device copy
    overlaps the consumer's work on the items before it."""
    queue = collections.deque()
    try:
        for _ in range(max(1, prefetch)):
            queue.append(place(next(it)))
    except StopIteration:
        pass
    while queue:
        try:
            queue.append(place(next(it)))
        except StopIteration:
            pass
        yield queue.popleft()


def device_iterator(loader, device, prefetch: int = 2, state_fn=None):
    """``(images, labels, state)`` of each batch of one pass over
    ``loader``, on ``device``, ``prefetch`` batches ahead. ``state_fn``
    (a loader's ``get_state``) is called right after each
    batch is pulled and before the lookahead pulls the next, so ``state``
    is the resume point "every batch up to and including this one was
    consumed" whatever the prefetch depth (None without ``state_fn``)."""
    def place(batch):
        state = state_fn() if state_fn is not None else None
        images, labels = batch
        return to_device(images, device), to_device(labels, device), state

    yield from prefetched_iter(iter(loader), place, prefetch)
