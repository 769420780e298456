"""Checkpointable batching loader: the port's counterpart of
``gavit_tpu/data/grain_pipeline.py::GrainLoader`` (the card's machine has
no grain), selected by ``data.loader: grain``.

The threaded ``DataLoader`` (``data/loader.py``) already keeps what
GrainLoader adds to the JAX loader: its position serialises with a
mid-epoch checkpoint (``get_state`` / ``set_state``), so a preempted run
resumes on the next unseen record; batches never straddle an epoch;
``set_epoch`` is idempotent; ``len`` counts the batches of one epoch. So
this loader is that one. The order of an epoch is the threaded loader's
(``np.random.default_rng(seed + epoch).permutation``), not grain's own
shuffle: a kept divergence (ROADMAP Queue 3). Process sharding waits for
ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

from gavit_tpu_torch.data.loader import DataLoader


class CheckpointableLoader(DataLoader):
    """``DataLoader`` under GrainLoader's name."""
