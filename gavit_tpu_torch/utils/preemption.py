"""Preemption-aware training (the port's copy of
``gavit_tpu/utils/preemption.py``): on a preemptible machine SIGTERM
arrives shortly before it goes away.

``PreemptionHandler`` latches SIGTERM; the trainer polls it after every
step and at epoch boundaries, saves a checkpoint marked incomplete, and
exits cleanly. With ``scripts/train_torch.py --resume auto`` (the latest
checkpoint in ``save_dir``) training survives kill/restart cycles.
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger(__name__)


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        self._signals = signals

    def install(self):
        for sig in self._signals:
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                # not the main thread (e.g. under pytest-xdist) — skip
                logger.warning(f"cannot install handler for {sig!r}")
        return self

    def _on_signal(self, signum, frame):
        logger.warning(
            f"Received signal {signum}: checkpointing at next safe point"
        )
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
