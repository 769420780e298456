"""Full-state training checkpoints with ``torch.save`` (counterpart of
``gavit_tpu/utils/checkpoint.py``, which writes orbax; the port reads and
writes no orbax).

A checkpoint is a directory named as the JAX package names it
(:func:`checkpoint_name`: ``checkpoint_epoch_{E}_auc_{AUC:.4f}``, plus a
``best_model`` copy) holding one file, ``state.pt``: the state tree (the
model's fp32 parameters, the criterion's λ, the AdamW state of every
group, the schedule step, the trainer's generator state), its metadata
(epoch, next epoch, best AUC and epoch, patience counter, metrics, config)
and, for a mid-epoch save, the train loader's position as bytes
(``has_loader_state`` in the metadata; one process, so no per-process
sidecar as the JAX package writes). A QAT run's state also holds its
activation scales under ``quant`` (``{site path: {'act_scale': t}}``),
and its metadata says so with ``has_quant``.
The file is written under a temporary name in the same directory and
renamed into place, so a process killed mid-write leaves the previous file
or none, never half of one; ``meta.json`` beside it is a readable copy of
the metadata. :func:`latest_checkpoint` takes only directories whose
``state.pt`` exists.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any

import torch

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"
_META_FILE = "meta.json"
_EPOCH_RE = re.compile(r"checkpoint_epoch_(\d+)_auc_([0-9.]+)$")


def checkpoint_name(epoch: int, auc: float) -> str:
    return f"checkpoint_epoch_{epoch}_auc_{auc:.4f}"


def _replace_into(path: str, write) -> None:
    """``write(tmp)`` then rename ``tmp`` onto ``path`` (atomic)."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save(path: str, state: Any, meta: dict,
         also: tuple[str, ...] = (), loader_state: bytes | None = None) -> None:
    """Write ``{'state': state, 'meta': meta}`` (and ``loader_state`` where
    given) to ``<path>/state.pt`` (and the same file into each directory of
    ``also``: a hard link where the file system has them, else a copy)."""
    path = os.path.abspath(path)
    blob = {"state": state, "meta": meta}
    if isinstance(state, dict) and state.get("quant"):
        meta = blob["meta"] = {**meta, "has_quant": True}
    if loader_state is not None:
        meta = blob["meta"] = {**meta, "has_loader_state": True}
        blob["loader_state"] = bytes(loader_state)
    os.makedirs(path, exist_ok=True)

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2, default=str)

    _replace_into(os.path.join(path, _META_FILE), write_meta)
    target = os.path.join(path, STATE_FILE)
    _replace_into(target, lambda tmp: torch.save(blob, tmp))

    def link(tmp):
        try:
            os.link(target, tmp)
        except OSError:
            shutil.copyfile(target, tmp)

    for extra in also:
        extra = os.path.abspath(extra)
        os.makedirs(extra, exist_ok=True)
        _replace_into(os.path.join(extra, _META_FILE), write_meta)
        _replace_into(os.path.join(extra, STATE_FILE), link)
    logger.info(f"Saved checkpoint to {path}")


def restore(path: str, map_location=None) -> tuple[Any, dict]:
    """``(state, meta)`` from a checkpoint directory; a saved loader
    position is ``meta['loader_state']`` (bytes)."""
    blob = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location=map_location, weights_only=False)
    logger.info(f"Restored checkpoint from {path}")
    meta = blob["meta"]
    if "loader_state" in blob:
        meta = {**meta, "loader_state": blob["loader_state"]}
    return blob["state"], meta


def latest_checkpoint(save_dir: str) -> str | None:
    """Most recent per-epoch checkpoint directory, or None."""
    if not os.path.isdir(save_dir):
        return None
    best_epoch, best_path = -1, None
    for name in os.listdir(save_dir):
        m = _EPOCH_RE.match(name)
        if m and int(m.group(1)) > best_epoch:
            full = os.path.join(save_dir, name)
            if os.path.isfile(os.path.join(full, STATE_FILE)):
                best_epoch, best_path = int(m.group(1)), full
    return best_path
