#!/usr/bin/env python
"""Checkpoint inspection for the PyTorch port (counterpart of
``scripts/inspect_checkpoint.py``): structure, shapes, dtypes, metadata
and, with ``--stats``, each floating tensor's mean, std and finiteness.

    python scripts/inspect_checkpoint_torch.py <path> [--stats]

``<path>``: a checkpoint directory of the port (``state.pt`` +
``meta.json``: ``scripts/train_torch.py``'s, ``pretrain_mae_torch.py``'s
``mae_epoch_*``, ``convert_checkpoint_torch.py``'s), a ``.pt`` / ``.pth``
file (a reference-layout state dict, under ``model``, ``model_state_dict``
or ``state_dict`` or at the top), or an ``.npz`` (``--to-torch``'s).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from _walk(tree[key], f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _walk(item, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), tree


def _as_array(leaf):
    import torch

    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().float().numpy() if (
            leaf.dtype == torch.bfloat16) else leaf.detach().cpu().numpy()
    if isinstance(leaf, np.ndarray):
        return leaf
    return None


def print_leaves(leaves, stats: bool) -> int:
    """One line a leaf: name, dtype, shape (and the stats); a non-array
    leaf by its type and value. Returns the elements counted."""
    total = 0
    for name, leaf in leaves:
        arr = _as_array(leaf)
        if arr is None:
            print(f"{name:70s} <{type(leaf).__name__}> {leaf!r}"[:160])
            continue
        total += arr.size
        dtype = str(getattr(leaf, "dtype", arr.dtype)).replace("torch.", "")
        line = f"{name:70s} {dtype:9s} {tuple(arr.shape)}"
        if stats and arr.size and np.issubdtype(arr.dtype, np.floating):
            line += (f"  mean={arr.mean():+.4e} std={arr.std():.4e}"
                     f" finite={bool(np.isfinite(arr).all())}")
        print(line)
    print(f"== total: {total:,} elements ==")
    return total


def inspect_checkpoint(path: str, stats: bool) -> int:
    from gavit_tpu_torch.utils.checkpoint import restore

    state, meta = restore(path, map_location="cpu")
    print("== metadata ==")
    print(json.dumps({k: v for k, v in meta.items()
                      if k not in ("config", "loader_state")},
                     indent=2, default=str)[:2000])
    if "loader_state" in meta:
        print(f"== loader state: {len(meta['loader_state'])} bytes ==")
    print("== state tree ==")
    return print_leaves(_walk(state), stats)


def inspect_file(path: str, stats: bool) -> int:
    if path.endswith(".npz"):
        with np.load(path) as z:
            print(f"== npz: {len(z.files)} arrays ==")
            return print_leaves(((k, z[k]) for k in sorted(z.files)), stats)
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and not all(
            hasattr(v, "shape") for v in ckpt.values()):
        print(f"== top-level keys: {sorted(ckpt.keys(), key=str)} ==")
        for key in ("model", "model_state_dict", "state_dict"):
            if key in ckpt:
                ckpt = ckpt[key]
                print(f"== descending into {key!r} ==")
                break
    return print_leaves(_walk(ckpt), stats)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("path")
    parser.add_argument("--stats", action="store_true",
                        help="print mean/std/finiteness per tensor")
    args = parser.parse_args(argv)
    if os.path.isdir(args.path):
        return inspect_checkpoint(args.path, args.stats)
    return inspect_file(args.path, args.stats)


if __name__ == "__main__":
    main()
