#!/usr/bin/env python
"""Pack a ChestX-ray14-style dataset into a zero-decode uint8 memmap for the
PyTorch port (``gavit_tpu_torch``): the same files as
``scripts/prepare_dataset.py`` writes, without importing the JAX package.

Decodes and resizes every image once on a thread pool into ``images.npy``
(an ``[N, S, S, 3]`` uint8 memmap), then writes ``labels.npy`` and
``meta.json``; ``PackedChestXrayDataset`` then reads a batch at memcpy
speed instead of decoding each PNG in the training loop.

    python scripts/prepare_dataset_torch.py --image-dir <dir> \\
        --labels <list.txt> --out <packed_dir> [--image-size 224] \\
        [--workers 16]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from gavit_tpu_torch.data.dataset import load_image, parse_label_file  # noqa: E402

logger = logging.getLogger("prepare_dataset_torch")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--image-dir", required=True)
    p.add_argument("--labels", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--workers", type=int, default=16)
    args = p.parse_args(argv)

    paths, labels = parse_label_file(args.labels)
    n, s = len(paths), args.image_size
    os.makedirs(args.out, exist_ok=True)
    images = np.lib.format.open_memmap(
        os.path.join(args.out, "images.npy"), mode="w+", dtype=np.uint8,
        shape=(n, s, s, 3))

    def pack_one(i):
        images[i] = load_image(os.path.join(args.image_dir, paths[i]), s)

    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        for done, _ in enumerate(pool.map(pack_one, range(n)), 1):
            if done % 5000 == 0:
                logger.info(f"packed {done}/{n}")
    images.flush()

    np.save(os.path.join(args.out, "labels.npy"), labels)
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump({
            "image_size": s,
            "paths": [str(x) for x in paths],
            "source_image_dir": args.image_dir,
            "source_labels": args.labels,
        }, f)
    logger.info(f"Packed {n} images @ {s}px → {args.out} "
                f"({images.nbytes / 1e9:.2f} GB)")


if __name__ == "__main__":
    main()
