"""NIH ChestX-ray14 datasets (the port's copy of
``gavit_tpu/data/dataset.py``): the label file, the image-folder dataset,
the packed memmap that ``scripts/prepare_dataset_torch.py`` (or the JAX
package's ``scripts/prepare_dataset.py``) writes, and the synthetic set.

The label file is space-delimited: an image file name, then 14 float
labels. Samples are uint8 HWC images at the training resolution and fp32
label vectors; an image file is converted to RGB and resized with PIL's
BILINEAR (which antialiases when it shrinks), so its bytes are the JAX
dataset's. Every float step (normalise, augment) runs on the device
(``gavit_tpu_torch/ops/preprocess.py``). ``zero_decode`` marks a dataset
whose items are memcpys, as the JAX classes mark it; such a dataset has
``batch``, which the loader reads without decode threads.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

DISEASE_NAMES = [
    "Atelectasis", "Cardiomegaly", "Effusion", "Infiltration",
    "Mass", "Nodule", "Pneumonia", "Pneumothorax", "Consolidation",
    "Edema", "Emphysema", "Fibrosis", "Pleural_Thickening", "Hernia",
]

NUM_CLASSES = len(DISEASE_NAMES)


def parse_label_file(label_file: str):
    """The space-delimited label file → (file names, labels ``[N, 14]``)."""
    paths, labels = [], []
    with open(label_file) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            paths.append(parts[0])
            row = [float(v) for v in parts[1:15]]
            if len(row) != NUM_CLASSES:
                raise ValueError(
                    f"label line for {parts[0]!r} has {len(row)} labels, "
                    f"expected {NUM_CLASSES}")
            labels.append(row)
    if not paths:
        raise ValueError(f"empty label file: {label_file}")
    return np.asarray(paths), np.asarray(labels, np.float32)


def load_image(path: str, image_size: int) -> np.ndarray:
    """One image file as uint8 ``[S, S, 3]``: RGB, resized by PIL's
    BILINEAR where its size differs (the packer's and the dataset's read)."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        if img.size != (image_size, image_size):
            img = img.resize((image_size, image_size), Image.BILINEAR)
        return np.asarray(img, np.uint8)


def class_weights_from_labels(labels: np.ndarray) -> np.ndarray:
    """Per-class pos_weight = negative/positive counts.

    Classes with zero positives get weight 1.0 (with a warning) instead of
    ``inf``, which would turn the first positive into an inf WBCE term.
    """
    pos = labels.sum(axis=0)
    neg = len(labels) - pos
    w = np.where(pos > 0, neg / np.maximum(pos, 1.0), 1.0)
    if (pos == 0).any():
        degenerate = [
            DISEASE_NAMES[i] if i < len(DISEASE_NAMES) else str(i)
            for i in np.flatnonzero(pos == 0)
        ]
        logger.warning(
            "classes with zero positive samples get pos_weight=1.0: "
            f"{degenerate}"
        )
    return w.astype(np.float32)


class ChestXrayDataset:
    """Map-style dataset over an image folder and its label file, yielding
    (uint8 ``[S, S, 3]`` image, fp32 ``[14]`` labels); each item decodes
    and resizes its file."""

    disease_names = DISEASE_NAMES
    zero_decode = False

    def __init__(self, image_dir: str, label_file: str, image_size: int = 224):
        self.image_dir = image_dir
        self.image_size = image_size
        self.image_paths, self.labels = parse_label_file(label_file)
        self.class_weights = class_weights_from_labels(self.labels)
        logger.info(f"Loaded {len(self.image_paths)} images")
        pos = self.labels.sum(axis=0)
        for disease, count in zip(self.disease_names, pos):
            logger.info(f"{disease}: {int(count)} positive samples "
                        f"({count / len(self.labels) * 100:.2f}%)")

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx: int):
        path = os.path.join(self.image_dir, self.image_paths[idx])
        try:
            image = load_image(path, self.image_size)
        except Exception as e:
            logger.error(f"Error loading image {self.image_paths[idx]}: {e}")
            raise
        return image, self.labels[idx]


class PackedChestXrayDataset:
    """A packed split: ``images.npy`` (a uint8 ``[N, S, S, 3]`` memmap),
    ``labels.npy`` and ``meta.json``, decoded and resized once by the
    packer, read at memcpy speed with the same sample contract as
    :class:`ChestXrayDataset`."""

    disease_names = DISEASE_NAMES
    zero_decode = True

    def __init__(self, packed_dir: str):
        self.packed_dir = packed_dir
        with open(os.path.join(packed_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.image_size = int(self.meta["image_size"])
        self.images = self._open()
        self.labels = np.load(os.path.join(packed_dir, "labels.npy"))
        self.image_paths = np.asarray(self.meta["paths"])
        self.class_weights = class_weights_from_labels(self.labels)
        logger.info(f"Packed dataset: {len(self)} images @ "
                    f"{self.image_size}px ({self.images.nbytes / 1e9:.1f} "
                    f"GB memmap)")

    def _open(self):
        return np.load(os.path.join(self.packed_dir, "images.npy"),
                       mmap_mode="r")

    @staticmethod
    def is_packed(path: str) -> bool:
        return os.path.isdir(path) and os.path.exists(
            os.path.join(path, "images.npy"))

    def __getstate__(self):
        # a memmap pickles by value (the whole array into the stream):
        # drop it, and reopen it on the first read
        state = self.__dict__.copy()
        state["images"] = None
        return state

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx: int):
        if self.images is None:
            self.images = self._open()
        return np.asarray(self.images[idx]), self.labels[idx]

    def batch(self, indices) -> tuple[np.ndarray, np.ndarray]:
        """uint8 ``[B, S, S, 3]`` images (one gather from the memmap) and
        fp32 ``[B, 14]`` labels."""
        if self.images is None:
            self.images = self._open()
        idx = np.asarray(indices)
        return np.asarray(self.images[idx]), self.labels[idx]


class SyntheticChestXrayDataset:
    """Deterministic synthetic stand-in with the real dataset's sample
    contract; images and labels are a pure function of (seed, index), the
    same as the JAX package's for the same arguments.

    ``learnable=True`` plants a bright stripe in a class-specific row band
    for every positive label, which makes the task solvable.
    """

    disease_names = DISEASE_NAMES
    zero_decode = True

    def __init__(self, size: int = 512, image_size: int = 224, seed: int = 0,
                 learnable: bool = False):
        self.size = size
        self.image_size = image_size
        self.seed = seed
        self.learnable = learnable
        rng = np.random.default_rng(seed)
        # correlated multi-label targets with realistic (low) positive rates
        self.labels = (
            rng.random((size, NUM_CLASSES)) < rng.uniform(0.05, 0.3, NUM_CLASSES)
        ).astype(np.float32)
        # both classes appear for every disease, so AUC is defined
        half = max(1, size // 2)
        for c in range(NUM_CLASSES):
            if self.labels[:, c].sum() == 0:
                self.labels[c % half, c] = 1.0
            if self.labels[:, c].sum() == size:
                self.labels[(c + 1) % half, c] = 0.0
        self.class_weights = class_weights_from_labels(self.labels)
        # a small pool of distinct images, so a sample is a memcpy
        pool = size if learnable else min(size, 64)
        prng = np.random.default_rng((seed + 1) * 1_000_003)
        s = image_size
        base = prng.integers(0, 128, (pool, s // 8, s // 8, 3), np.uint8)
        self._images = np.repeat(np.repeat(base, 8, axis=1), 8, axis=2)
        if learnable:
            # class c → row band c of 14 (invariant to horizontal flips)
            band = max(s // NUM_CLASSES, 1)
            for i in range(pool):
                for c in np.nonzero(self.labels[i])[0]:
                    y0 = int(c) * band
                    self._images[i, y0:y0 + band] = np.minimum(
                        self._images[i, y0:y0 + band].astype(np.int32) + 127,
                        255,
                    ).astype(np.uint8)

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int):
        return self._images[idx % len(self._images)], self.labels[idx]

    def batch(self, indices) -> tuple[np.ndarray, np.ndarray]:
        """uint8 ``[B, S, S, 3]`` images and fp32 ``[B, 14]`` labels."""
        idx = np.asarray(indices)
        return self._images[idx % len(self._images)], self.labels[idx]
