"""NIH ChestX-ray14 labels and the synthetic dataset (the port's copy of the
parts of ``gavit_tpu/data/dataset.py`` that the serving and training paths
need: ``DISEASE_NAMES``, ``class_weights_from_labels`` and
``SyntheticChestXrayDataset``).

Samples are uint8 HWC images at the training resolution and fp32 label
vectors; every float step (normalise, augment) runs on the device
(``gavit_tpu_torch/ops/preprocess.py``).
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

DISEASE_NAMES = [
    "Atelectasis", "Cardiomegaly", "Effusion", "Infiltration",
    "Mass", "Nodule", "Pneumonia", "Pneumothorax", "Consolidation",
    "Edema", "Emphysema", "Fibrosis", "Pleural_Thickening", "Hernia",
]

NUM_CLASSES = len(DISEASE_NAMES)


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


class SyntheticChestXrayDataset:
    """Deterministic synthetic stand-in with the real dataset's sample
    contract; images and labels are a pure function of (seed, index), the
    same as the JAX package's for the same arguments.

    ``learnable=True`` plants a bright stripe in a class-specific row band
    for every positive label, which makes the task solvable.
    """

    disease_names = DISEASE_NAMES

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
