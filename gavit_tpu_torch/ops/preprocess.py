"""Device-side image preprocessing (counterpart of
``gavit_tpu/ops/preprocess.py``): uint8 NHWC on the wire, normalised on the
device. Only the serving half is here; ``train_preprocess`` (flip, affine,
colour jitter) comes with training."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(x):
    """ImageNet normalisation on ``[B, H, W, 3]`` floats in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def to_float(images_u8):
    return images_u8.float() / 255.0


def val_preprocess(images_u8):
    """ToTensor + Normalize: uint8 ``[B, H, W, 3]`` → normalised fp32."""
    return normalize(to_float(images_u8))
