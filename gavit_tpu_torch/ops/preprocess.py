"""Device-side image preprocessing (counterpart of
``gavit_tpu/ops/preprocess.py``): uint8 NHWC on the wire, augmented and
normalised on the device.

``train_preprocess`` is the transform the reference trains with: a
per-image horizontal flip with probability 0.5, then brightness and contrast
factors drawn from U(0.8, 1.2) with [0, 1] clamping (contrast blends toward
the mean of the grayscale image, as torchvision does), then ImageNet
normalisation. Its random draws come from an explicit ``torch.Generator``
on the images' device and are arguments of :func:`train_preprocess_with`,
so a test can hand both packages the same draws. RandomAffine
(``use_affine=True``) is not ported yet.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# grayscale weights of torchvision's contrast adjustment
_GRAY = (0.299, 0.587, 0.114)
# brightness and contrast factors are drawn from U(1 - J, 1 + J)
_JITTER = 0.2


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


def train_preprocess_with(images_u8, flip, brightness, contrast):
    """The train transform with its draws given: ``flip`` bool ``[B]``,
    ``brightness`` and ``contrast`` fp32 ``[B]``; brightness then contrast,
    each followed by [0, 1] clamping."""
    b = images_u8.shape[0]
    x = to_float(images_u8)
    x = torch.where(flip.reshape(b, 1, 1, 1), x.flip(2), x)
    x = torch.clamp(x * brightness.reshape(b, 1, 1, 1), 0.0, 1.0)
    gray = torch.tensor(_GRAY, dtype=x.dtype, device=x.device)
    mean = (x * gray).sum(dim=(1, 2, 3)) / (x.shape[1] * x.shape[2])
    cf = contrast.reshape(b, 1, 1, 1)
    x = torch.clamp(cf * x + (1.0 - cf) * mean.reshape(b, 1, 1, 1), 0.0, 1.0)
    return normalize(x)


def train_preprocess(images_u8, generator: torch.Generator,
                     use_affine: bool = False):
    """uint8 ``[B, H, W, 3]`` → augmented, normalised fp32, with every draw
    from ``generator`` (on the images' device)."""
    if use_affine:
        raise NotImplementedError(
            "RandomAffine in train_preprocess (data.augment_affine) waits for "
            "ROADMAP Queue 1 item 3")
    b, dev = images_u8.shape[0], images_u8.device

    def factors():
        return 1.0 - _JITTER + 2.0 * _JITTER * torch.rand(
            b, generator=generator, device=dev)

    flip = torch.rand(b, generator=generator, device=dev) < 0.5
    brightness = factors()
    return train_preprocess_with(images_u8, flip, brightness, factors())
