"""Device-side image preprocessing (counterpart of
``gavit_tpu/ops/preprocess.py``): uint8 NHWC on the wire, augmented and
normalised on the device.

``train_preprocess`` is the transform the reference trains with: a
per-image horizontal flip with probability 0.5, then brightness and contrast
factors drawn from U(0.8, 1.2) with [0, 1] clamping (contrast blends toward
the mean of the grayscale image, as torchvision does), then ImageNet
normalisation. Its random draws come from an explicit ``torch.Generator``
on the images' device and are arguments of :func:`train_preprocess_with`,
so a test can hand both packages the same draws.

``use_affine=True`` (``data.augment_affine``) adds the RandomAffine of the
reference's transform stack between the flip and the jitter: a rotation
of U(±5°), a translation of U(±0.05) of the size on each axis and a scale
of U(0.95, 1.05) about the centre ``((h-1)/2, (w-1)/2)``, inverse-mapped
with a bilinear four-corner gather and zero fill outside the image, as
``jax.scipy.ndimage.map_coordinates(order=1, mode="constant")`` computes
it. Tensor ops, as in the JAX package (XLA there, no Pallas).
"""

from __future__ import annotations

import math

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# grayscale weights of torchvision's contrast adjustment
_GRAY = (0.299, 0.587, 0.114)
# brightness and contrast factors are drawn from U(1 - J, 1 + J)
_JITTER = 0.2
# RandomAffine: degrees, translate (a fraction of the size), scale range
_DEGREES = 5.0
_TRANSLATE = 0.05
_SCALE = (0.95, 1.05)


def _per_channel(values, like):
    """``values`` as a tensor of ``like``'s dtype and device, written by
    fill kernels: no copy from host memory, which a CUDA graph's capture
    refuses (``serving.py`` captures this preprocessing)."""
    return torch.stack([torch.full((), v, dtype=like.dtype,
                                   device=like.device) for v in values])


def normalize(x):
    """ImageNet normalisation on ``[B, H, W, 3]`` floats in [0, 1]."""
    return (x - _per_channel(IMAGENET_MEAN, x)) / _per_channel(IMAGENET_STD,
                                                              x)


def to_float(images_u8):
    return images_u8.float() / 255.0


def val_preprocess(images_u8):
    """ToTensor + Normalize: uint8 ``[B, H, W, 3]`` → normalised fp32."""
    return normalize(to_float(images_u8))


def _affine_one(img, angle, tx, ty, scale):
    """Inverse-mapped bilinear affine warp of ``[..., H, W, C]`` floats
    with zero fill: ``angle`` in radians, ``tx``/``ty`` in pixels and
    ``scale``, each a scalar or of the leading shape. Output pixel (y, x)
    reads the input at ``R(-angle)·(x - cx - tx, y - cy - ty) / scale +
    (cx, cy)``; each of its four corners outside the image adds 0, the
    others ``(1 - w)`` or ``w`` from ``floor`` on each axis, summed in
    ``map_coordinates``' order."""
    *lead, h, w, c = img.shape
    f32 = dict(dtype=torch.float32, device=img.device)

    def per_image(t):
        return torch.as_tensor(t, **f32).reshape(*lead, 1, 1)

    angle, tx, ty, scale = map(per_image, (angle, tx, ty, scale))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, **f32).reshape(h, 1)
    xx = torch.arange(w, **f32).reshape(1, w)
    x0 = xx - cx - tx
    y0 = yy - cy - ty
    # fp32 sin/cos differ in the last bit between libraries and devices;
    # rounded from fp64 they agree, and so do the coordinates
    cos = torch.cos(angle.double()).float()
    sin = torch.sin(angle.double()).float()
    xi = (cos * x0 + sin * y0) / scale + cx
    yi = (-sin * x0 + cos * y0) / scale + cy

    def nodes(coord, size):
        """(clamped index, in the image, weight) of both nodes."""
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.long()
        return ((index.clamp(0, size - 1), (index >= 0) & (index < size),
                 1 - upper_w),
                ((index + 1).clamp(0, size - 1),
                 (index >= -1) & (index < size - 1), upper_w))

    flat = img.reshape(*lead, h * w, c)
    out = None
    for iy, in_y, wy in nodes(yi, h):
        row = iy * w
        for ix, in_x, wx in nodes(xi, w):
            # a corner outside the image adds 0: its weight is zeroed,
            # which for finite images is map_coordinates' zero fill
            weight = (wy * wx * (in_y & in_x)).unsqueeze(-1)
            corner = torch.gather(
                flat, -2, (row + ix).reshape(*lead, h * w, 1).expand(
                    *lead, h * w, c)).reshape(img.shape)
            term = weight * corner
            out = term if out is None else out + term
    return out


def affine_draws(b: int, generator: torch.Generator, device,
                 degrees: float = _DEGREES, translate: float = _TRANSLATE,
                 scale_range=_SCALE):
    """RandomAffine's draws for ``b`` images: angle in radians ``[B]`` from
    U(±degrees), translate ``[B, 2]`` (x, y) from U(±translate) as a
    fraction of the size, scale ``[B]`` from U(scale_range)."""
    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                           device=device)

    angle = uniform((b,), -degrees, degrees) * (math.pi / 180.0)
    return (angle, uniform((b, 2), -translate, translate),
            uniform((b,), *scale_range))


def random_affine(x, generator: torch.Generator, degrees: float = _DEGREES,
                  translate: float = _TRANSLATE, scale_range=_SCALE):
    """Per-sample RandomAffine of ``[B, H, W, C]`` floats, its draws from
    ``generator``."""
    b, h, w, _ = x.shape
    angle, shift, scale = affine_draws(b, generator, x.device, degrees,
                                       translate, scale_range)
    return _affine_one(x, angle, shift[:, 0] * w, shift[:, 1] * h, scale)


def color_jitter(x, brightness, contrast):
    """Per-sample brightness then contrast factors ``[B]`` on ``[B, H, W,
    3]`` floats in [0, 1], each followed by [0, 1] clamping (contrast
    blends toward the mean of the grayscale image)."""
    b = x.shape[0]
    x = torch.clamp(x * brightness.reshape(b, 1, 1, 1), 0.0, 1.0)
    gray = torch.tensor(_GRAY, dtype=x.dtype, device=x.device)
    mean = (x * gray).sum(dim=(1, 2, 3)) / (x.shape[1] * x.shape[2])
    cf = contrast.reshape(b, 1, 1, 1)
    return torch.clamp(cf * x + (1.0 - cf) * mean.reshape(b, 1, 1, 1),
                       0.0, 1.0)


def train_preprocess_with(images_u8, flip, brightness, contrast,
                          angle=None, translate=None, scale=None):
    """The train transform with its draws given: ``flip`` bool ``[B]``,
    ``brightness`` and ``contrast`` fp32 ``[B]``, and with ``angle``
    (radians) ``[B]``, ``translate`` ``[B, 2]`` (a fraction of the width
    and the height) and ``scale`` ``[B]`` the affine warp after the flip."""
    b, h, w = images_u8.shape[:3]
    x = to_float(images_u8)
    x = torch.where(flip.reshape(b, 1, 1, 1), x.flip(2), x)
    if angle is not None:
        x = _affine_one(x, angle, translate[:, 0] * w, translate[:, 1] * h,
                        scale)
    return normalize(color_jitter(x, brightness, contrast))


def train_preprocess(images_u8, generator: torch.Generator,
                     use_affine: bool = False):
    """uint8 ``[B, H, W, 3]`` → augmented, normalised fp32, with every draw
    from ``generator`` (on the images' device): the flip, the jitter's
    factors, then the affine's only with ``use_affine``, so the draws of
    a run without it are unchanged."""
    b, dev = images_u8.shape[0], images_u8.device

    def factors():
        return 1.0 - _JITTER + 2.0 * _JITTER * torch.rand(
            b, generator=generator, device=dev)

    flip = torch.rand(b, generator=generator, device=dev) < 0.5
    brightness = factors()
    contrast = factors()
    affine = affine_draws(b, generator, dev) if use_affine else ()
    return train_preprocess_with(images_u8, flip, brightness, contrast,
                                 *affine)
