"""Transform factories in the shape of the reference's
``ChestXrayTransforms`` (counterpart of ``gavit_tpu/data/transforms.py``).

Each factory returns a batch function over uint8 ``[B, S, S, 3]`` tensors
that runs on the tensors' device (``gavit_tpu_torch/ops/preprocess.py``):
the dataset resizes at load time, these flip, warp, jitter and normalise.
"""

from __future__ import annotations

from gavit_tpu_torch.ops.preprocess import train_preprocess, val_preprocess


class ChestXrayTransforms:
    """Train: flip + RandomAffine + colour jitter + normalise; the simple
    train transform (the one the reference's training script uses) leaves
    the affine out; val: normalise only."""

    @staticmethod
    def get_train_transforms(config=None):
        """``fn(images_u8, generator)`` → normalised fp32, with the
        affine."""
        del config
        return lambda images_u8, generator: train_preprocess(
            images_u8, generator, use_affine=True)

    @staticmethod
    def get_train_transforms_simple(config=None):
        del config
        return lambda images_u8, generator: train_preprocess(
            images_u8, generator, use_affine=False)

    @staticmethod
    def get_val_transforms(config=None):
        del config
        return val_preprocess
