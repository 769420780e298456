"""gavit_tpu_torch — the PyTorch / CUDA port of gavit_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same layout and module names:

  models/    — ViT + graph message-passing blocks (nn.Module, deterministic)
  ops/       — the plain PyTorch versions and the wrappers of the hand-written
               Hopper kernels (fused attention, inference MLP, fused graph op)
  csrc/      — the CUDA C++ sources of those kernels, built on first use
  utils/     — the weight bridge from the JAX parameter tree
  serving.py — the Predictor (bucketed batches, device-resident weights)

It imports torch and nothing of jax or flax. It shares the JAX package's
config schema (``gavit_tpu.config``, which imports only yaml) and its label
order (``gavit_tpu.data.dataset.DISEASE_NAMES``); nothing else of
``gavit_tpu``.
"""

__version__ = "0.1.0"

from gavit_tpu.config import Config, load_config  # noqa: E402,F401
