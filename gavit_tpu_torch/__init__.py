"""gavit_tpu_torch — the PyTorch / CUDA port of gavit_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same layout and module names:

  config.py  — the typed YAML config (the port's own copy of the schema)
  data/      — the label list and the synthetic dataset
  models/    — ViT + graph message-passing blocks + MoE MLPs (nn.Module;
               ``eval()`` is the deterministic forward, ``train()`` the
               dropout one), and the MAE that pretrains the ViT's trunk
  ops/       — the plain PyTorch versions and the wrappers of the hand-written
               Hopper kernels (attention forward and backward, inference and
               training MLP, dropout, GELU + dropout, fused graph op, the
               MoE expert MLP and its grouped dW GEMM), and int8
               quantisation (``ops/quant.py``)
  csrc/      — the CUDA C++ sources of those kernels, built on first use
  training/  — the loss, schedule, optimizer and the train step
  utils/     — the weight bridge to and from the JAX parameter tree and
               the reference layout, checkpoints, metrics, figures,
               Grad-CAM, logging and profiling
  serving.py — the Predictor (bucketed batches, device-resident weights,
               int8 static PTQ, token merging, the port's checkpoints) and
               the MicroBatcher

It imports torch and nothing of jax, flax or gavit_tpu.
"""

__version__ = "0.2.0"

from gavit_tpu_torch.config import Config, load_config  # noqa: E402,F401
