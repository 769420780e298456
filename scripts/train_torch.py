#!/usr/bin/env python
"""Train the PyTorch port (``gavit_tpu_torch``) on the synthetic dataset.

    python scripts/train_torch.py --config configs/vit_b16_graph2.yaml \\
        --synthetic --steps 5 [--device cuda|cpu] [--set key=value ...]

Builds the model (fp32 parameters from ``training.seed``, computing in
``training.precision``), the DynamicWeightedLoss, the two-group AdamW and
its warmup-cosine schedule, then takes ``--steps`` steps on batches of
``data.batch_size`` uint8 images from ``SyntheticChestXrayDataset``, each
step preprocessed, run forward and backward and applied on the device
(``gavit_tpu_torch/training/trainer.py``). It prints the loss, the λ
weights and images/s of every step.

It runs on ``cuda`` unless ``--device cpu`` is given; on the card the
Hopper kernels build on first use. A MoE config
(``configs/examples/vit_b16_moe.yaml``) trains with its auxiliary loss in
the objective; a config's ``mesh`` is read and not used: the port runs on
one card. Checkpointing, validation, early
stopping, preemption and gradient accumulation wait for ROADMAP Queue 1
item 6; only the synthetic data path exists so far.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

logger = logging.getLogger("train_torch")


def create_dataset(config):
    from gavit_tpu_torch.data.dataset import SyntheticChestXrayDataset

    d = config.data
    return SyntheticChestXrayDataset(
        size=d.synthetic_size, image_size=d.image_size,
        seed=config.training.seed, learnable=d.synthetic_learnable)


def build_trainer(config, dataset, device, *, impl: str = "auto",
                  gate: float | None = None):
    """The model (weights from ``training.seed``; graph gates set to
    ``gate`` when given) and its Trainer. ``impl='reference'`` runs every
    op through its plain PyTorch version."""
    from gavit_tpu_torch.models.vit import build_model, init_params
    from gavit_tpu_torch.training.trainer import Trainer

    model = build_model(config.model, precision=config.training.precision,
                        impl=impl)
    init_params(model, torch.Generator().manual_seed(config.training.seed))
    if gate is not None:
        with torch.no_grad():
            for gb in model.graphs:
                gb.gate.fill_(gate)
    steps_per_epoch = max(1, len(dataset) // config.data.batch_size)
    return Trainer(config, model, dataset.class_weights, steps_per_epoch,
                   device=device)


def batches(dataset, batch_size: int, seed: int):
    """Endless uint8 batches, a fresh permutation of the dataset per epoch
    (the last partial batch of an epoch is dropped)."""
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(len(dataset))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            yield dataset.batch(order[start:start + batch_size])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="configs/vit_b16_graph2.yaml")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic dataset (the only data path "
                        "ported so far)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE", help="config override, repeatable")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    from gavit_tpu_torch.config import load_config, mesh_note

    config = load_config(args.config, args.overrides)
    note = mesh_note(config)
    if note:
        logger.info(note)
    if not (args.synthetic or config.data.synthetic):
        raise SystemExit("train_torch: only --synthetic data is ported so far "
                         "(the image-folder loader waits for ROADMAP Queue 1 "
                         "item 9)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_torch: --device cuda needs a CUDA device and "
                         "this PyTorch sees none (use --device cpu)")
    dataset = create_dataset(config)
    trainer = build_trainer(config, dataset, device)
    bs = config.data.batch_size
    logger.info(f"training {config.model.name} ({config.training.precision}) "
                f"on {device}, batch {bs}, {args.steps} steps")
    data = batches(dataset, bs, config.training.seed)
    for _ in range(args.steps):
        images, labels = next(data)
        t0 = time.perf_counter()
        m = trainer.train_step(torch.from_numpy(images),
                               torch.from_numpy(labels))
        loss = m["loss"].item()  # waits for the step
        dt = time.perf_counter() - t0
        w = [round(v, 4) for v in m["loss_weights"].tolist()]
        aux = f" moe_aux {m['moe_aux'].item():.4f}" if "moe_aux" in m else ""
        logger.info(f"step {trainer.step}: loss {loss:.4f} (wbce "
                    f"{m['wbce'].item():.4f} focal {m['focal'].item():.4f} "
                    f"asl {m['asl'].item():.4f}{aux}) loss weights {w} lr "
                    f"{m['lr']:.3e} {bs / dt:.1f} img/s")
    return trainer


if __name__ == "__main__":
    main()
