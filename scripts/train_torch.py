#!/usr/bin/env python
"""Train the PyTorch port (``gavit_tpu_torch``).

    python scripts/train_torch.py --config configs/vit_b16_graph2.yaml \\
        [--synthetic] [--resume PATH|auto] [--device cuda|cpu] \\
        [--profile DIR] [--set key=value ...]
    python scripts/train_torch.py ... --steps N

The data: the synthetic sets with ``--synthetic`` (or ``data.synthetic``),
else the NIH ChestX-ray14 splits of ``data.train_dir`` /
``data.train_labels`` and ``data.val_dir`` / ``data.val_labels``: a
directory packed by ``scripts/prepare_dataset_torch.py`` (or
``scripts/prepare_dataset.py``) opens as the packed memmap, any other as
PNG files decoded on ``data.num_workers`` threads. ``data.loader: grain``
takes ``data/checkpointable.py``'s loader, GrainLoader's counterpart,
otherwise the threaded one: the same loader, whose position a SIGTERM
save keeps, so the resume trains the next unseen batch;
``data.augment_affine`` adds RandomAffine to the train
transform.

Builds the model (fp32 parameters from ``training.seed``, computing in
``training.precision``; ``model.pretrained_path`` loaded over them where
that file exists, as a reference-layout or MAE checkpoint), the
DynamicWeightedLoss, the two-group AdamW and its warmup-cosine schedule.
``--set training.qat=true`` trains quantisation-aware: every GEMM the
int8 serving path quantises is fake-quantised against activation scales
calibrated on the first 8 train images, which the checkpoints carry, so
``scripts/serve_torch.py --checkpoint ... --precision int8`` serves the
run under them.

Without ``--steps`` it runs the epoch loop of
``gavit_tpu_torch/training/trainer.py``: ``training.epochs`` epochs of the
train set in a seeded order (full batches of ``data.batch_size``, each
one optimizer step over ``training.grad_accum_steps`` micro-batches),
validation every ``eval_freq`` epochs on the val set, the metric battery,
best-AUC checkpoints under ``paths.save_dir`` (``save_freq`` ones when no
validation ran), early stopping, and on SIGTERM a mid-epoch checkpoint and
a clean exit. ``--resume auto`` continues from the latest checkpoint in
``paths.save_dir``. Metrics go to the wandb sink (a JSONL file under
``paths.log_dir`` without wandb). At the end it draws the JAX script's
figures into ``<save_dir>/figures/``: ``loss_curve.png``,
``auc_curves.png`` and ``training_progress/`` (each skipped with a log
line where matplotlib is missing, as on the card's machine).
``training.precision: fp32`` trains in fp32 with TF32 off.

The epoch loop logs to ``paths.log_dir`` too (a timestamped file beside
the console) and starts with the device inventory; ``--profile DIR``
profiles its first epoch with ``torch.profiler`` into ``DIR/trace.json``
(that epoch is neither validated nor saved, as in ``scripts/train.py``).

With ``--steps N`` it takes N steps on batches of ``data.batch_size``
uint8 images and prints the loss, the λ weights and images/s of each.

It runs on ``cuda`` unless ``--device cpu`` is given; on the card the
Hopper kernels build on first use. A MoE config
(``configs/examples/vit_b16_moe.yaml``) trains with its auxiliary loss in
the objective (``GAVIT_MOE_FUSED=0`` in the environment switches its
grouped engine from the fused kernels to the unfused one); a config's
``mesh`` is read and not used: the port runs on one card.
"""

from __future__ import annotations

import argparse
import logging
import os
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


def create_val_dataset(config):
    """The synthetic val set scripts/train.py builds beside the train set."""
    from gavit_tpu_torch.data.dataset import SyntheticChestXrayDataset

    d = config.data
    return SyntheticChestXrayDataset(
        size=max(d.batch_size, d.synthetic_size // 8),
        image_size=d.image_size, seed=config.training.seed + 1,
        learnable=d.synthetic_learnable)


def open_split(config, directory: str, labels: str):
    """A file split: a packed directory as the memmap, any other as PNG
    files with their label file."""
    from gavit_tpu_torch.data.dataset import (ChestXrayDataset,
                                              PackedChestXrayDataset)

    if PackedChestXrayDataset.is_packed(directory):
        return PackedChestXrayDataset(directory)
    return ChestXrayDataset(directory, labels,
                            image_size=config.data.image_size)


def create_datasets(config, synthetic: bool):
    """(train, val): the synthetic sets, or the config's file splits."""
    d = config.data
    if synthetic or d.synthetic:
        return create_dataset(config), create_val_dataset(config)
    return (open_split(config, d.train_dir, d.train_labels),
            open_split(config, d.val_dir, d.val_labels))


def load_pretrained(config, model) -> None:
    """``model.pretrained_path`` over the fresh weights where the file
    exists (an absent file is ignored, as scripts/train.py does)."""
    from gavit_tpu_torch.utils.torch_convert import load_mae_weights

    path = config.model.pretrained_path
    if not path or not os.path.exists(path):
        return
    try:
        load_mae_weights(model, path)
    except Exception as e:  # noqa: BLE001 - named and re-raised as an exit
        raise SystemExit(f"train_torch: cannot load model.pretrained_path "
                         f"{path!r}: {type(e).__name__}: {e}") from e


def build_trainer(config, dataset, device, *, impl: str = "auto",
                  gate: float | None = None, train_loader=None,
                  val_loader=None, wandb_run=None):
    """The model (weights from ``training.seed``, then
    ``model.pretrained_path`` where it exists; graph gates set to ``gate``
    when given) and its Trainer. ``impl='reference'`` runs every op through
    its plain PyTorch version."""
    from gavit_tpu_torch.models.vit import build_model, init_params
    from gavit_tpu_torch.training.trainer import Trainer

    model = build_model(config.model, precision=config.training.precision,
                        impl=impl)
    init_params(model, torch.Generator().manual_seed(config.training.seed))
    load_pretrained(config, model)
    if gate is not None:
        with torch.no_grad():
            for gb in model.graphs:
                gb.gate.fill_(gate)
    steps_per_epoch = max(1, len(dataset) // config.data.batch_size)
    return Trainer(config, model, dataset.class_weights, steps_per_epoch,
                   device=device, train_loader=train_loader,
                   val_loader=val_loader, wandb_run=wandb_run,
                   dataset=dataset)


def batches(dataset, batch_size: int, seed: int):
    """Endless uint8 batches, a fresh permutation of the dataset per epoch
    (the last partial batch of an epoch is dropped)."""
    from gavit_tpu_torch.data.loader import read_batch

    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(len(dataset))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            yield read_batch(dataset, order[start:start + batch_size])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="configs/vit_b16_graph2.yaml")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic dataset instead of the "
                        "config's data.train_dir / data.val_dir")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory to resume from ('auto': the "
                        "latest in paths.save_dir)")
    p.add_argument("--steps", type=int, default=None,
                   help="take this many steps instead of the epoch loop")
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="profile the first epoch with torch.profiler into "
                        "DIR/trace.json")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE", help="config override, repeatable")
    return p.parse_args(argv)


def run_steps(trainer, dataset, config, steps: int) -> None:
    bs = config.data.batch_size
    data = batches(dataset, bs, config.training.seed)
    for _ in range(steps):
        images, labels = next(data)
        t0 = time.perf_counter()
        m = trainer.train_step(torch.from_numpy(images),
                               torch.from_numpy(labels))
        loss = m["loss"].item()  # waits for the step
        dt = time.perf_counter() - t0
        w = [round(v, 4) for v in m["loss_weights"].tolist()]
        aux = f" moe_aux {m['moe_aux'].item():.4f}" if "moe_aux" in m else ""
        norm = (f" grad norm {m['grad_norm'].item():.4f}"
                if config.training.log_grad_norm else "")
        logger.info(f"step {trainer.step}: loss {loss:.4f} (wbce "
                    f"{m['wbce'].item():.4f} focal {m['focal'].item():.4f} "
                    f"asl {m['asl'].item():.4f}{aux}) loss weights {w} lr "
                    f"{m['lr']:.3e}{norm} {bs / dt:.1f} img/s")


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    from gavit_tpu_torch.config import load_config, mesh_note, unused_note

    config = load_config(args.config, args.overrides)
    for note in (mesh_note(config), unused_note(config)):
        if note:
            logger.info(note)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_torch: --device cuda needs a CUDA device and "
                         "this PyTorch sees none (use --device cpu)")
    d = config.data
    bs = d.batch_size
    tr = config.training
    what = (f"training {config.model.name} ({tr.precision}) on {device}, "
            f"batch {bs}" + (f" as {tr.grad_accum_steps} micro-batches"
                             if tr.grad_accum_steps > 1 else ""))
    if args.steps is not None:
        dataset = (create_dataset(config) if args.synthetic or d.synthetic
                   else open_split(config, d.train_dir, d.train_labels))
        trainer = build_trainer(config, dataset, device)
        logger.info(f"{what}, {args.steps} steps")
        run_steps(trainer, dataset, config, args.steps)
        return trainer

    from gavit_tpu_torch.data.checkpointable import CheckpointableLoader
    from gavit_tpu_torch.data.loader import DataLoader
    from gavit_tpu_torch.utils import checkpoint as ckpt_lib
    from gavit_tpu_torch.utils import wandb_compat
    from gavit_tpu_torch.utils.custom_logging import (log_dataset_info,
                                                      log_system_info,
                                                      setup_logging)

    for path in (config.paths.save_dir, config.paths.log_dir):
        Path(path).mkdir(parents=True, exist_ok=True)
    setup_logging(config)
    log_system_info()
    run = wandb_compat.init(config, log_dir=config.paths.log_dir)
    try:
        dataset, val_ds = create_datasets(config, args.synthetic)
        log_dataset_info(dataset, val_ds)
        # "grain": GrainLoader's counterpart, which is the threaded loader
        loader = CheckpointableLoader if d.loader == "grain" else DataLoader
        # batches pinned on the loaders' lookahead threads for a card
        kw = dict(num_workers=d.num_workers, pin_memory=device.type == "cuda")
        train_loader = loader(dataset, bs, shuffle=True, drop_last=True,
                              seed=tr.seed, **kw)
        val_loader = loader(val_ds, bs, **kw)
        trainer = build_trainer(config, dataset, device,
                                train_loader=train_loader,
                                val_loader=val_loader, wandb_run=run)
        logger.info(f"{what}, {tr.epochs} epochs of {len(train_loader)} "
                    f"steps; {len(dataset)} train and {len(val_ds)} val "
                    f"images")
        resume = args.resume
        if resume == "auto":
            resume = ckpt_lib.latest_checkpoint(config.paths.save_dir)
        if resume:
            if os.path.isdir(resume):
                trainer.restore_checkpoint(resume)
            else:
                logger.error(f"No checkpoint found at {resume}")
        if args.profile:
            from gavit_tpu_torch.utils.profiling import trace

            logger.info(f"Profiling the first epoch into {args.profile}")
            with trace(args.profile):
                first = trainer.train_epoch()
            trainer.train_metrics_history.append(first)
            trainer.current_epoch += 1
            trainer.start_epoch = trainer.current_epoch
        final = trainer.train()
        logger.info("Training completed. Final metrics:")
        for name, value in final.items():
            logger.info(f"{name}: {value:.4f}")
        # the JAX script's figures (scripts/train.py:226-240): the loss and
        # AUC curves, and the training-progress plots and panel under
        # figures/training_progress/
        figures = os.path.join(config.paths.save_dir, "figures")
        trainer.metric_calculator.plot_metrics(
            trainer.train_metrics_history, figures)
        if trainer.train_metrics_history and trainer.val_metrics_history:
            from gavit_tpu_torch.utils.visualization import \
                VisualizationManager

            VisualizationManager(
                figures, dataset.disease_names).plot_training_progress(
                trainer.train_metrics_history, trainer.val_metrics_history)
    finally:
        run.finish()
    return trainer


if __name__ == "__main__":
    main()
