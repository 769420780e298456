#!/usr/bin/env python
"""MAE pretraining of the PyTorch port (``gavit_tpu_torch``): the MAE init
the reference recipe starts from.

    python scripts/pretrain_mae_torch.py --config <yaml> [--synthetic] \\
        [--out vit-b_mae.pth] [--mask-ratio 0.75] \\
        [--decoder-dim 512 --decoder-depth 4 --decoder-heads 8] \\
        [--device cuda|cpu] [--set key=value ...]

Trains :class:`gavit_tpu_torch.models.mae.MAEViT` on unlabelled images: the
datasets of ``scripts/train_torch.py`` (synthetic with ``--synthetic`` or
without ``data.train_dir``, else the PNG or packed train split), labels
ignored. Each step uploads the uint8 batch, runs the train preprocess
(``data.augment_affine`` adds RandomAffine) and draws the masking noise,
both from a generator seeded by (``training.seed``, step), so a rerun gives
the same bits; then the masked-patch loss in ``training.precision``,
global-norm clipping at 1.0 and AdamW with ``training.weight_decay`` on
every parameter under the warmup-cosine schedule (scripts/pretrain_mae.py's
optax chain). Every ``training.save_freq`` epochs and after the last it
saves ``<paths.save_dir>/mae_epoch_{epoch}`` (``state.pt`` holding the
parameters and the step, ``meta.json``); at the end it writes the encoder
as a reference-layout ``.pth`` (``--out``, default
``<paths.save_dir>/mae_encoder.pth``) that ``--set
model.pretrained_path=...`` of ``scripts/train_torch.py`` loads.

It runs on ``cuda`` unless ``--device cpu`` is given; a config's ``mesh``
is read and not used: the port runs on one card.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

logger = logging.getLogger("pretrain_mae_torch")


class MAEPretrainer:
    """The MAE model (fp32 parameters from ``training.seed``, computing in
    ``training.precision``), its optimizer and schedule, and the step.
    ``impl='reference'`` runs every op through its plain version."""

    def __init__(self, config, device, steps_per_epoch: int, *,
                 decoder_dim: int = 512, decoder_depth: int = 4,
                 decoder_heads: int = 8, mask_ratio: float = 0.75,
                 impl: str = "auto"):
        from gavit_tpu_torch.models.mae import build_mae
        from gavit_tpu_torch.models.vit import init_params
        from gavit_tpu_torch.training.optimizer import make_mae_optimizer

        tr = config.training
        self.config = config
        self.device = torch.device(device)
        self.decoder = dict(decoder_dim=decoder_dim,
                            decoder_depth=decoder_depth,
                            decoder_heads=decoder_heads,
                            mask_ratio=mask_ratio)
        model = build_mae(config.model, precision=tr.precision, impl=impl,
                          **self.decoder)
        init_params(model, torch.Generator().manual_seed(tr.seed))
        self.model = model.to(self.device).train()
        if self.device.type == "cuda" and tr.precision == "fp32":
            # IEEE fp32 GEMMs, as the Trainer pins for an fp32 model
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.optimizer, self.schedule = make_mae_optimizer(
            config, self.model, steps_per_epoch)
        self.params = list(self.model.parameters())
        self.generator = torch.Generator(device=self.device)
        self.seed = tr.seed
        self.step = 0

    def draws(self, images_u8):
        """The step's preprocessed fp32 images and masking noise ``[B, N]``,
        from the generator seeded by (seed, 2·step) and (seed, 2·step + 1),
        as the JAX script folds the step into its key."""
        from gavit_tpu_torch.ops.philox import step_seed
        from gavit_tpu_torch.ops.preprocess import train_preprocess

        g = self.generator
        g.manual_seed(step_seed(self.seed, 2 * self.step))
        x = train_preprocess(images_u8, g,
                             self.config.data.augment_affine)
        g.manual_seed(step_seed(self.seed, 2 * self.step + 1))
        noise = torch.rand((x.shape[0], self.config.model.num_patches),
                           generator=g, device=self.device)
        return x, noise

    def train_step(self, images_u8) -> torch.Tensor:
        """One optimizer step on uint8 ``[B, S, S, 3]`` images; returns the
        loss as a device tensor (no host sync)."""
        from gavit_tpu_torch.models.mae import mae_loss

        x, noise = self.draws(images_u8.to(self.device, non_blocking=True))
        pred, mask = self.model(x, noise)
        loss = mae_loss(pred, x, mask, self.config.model.patch_size)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.update()
        return loss.detach()

    def update(self) -> None:
        """The update from the parameters' gradients: clipped to a global
        norm of 1.0, then AdamW at the schedule's lr of this step."""
        from gavit_tpu_torch.training.optimizer import (MAE_MAX_GRAD_NORM,
                                                        clip_by_global_norm)

        clip_by_global_norm(self.params, MAE_MAX_GRAD_NORM)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1

    def save(self, path: str, epoch: int, loss: float) -> None:
        """The parameters and the step under ``path`` (``state.pt``,
        ``meta.json``), as the JAX script's ``mae_epoch_{epoch}``."""
        from gavit_tpu_torch.utils import checkpoint as ckpt_lib

        ckpt_lib.save(path, {"params": self.model.state_dict(),
                             "step": self.step},
                      {"epoch": epoch, "loss": loss, **self.decoder,
                       "config": self.config.to_dict()})


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", default="",
                   help="encoder .pth output path (default: "
                        "<save_dir>/mae_encoder.pth)")
    p.add_argument("--mask-ratio", type=float, default=0.75)
    p.add_argument("--decoder-dim", type=int, default=512)
    p.add_argument("--decoder-depth", type=int, default=4)
    p.add_argument("--decoder-heads", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    import train_torch
    from gavit_tpu_torch.config import load_config, mesh_note
    from gavit_tpu_torch.data.loader import DataLoader
    from gavit_tpu_torch.models.mae import export_reference_pth

    config = load_config(args.config, args.overrides)
    note = mesh_note(config)
    if note:
        logger.info(note)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("pretrain_mae_torch: --device cuda needs a CUDA "
                         "device and this PyTorch sees none (use --device "
                         "cpu)")
    tr, d = config.training, config.data
    # the supervised datasets; labels ignored
    dataset, _ = train_torch.create_datasets(
        config, synthetic=args.synthetic or not d.train_dir)
    loader = DataLoader(dataset, d.batch_size, shuffle=True, drop_last=True,
                        num_workers=d.num_workers, seed=tr.seed,
                        pin_memory=device.type == "cuda")
    steps_per_epoch = max(1, len(loader))
    pretrainer = MAEPretrainer(
        config, device, steps_per_epoch, decoder_dim=args.decoder_dim,
        decoder_depth=args.decoder_depth, decoder_heads=args.decoder_heads,
        mask_ratio=args.mask_ratio)
    n_params = sum(p.numel() for p in pretrainer.params)
    logger.info(f"MAE params: {n_params:,} (mask ratio {args.mask_ratio}); "
                f"{tr.precision} on {device}, batch {d.batch_size}, "
                f"{tr.epochs} epochs of {len(loader)} steps")

    loss = float("nan")
    for epoch in range(tr.epochs):
        t0 = time.perf_counter()
        last = None
        for images, _labels in loader:  # labels ignored: unlabelled data
            last = pretrainer.train_step(torch.as_tensor(images))
        if last is not None:
            loss = last.item()  # waits for the epoch's last step
        dt = time.perf_counter() - t0
        logger.info(f"epoch {epoch}: loss {loss:.4f} "
                    f"({steps_per_epoch * d.batch_size / dt:.0f} img/s)")
        if (epoch + 1) % max(1, tr.save_freq) == 0 or epoch == tr.epochs - 1:
            pretrainer.save(os.path.join(config.paths.save_dir,
                                         f"mae_epoch_{epoch}"), epoch, loss)

    out = args.out or os.path.join(config.paths.save_dir, "mae_encoder.pth")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    export_reference_pth(pretrainer.model, out)
    logger.info(f"Wrote reference-layout MAE encoder: {out} — use it as "
                f"model.pretrained_path")
    return out


if __name__ == "__main__":
    main()
