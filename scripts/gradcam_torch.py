#!/usr/bin/env python
"""Grad-CAM and attention maps of a port checkpoint (counterpart of
``scripts/gradcam.py``, with its flags).

    python scripts/gradcam_torch.py --config <yaml> \\
        --checkpoint <save_dir>/best_model [--dataset nih|synthetic] \\
        [--num-images 8] [--out <dir>] [--bbox-csv <csv>] \\
        [--bbox-source-size 1024] [--device cuda|cpu] [--set key=value ...]

Loads the model from a ``scripts/train_torch.py`` checkpoint in fp32 at
dropout 0, as the JAX script's ``load_model`` builds it (fresh weights
from seed 0 without a checkpoint); on the card the fp32 forward and the
Grad-CAM backward run through the Hopper kernels (A and A′ in fp32, C,
the MLP's GEMM chain), with TF32 off. It picks ``--num-images`` images
(``nih``: ``data.val_dir`` with ``data.val_labels``; ``synthetic``) with a
seed of 0 and writes under ``--out`` (default ``<save_dir>/gradcam``):
the attention rollout (``attention_maps/attention_maps.png``), the first
image's per-block attention (``attention_maps/attention_map_blocks_{i}
.pdf``), a Grad-CAM figure for every disease predicted above 0.5 in the
batch (``attention_maps/gradcam_{disease}.png``), the prediction grid
(``predictions.png``), and with ``--bbox-csv`` (NIH's BBox list) a
per-image analysis figure (``analysis_{image}.png``: the ground-truth
boxes, the probability-weighted CAM of the predicted diseases and each
disease's CAM) for up to ``--num-images`` images with 2-3 boxes.

Every map is computed first; where matplotlib is missing (the card's
machine) each figure is skipped with a log line naming it.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

# the repository (the port) and this directory (evaluate_torch's loader)
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

logger = logging.getLogger("gradcam_torch")


def analysis_figure(image_u8, cams_by_disease, probs_row, disease_names,
                    bboxes, labels, bbox_scale, save_path) -> None:
    """One image: the image with its ground-truth boxes, the CAMs of the
    predicted diseases weighted by their probabilities, and each disease's
    CAM, in a row."""
    from gavit_tpu_torch.utils.gradcam import draw_bboxes, overlay_cam
    from gavit_tpu_torch.utils.visualization import pyplot

    plt = pyplot(str(save_path))
    if plt is None:
        return
    predicted = [(c, probs_row[c]) for c in cams_by_disease]
    n_panels = 2 + len(predicted)
    fig, axes = plt.subplots(1, n_panels, figsize=(3.2 * n_panels, 3.6))
    axes = list(axes) if n_panels > 1 else [axes]

    axes[0].imshow(image_u8)
    draw_bboxes(axes[0], bboxes, labels, scale=bbox_scale)
    axes[0].set_title("ground truth")
    axes[0].axis("off")

    if predicted:
        total_p = sum(p for _, p in predicted)
        combined = sum(
            p * cams_by_disease[c] for c, p in predicted
        ) / max(total_p, 1e-8)
        axes[1].imshow(overlay_cam(image_u8, combined))
        draw_bboxes(axes[1], bboxes, labels, scale=bbox_scale, color="white")
    else:
        axes[1].imshow(image_u8)
    axes[1].set_title("combined CAM (prob-weighted)")
    axes[1].axis("off")

    for ax, (c, p) in zip(axes[2:], predicted):
        ax.imshow(overlay_cam(image_u8, cams_by_disease[c]))
        ax.set_title(f"{disease_names[c]} (p={p:.2f})")
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(save_path, dpi=200, bbox_inches="tight")
    plt.close()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default="")
    p.add_argument("--dataset", choices=["nih", "synthetic"],
                   default="synthetic")
    p.add_argument("--num-images", type=int, default=8)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--bbox-csv", type=str, default="",
                   help="NIH BBox-list CSV: draw ground-truth boxes and "
                        "per-disease CAM analysis figures")
    p.add_argument("--bbox-source-size", type=int, default=1024,
                   help="resolution the bbox coordinates refer to")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE",
                   help="Override a config value (dotted keys, YAML-parsed "
                        "values)")
    return p.parse_args(argv)


def main(argv=None) -> Path:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    from evaluate_torch import load_model

    from gavit_tpu_torch.config import load_config
    from gavit_tpu_torch.data.dataset import (ChestXrayDataset,
                                              SyntheticChestXrayDataset)
    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.utils.gradcam import (VisionTransformerGradCAM,
                                               load_bbox_annotations)
    from gavit_tpu_torch.utils.visualization import VisualizationManager

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("gradcam_torch: --device cuda needs a CUDA "
                             "device and this PyTorch sees none (use "
                             "--device cpu)")
        # the fp32 model in IEEE fp32: no TF32 in its GEMMs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    config = load_config(args.config, args.overrides)
    out_dir = Path(args.out or os.path.join(config.paths.save_dir, "gradcam"))
    model = load_model(args.checkpoint, config, device, precision="fp32")

    d = config.data
    if args.dataset == "nih":
        ds = ChestXrayDataset(d.val_dir, d.val_labels, image_size=d.image_size)
    else:
        ds = SyntheticChestXrayDataset(size=max(args.num_images, 8),
                                       image_size=d.image_size)

    rng = np.random.default_rng(0)
    annotations = {}
    idx = np.zeros(0, int)
    if args.bbox_csv:
        annotations = load_bbox_annotations(args.bbox_csv, min_boxes=2,
                                            max_boxes=3)
        name_to_idx = {str(p): i for i, p in enumerate(ds.image_paths)}
        annotated = [n for n in annotations if n in name_to_idx]
        rng.shuffle(annotated)
        idx = np.asarray(
            [name_to_idx[n] for n in annotated[: args.num_images]], int)
        if len(idx) == 0:
            logger.warning("no annotated images found in the dataset")
    if len(idx) == 0:
        idx = rng.choice(len(ds), size=min(args.num_images, len(ds)),
                         replace=False)
    images_u8 = np.stack([ds[i][0] for i in idx])
    targets = np.stack([ds[i][1] for i in idx])
    images = val_preprocess(torch.from_numpy(images_u8).to(device))

    viz = VisualizationManager(out_dir, ds.disease_names)
    viz.plot_attention_maps(model, images, images_u8)
    # the first image's per-block maps; the rollout above is the aggregate
    viz.plot_per_layer_attention(model, images[:1])
    logger.info("Attention maps (rollout and per block) done")

    # Grad-CAM per disease predicted above 0.5 anywhere in the batch
    with torch.no_grad():
        probs = torch.sigmoid(model(images)).cpu().numpy()
    for c in range(len(ds.disease_names)):
        if (probs[:, c] > 0.5).any():
            viz.plot_gradcam(model, images, images_u8, c,
                             filename=f"gradcam_{ds.disease_names[c]}.png")
            logger.info(f"Grad-CAM for {ds.disease_names[c]} done")

    viz.plot_prediction_grid(images_u8, targets, probs)

    if annotations:
        gc = VisionTransformerGradCAM(model)
        scale = d.image_size / args.bbox_source_size
        for j, i in enumerate(idx):
            name = str(ds.image_paths[i])
            if name not in annotations:
                continue
            cams = {c: gc(images[j:j + 1], c)[0][0]
                    for c in range(len(ds.disease_names))
                    if probs[j, c] > 0.5}
            ann = annotations[name]
            analysis_figure(
                images_u8[j], cams, probs[j], ds.disease_names,
                ann["bboxes"], ann["labels"], scale,
                out_dir / f"analysis_{os.path.splitext(name)[0]}.png")
            logger.info(f"Analysis of {name} done")

    logger.info(f"Artifacts in {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
