"""Grad-CAM and attention-map extraction for the ViT (counterpart of
``gavit_tpu/utils/gradcam.py``).

Where the JAX module differentiates a zero probe added to a block's output
with ``jax.grad``, this one adds the same probe through the model's
``token_probe`` hook and takes its gradient with ``torch.autograd.grad``.
On the card that backward runs through the kernels: A′ in every attention
after the probed block (fp32 for the fp32 model Grad-CAM is built in), the
graph kernel C's closed-form backward and the MLP's GEMM chain.

CAM recipe, as the JAX module's: per target class, weights = the mean over
patch tokens of ∂logit/∂tokens, CAM = ReLU(Σ_d w_d · token_d) over the
block's patch tokens, reshaped to the patch grid and min-max normalised;
the probabilities are the logits' sigmoid. The CAMs and the rollout are
computed on the tensors' device and returned as numpy arrays.

The drawing helpers (:func:`draw_bboxes`, :func:`overlay_cam`) import
matplotlib inside the call: the card's machine has none, and the callers
(``utils/visualization.py``, ``scripts/gradcam_torch.py``) skip the figure
there with a log line.
"""

from __future__ import annotations

import csv
import logging
import math

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _min_max(maps: torch.Tensor) -> torch.Tensor:
    """Each ``[B, h, w]`` map scaled to [0, 1] (a flat map to 0)."""
    lo = maps.amin(dim=(1, 2), keepdim=True)
    hi = maps.amax(dim=(1, 2), keepdim=True)
    return (maps - lo) / torch.clamp(hi - lo, min=1e-8)


def _grid(maps: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` patch values → ``[B, side, side]``."""
    side = math.isqrt(maps.shape[-1])
    return maps.reshape(-1, side, side)


class VisionTransformerGradCAM:
    """Grad-CAM over a transformer block's patch tokens.

    Args:
      model: a :class:`~gavit_tpu_torch.models.vit.VisionTransformer` in
        eval mode, on the images' device.
      block_index: which block's tokens to use (-1 = last, the block the
        reference hooks).
    """

    def __init__(self, model, block_index: int = -1):
        self.model = model
        self.block_index = block_index

    def _grad_tokens(self, images, class_idx: int):
        """(logits, the captured tokens, ∂ logits[:, class_idx].sum() /
        ∂ tokens at the block): a zero fp32 probe added to the block's
        output, whose gradient is the gradient with respect to those
        tokens."""
        cfg = self.model.cfg
        b, h, w, _ = images.shape
        n = (h // cfg.patch_size) * (w // cfg.patch_size) + 1
        probe = torch.zeros((b, n, cfg.embed_dim), dtype=torch.float32,
                            device=images.device, requires_grad=True)
        with torch.enable_grad():
            logits, toks = self.model(
                images, capture="tokens",
                token_probe=(self.block_index, probe))
            (grads,) = torch.autograd.grad(logits[:, class_idx].sum(), probe)
        return logits.detach(), [t.detach() for t in toks], grads

    def __call__(self, images, class_idx: int):
        """CAMs for normalised images ``[B, H, W, 3]`` → (``[B, gh, gw]``
        in [0, 1], the ``[B, num_classes]`` probabilities), numpy."""
        logits, toks, grads = self._grad_tokens(images, class_idx)
        tokens = toks[self.block_index].float()[:, 1:]  # drop CLS
        g = grads.float()[:, 1:]
        weights = g.mean(dim=1, keepdim=True)  # [B, 1, D]
        cam = torch.clamp((weights * tokens).sum(-1), min=0.0)  # [B, N]
        cam = _min_max(_grid(cam))
        return cam.cpu().numpy(), torch.sigmoid(logits).cpu().numpy()


@torch.no_grad()
def attention_rollout(model, images, head_fusion: str = "mean"):
    """Attention-rollout maps from the captured per-block attention: each
    block's heads fused (``'mean'`` or ``'max'``), the identity added for
    the residual, rows renormalised, and the blocks multiplied from the
    first; the CLS row over the patch tokens on the patch grid, min-max
    normalised. In float64, as the JAX module's numpy (its ``np.eye``
    widens the sum). → (maps ``[B, gh, gw]``, logits), numpy."""
    logits, attns = model(images, capture="attention")
    result = None
    for a in attns:  # each [B, H, N, N]
        a = a.double()
        fused = a.amax(dim=1) if head_fusion == "max" else a.mean(dim=1)
        n = fused.shape[-1]
        fused = fused + torch.eye(n, dtype=fused.dtype, device=fused.device)
        fused = fused / fused.sum(-1, keepdim=True)
        result = fused if result is None else torch.bmm(fused, result)
    maps = _min_max(_grid(result[:, 0, 1:]))
    return maps.cpu().numpy(), logits.cpu().numpy()


def load_bbox_annotations(csv_path: str, min_boxes: int = 1,
                          max_boxes: int | None = None) -> dict:
    """Parse an NIH BBox-list CSV into {image_name: {bboxes, labels}}.

    Rows carry an image name, a finding label and (x, y, w, h); images are
    kept by their box count. Column names are matched loosely (NIH ships
    ``Bbox [x`` etc.). Boxes are returned as (x0, y0, x1, y1) in
    source-image coordinates.
    """

    def find_col(header, *cands):
        for cand in cands:
            for i, name in enumerate(header):
                if cand.lower() in name.lower():
                    return i
        raise ValueError(f"none of {cands} found in CSV header {header}")

    records: dict = {}
    with open(csv_path) as f:
        reader = csv.reader(f)
        header = next(reader)
        i_img = find_col(header, "image index", "image")
        i_lab = find_col(header, "finding label", "label")
        i_x = find_col(header, "bbox_x", "bbox [x", "x")
        i_y = find_col(header, "bbox_y", "y")
        i_w = find_col(header, "bbox_w", "w")
        i_h = find_col(header, "bbox_h", "h")
        for row in reader:
            if not row or len(row) <= i_h:
                continue
            name = row[i_img]
            x, y = float(row[i_x]), float(row[i_y])
            w, h = float(row[i_w]), float(row[i_h])
            rec = records.setdefault(name, {"bboxes": [], "labels": []})
            rec["bboxes"].append((x, y, x + w, y + h))
            rec["labels"].append(row[i_lab])

    out = {}
    for name, rec in records.items():
        n = len(rec["bboxes"])
        if n < min_boxes:
            continue
        if max_boxes is not None and n > max_boxes:
            continue
        out[name] = rec
    return out


def draw_bboxes(ax, bboxes, labels, scale: float = 1.0,
                color: str = "lime"):
    """Draw ground-truth boxes (source coordinates × scale) on an axis."""
    import matplotlib.patches as patches

    for (x0, y0, x1, y1), label in zip(bboxes, labels):
        ax.add_patch(patches.Rectangle(
            (x0 * scale, y0 * scale), (x1 - x0) * scale, (y1 - y0) * scale,
            linewidth=1.5, edgecolor=color, facecolor="none",
        ))
        ax.text(x0 * scale, max(y0 * scale - 3, 0), label, fontsize=7,
                color=color)


def overlay_cam(image_u8: np.ndarray, cam: np.ndarray, alpha: float = 0.5):
    """Resize a CAM to the image and blend it in as a jet heatmap (host
    side; matplotlib's colour map)."""
    import matplotlib.cm as cm
    from PIL import Image

    h, w = image_u8.shape[:2]
    cam_img = Image.fromarray((cam * 255).astype(np.uint8)).resize(
        (w, h), Image.BILINEAR
    )
    heat = cm.jet(np.asarray(cam_img, np.float32) / 255.0)[..., :3]
    base = image_u8.astype(np.float32) / 255.0
    out = (1 - alpha) * base + alpha * heat
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)
