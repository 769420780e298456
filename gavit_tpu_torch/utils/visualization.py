"""Visualization manager (counterpart of
``gavit_tpu/utils/visualization.py``): ROC and PR curves, per-disease
confusion-matrix grids, attention maps, Grad-CAM overlays, training
progress, the learning-rate schedule, error analysis, CSV/LaTeX
performance tables and prediction grids, with the JAX manager's file
names, subdirectories, titles and dpi.

The model-taking methods take the port's ``nn.Module`` in place of JAX's
``(model, params)`` and the normalised images as a tensor on its device;
their maps come from ``utils/gradcam.py`` and are computed there (through
the kernels on the card) before anything is drawn. The curves are the numpy ones of ``utils/metrics.py``
(the card's machine has no scikit-learn), and the confusion-matrix grid
is drawn with matplotlib alone (no seaborn there either).

matplotlib is imported inside each drawing call (:func:`pyplot`). Where it
is missing, as on the card's machine, the call logs one line naming the
figure it skipped and returns None (a list method an empty list); the
maps are computed all the same. The tables need no matplotlib.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from gavit_tpu_torch.utils.metrics import (average_precision,
                                           precision_recall_curve, roc_auc,
                                           roc_curve)

logger = logging.getLogger(__name__)


def pyplot(figure: str):
    """matplotlib's pyplot on the Agg backend, or None after one log line
    saying that ``figure`` is skipped, where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        logger.info(f"figure skipped: {figure} (matplotlib is not "
                    "installed)")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class VisualizationManager:
    def __init__(self, save_dir, disease_names):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.disease_names = list(disease_names)
        # each artifact family in its subdirectory, as the JAX manager
        # lays them out
        self.dirs = {
            "roc": self.save_dir / "roc_curves",
            "pr": self.save_dir / "pr_curves",
            "confusion": self.save_dir / "confusion_matrices",
            "attention": self.save_dir / "attention_maps",
            "error": self.save_dir / "error_analysis",
            "training": self.save_dir / "training_progress",
        }
        for dir_path in self.dirs.values():
            dir_path.mkdir(parents=True, exist_ok=True)

    # -- curves ---------------------------------------------------------

    def plot_roc_curves(self, targets, predictions, filename="roc_curves.png",
                        title="ROC Curves", dpi=None):
        path = self.dirs["roc"] / filename
        plt = pyplot(str(path))
        if plt is None:
            return None
        plt.figure(figsize=(15, 10))
        for i, disease in enumerate(self.disease_names):
            if len(np.unique(targets[:, i])) < 2:
                continue
            fpr, tpr, _ = roc_curve(targets[:, i], predictions[:, i])
            auc = roc_auc(targets[:, i], predictions[:, i])
            plt.plot(fpr, tpr, label=f"{disease} (AUC = {auc:.3f})")
        plt.plot([0, 1], [0, 1], "k--")
        plt.xlabel("False Positive Rate")
        plt.ylabel("True Positive Rate")
        plt.title(title)
        plt.legend(bbox_to_anchor=(1.05, 1), loc="upper left")
        plt.tight_layout()
        plt.savefig(path, bbox_inches="tight", dpi=dpi)
        plt.close()
        return path

    def plot_pr_curves(self, targets, predictions, filename="pr_curves.png"):
        path = self.dirs["pr"] / filename
        plt = pyplot(str(path))
        if plt is None:
            return None
        plt.figure(figsize=(15, 10))
        for i, disease in enumerate(self.disease_names):
            if len(np.unique(targets[:, i])) < 2:
                continue
            prec, rec, _ = precision_recall_curve(targets[:, i],
                                                  predictions[:, i])
            ap = average_precision(targets[:, i], predictions[:, i])
            plt.plot(rec, prec, label=f"{disease} (AP = {ap:.3f})")
        plt.xlabel("Recall")
        plt.ylabel("Precision")
        plt.title("Precision-Recall Curves")
        plt.legend(bbox_to_anchor=(1.05, 1), loc="upper left")
        plt.tight_layout()
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        return path

    def plot_confusion_matrices(self, targets, predictions, threshold=0.5,
                                filename="confusion_matrices.png", dpi=None):
        """A 2×2 count matrix per disease, four to a row, each a Blues
        heatmap with its counts written in its cells (no colour bars: in a
        PDF each would be a resampled gradient image, seconds a figure)."""
        path = self.dirs["confusion"] / filename
        plt = pyplot(str(path))
        if plt is None:
            return None
        binary = (predictions > threshold).astype(np.int64)
        n_rows = (len(self.disease_names) + 3) // 4
        fig, axes = plt.subplots(n_rows, 4, figsize=(20, 5 * n_rows))
        axes = np.asarray(axes).flatten()
        for i, (disease, ax) in enumerate(zip(self.disease_names, axes)):
            t, b = targets[:, i].astype(np.int64), binary[:, i]
            cm = np.array([
                [np.sum((t == 0) & (b == 0)), np.sum((t == 0) & (b == 1))],
                [np.sum((t == 1) & (b == 0)), np.sum((t == 1) & (b == 1))],
            ])
            # "none": the 2×2 cells go into a PDF as they are, not
            # resampled to its dpi
            ax.imshow(cm, cmap="Blues", interpolation="none")
            for (r, c), count in np.ndenumerate(cm):
                ax.text(c, r, f"{count:d}", ha="center", va="center",
                        color="white" if count > cm.max() / 2 else "black")
            ax.set_xticks([0, 1])
            ax.set_yticks([0, 1])
            ax.set_title(disease)
            ax.set_xlabel("Predicted")
            ax.set_ylabel("True")
        for ax in axes[len(self.disease_names):]:
            ax.remove()
        plt.tight_layout()
        plt.savefig(path, bbox_inches="tight", dpi=dpi)
        plt.close()
        return path

    # -- interpretability ----------------------------------------------

    def plot_attention_maps(self, model, images_normalised, images_u8=None,
                            filename="attention_maps.png"):
        """Attention-rollout maps of up to 8 images, under the images."""
        from gavit_tpu_torch.utils.gradcam import attention_rollout

        maps, _ = attention_rollout(model, images_normalised)
        path = self.dirs["attention"] / filename
        plt = pyplot(str(path))
        if plt is None:
            return None
        n = min(8, maps.shape[0])
        fig, axes = plt.subplots(2, n, figsize=(3 * n, 6))
        if n == 1:
            axes = axes.reshape(2, 1)
        for j in range(n):
            if images_u8 is not None:
                axes[0, j].imshow(images_u8[j])
            axes[0, j].set_title(f"image {j}")
            axes[0, j].axis("off")
            axes[1, j].imshow(maps[j], cmap="jet")
            axes[1, j].set_title("attention rollout")
            axes[1, j].axis("off")
        plt.tight_layout()
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        return path

    def plot_per_layer_attention(self, model, images_normalised,
                                 prefix="attention_map"):
        """One heatmap per transformer block of the first image's attention
        (the mean over heads of its ``[N, N]`` probabilities, from the
        model's ``capture='attention'``). Returns the written paths,
        ``{prefix}_blocks_{i}.pdf``."""
        with torch.no_grad():
            _, probs = model(images_normalised, capture="attention")
        maps = [p[0].float().mean(dim=0).cpu().numpy() for p in probs]
        plt = pyplot(f"{prefix}_blocks_*.pdf in {self.dirs['attention']}")
        if plt is None:
            return []
        paths = []
        for i, att in enumerate(maps):
            plt.figure(figsize=(10, 10))
            plt.imshow(att, cmap="viridis")
            plt.colorbar()
            plt.title(f"Attention Map - blocks_{i}")
            path = self.dirs["attention"] / f"{prefix}_blocks_{i}.pdf"
            plt.savefig(path, bbox_inches="tight")
            plt.close()
            paths.append(path)
        return paths

    def plot_gradcam(self, model, images_normalised, images_u8, class_idx,
                     filename="gradcam.png"):
        """Grad-CAM overlays of one class on up to 8 images, each titled
        with the class and its probability."""
        from gavit_tpu_torch.utils.gradcam import (VisionTransformerGradCAM,
                                                   overlay_cam)

        gc = VisionTransformerGradCAM(model)
        cams, probs = gc(images_normalised, class_idx)
        path = self.dirs["attention"] / filename
        plt = pyplot(str(path))
        if plt is None:
            return None
        n = min(8, cams.shape[0])
        fig, axes = plt.subplots(1, n, figsize=(3 * n, 3.4))
        axes = np.atleast_1d(axes)
        for j in range(n):
            axes[j].imshow(overlay_cam(images_u8[j], cams[j]))
            axes[j].set_title(
                f"{self.disease_names[class_idx]}\np={probs[j, class_idx]:.2f}"
            )
            axes[j].axis("off")
        plt.tight_layout()
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        return path

    # -- training progress ---------------------------------------------

    def plot_training_progress(self, train_history, val_history,
                               filename="training_progress.png"):
        """``{loss,auc,ap,f1}_progress.pdf`` (one per metric the history
        holds) and the combined loss/AUC panel ``filename``, all in
        ``training_progress/``."""
        path = self.dirs["training"] / filename
        plt = pyplot(f"{path} and the *_progress.pdf beside it")
        if plt is None:
            return None
        for metric, key in [("loss", "loss"), ("auc", "mean_auc"),
                            ("ap", "mean_ap"), ("f1", "mean_f1")]:
            if not (train_history and key in train_history[0]):
                continue
            plt.figure(figsize=(10, 6))
            plt.plot([m[key] for m in train_history], label="Train")
            plt.plot([m[key] for m in val_history if key in m],
                     label="Validation")
            plt.xlabel("Epoch")
            plt.ylabel(metric.upper())
            plt.title(f"Training Progress - {metric.upper()}")
            plt.legend()
            plt.grid(True)
            plt.savefig(self.dirs["training"] / f"{metric}_progress.pdf",
                        bbox_inches="tight")
            plt.close()
        fig, axes = plt.subplots(1, 2, figsize=(14, 5))
        axes[0].plot([m["loss"] for m in train_history], label="train")
        axes[0].plot([m["loss"] for m in val_history], label="val")
        axes[0].set_xlabel("Epoch")
        axes[0].set_ylabel("Loss")
        axes[0].set_title("Loss")
        axes[0].legend()
        axes[1].plot([m["mean_auc"] for m in train_history], label="train")
        axes[1].plot([m["mean_auc"] for m in val_history], label="val")
        axes[1].set_xlabel("Epoch")
        axes[1].set_ylabel("Mean AUC")
        axes[1].set_title("Mean AUC")
        axes[1].legend()
        plt.tight_layout()
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        return path

    def plot_learning_rate(self, schedule, total_steps,
                           filename="learning_rate.png"):
        """The schedule (a callable of the step) over ``total_steps``, on a
        log axis clipped above 0 (the warmup starts at 0)."""
        path = self.dirs["training"] / filename
        plt = pyplot(str(path))
        if plt is None:
            return None
        steps = np.arange(0, total_steps, max(1, total_steps // 1000))
        lrs = [float(schedule(int(s))) for s in steps]
        plt.figure(figsize=(10, 4))
        plt.plot(steps, lrs)
        plt.xlabel("Step")
        plt.ylabel("Learning rate")
        plt.title("LR schedule (linear warmup → cosine)")
        plt.yscale("log")
        plt.ylim(bottom=max(min((l for l in lrs if l > 0), default=1e-8)
                            * 0.5, 1e-12))
        plt.grid(True)
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        return path

    # -- error analysis --------------------------------------------------

    def plot_error_analysis(self, targets, predictions, threshold=0.5,
                            filename="error_analysis.png"):
        """Per-disease false-positive and false-negative rates beside the
        error co-occurrence matrix."""
        path = self.dirs["error"] / filename
        plt = pyplot(str(path))
        if plt is None:
            return None
        binary = (predictions > threshold).astype(np.int64)
        t = targets.astype(np.int64)
        errors = binary != t
        fp = ((binary == 1) & (t == 0)).mean(0)
        fn = ((binary == 0) & (t == 1)).mean(0)
        cooc = (errors.astype(float).T @ errors.astype(float)) / len(errors)

        fig, axes = plt.subplots(1, 2, figsize=(18, 6))
        idx = np.arange(len(self.disease_names))
        axes[0].bar(idx - 0.2, fp, 0.4, label="FP rate")
        axes[0].bar(idx + 0.2, fn, 0.4, label="FN rate")
        axes[0].set_xticks(idx)
        axes[0].set_xticklabels(self.disease_names, rotation=90)
        axes[0].set_title("Error rates per disease")
        axes[0].legend()
        im = axes[1].imshow(cooc, cmap="Reds")
        axes[1].set_xticks(idx)
        axes[1].set_xticklabels(self.disease_names, rotation=90)
        axes[1].set_yticks(idx)
        axes[1].set_yticklabels(self.disease_names)
        axes[1].set_title("Error co-occurrence")
        fig.colorbar(im, ax=axes[1])
        plt.tight_layout()
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        return path

    # -- tables -----------------------------------------------------------

    def save_performance_tables(self, metrics: dict, basename="performance",
                                ci_metrics: dict | None = None):
        """CSV and LaTeX per-disease metric tables, ``{basename}.csv`` and
        ``{basename}.tex``; ``ci_metrics`` (the
        ``calculate_confidence_intervals`` dict) adds the AUC-ROC CI column,
        "(lo-hi)"."""
        cols = ["auc", "ap", "f1", "sensitivity", "specificity", "precision"]
        headers = [c.upper() for c in cols]
        if ci_metrics is not None:
            headers.append("AUC-ROC CI")
        rows = []
        for d in self.disease_names:
            row = [d] + [
                f"{metrics[f'{d}_{c}']:.4f}" if f"{d}_{c}" in metrics else "-"
                for c in cols
            ]
            if ci_metrics is not None:
                ci = ci_metrics.get(f"{d}_auc_ci")
                row.append(f"({ci[0]:.3f}-{ci[1]:.3f})" if ci else "-")
            rows.append(row)
        mean_row = ["Mean"] + [
            f"{metrics.get(f'mean_{c}', float('nan')):.4f}" for c in cols
        ]
        if ci_metrics is not None:
            ci = ci_metrics.get("mean_auc_ci")
            mean_row.append(f"({ci[0]:.3f}-{ci[1]:.3f})" if ci else "-")
        rows.append(mean_row)
        csv_path = self.save_dir / f"{basename}.csv"
        with open(csv_path, "w") as f:
            f.write(",".join(["Disease"] + headers) + "\n")
            for row in rows:
                f.write(",".join(row) + "\n")

        tex_path = self.save_dir / f"{basename}.tex"
        with open(tex_path, "w") as f:
            f.write("\\begin{tabular}{l" + "c" * len(headers)
                    + "}\n\\toprule\n")
            f.write(
                " & ".join(["Disease"] + headers) + " \\\\\n\\midrule\n"
            )
            for row in rows:
                f.write(" & ".join(row) + " \\\\\n")
            f.write("\\bottomrule\n\\end{tabular}\n")
        return csv_path, tex_path

    # -- prediction grids ------------------------------------------------

    def plot_prediction_grid(self, images_u8, targets, predictions,
                             threshold=0.5, filename="predictions.png"):
        """Up to 8 images titled with their true and predicted labels."""
        path = self.save_dir / filename
        plt = pyplot(str(path))
        if plt is None:
            return None
        n = min(8, len(images_u8))
        fig, axes = plt.subplots(1, n, figsize=(3 * n, 4))
        axes = np.atleast_1d(axes)
        for j in range(n):
            axes[j].imshow(images_u8[j])
            true = [self.disease_names[i]
                    for i in range(len(self.disease_names))
                    if targets[j, i] > 0.5]
            pred = [self.disease_names[i]
                    for i in range(len(self.disease_names))
                    if predictions[j, i] > threshold]
            axes[j].set_title(
                "T: " + (", ".join(true) or "none") + "\n"
                "P: " + (", ".join(pred) or "none"),
                fontsize=8,
            )
            axes[j].axis("off")
        plt.tight_layout()
        plt.savefig(path, bbox_inches="tight")
        plt.close()
        return path
