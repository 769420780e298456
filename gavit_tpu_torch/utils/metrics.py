"""Multi-label classification metrics (the port's copy of
``gavit_tpu/utils/metrics.py``'s ``MetricCalculator``).

Per-disease AUC-ROC, average precision, F1 at threshold 0.5 (or per-disease
thresholds), sensitivity / specificity / precision from confusion counts,
their means over the diseases whose targets hold both labels (single-valued
columns are skipped), the exact-match ratio, bootstrap confidence intervals
(``np.random.default_rng(seed)`` draws, n = 1000, α = 0.05) and Youden's-J
operating points.

The JAX package calls scikit-learn; the card's machine has none, so the
three curves are written here in numpy on scikit-learn's definitions:
the AUC as the tie-aware rank statistic (scipy's average ranks), the
average precision as the step-wise sum over the distinct thresholds
(``-Σ diff(recall)·precision``), and the ROC curve with every threshold
kept (``drop_intermediate=False``), its first threshold +inf.
``tests/test_torch_train_utils.py`` holds every key to the JAX
calculator within 1e-12. The precision-recall curve
(:func:`precision_recall_curve`) is scikit-learn's too, for the figures.
``plot_metrics`` draws the loss and per-disease AUC figures with
matplotlib, imported inside the call; where it is missing (the card's
machine) it logs which figures it skipped and returns.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
from scipy.stats import rankdata

logger = logging.getLogger(__name__)


def roc_auc(y_true, y_score) -> float:
    """Area under the ROC curve of one binary column with both labels:
    the Mann-Whitney statistic over average ranks (ties count a half)."""
    y = np.asarray(y_true) == 1
    ranks = rankdata(np.asarray(y_score, np.float64))
    n_pos = float(y.sum())
    n_neg = float(y.size) - n_pos
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _binary_clf_curve(y_true, y_score):
    """(false positives, true positives, thresholds) at each distinct score,
    scores descending, in float64 (scikit-learn's ``_binary_clf_curve``)."""
    y_true = np.asarray(y_true) == 1
    y_score = np.asarray(y_score, np.float64)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    return fps, tps, y_score[idx]


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds) at the distinct thresholds, recall
    decreasing, with the last point (1, 0) and no threshold of its own."""
    fps, tps, thr = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.zeros_like(tps)
    np.divide(tps, ps, out=precision, where=ps != 0)
    recall = tps / tps[-1]
    return (np.hstack((precision[::-1], 1)), np.hstack((recall[::-1], 0)),
            thr[::-1])


def average_precision(y_true, y_score) -> float:
    """Step-wise average precision: Σ (R_n − R_{n−1}) P_n over the distinct
    thresholds, scores descending."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(-np.sum(np.diff(recall) * np.array(precision)[:-1]))


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) with every distinct threshold kept and a
    first point (0, 0) at threshold +inf."""
    fps, tps, thr = _binary_clf_curve(y_true, y_score)
    tps = np.r_[0, tps]
    fps = np.r_[0, fps]
    thr = np.r_[np.inf, thr]
    return fps / fps[-1], tps / tps[-1], thr


class MetricCalculator:
    def __init__(self, disease_names):
        self.disease_names = list(disease_names)

    def calculate_metrics(self, targets, predictions, threshold=0.5):
        """``threshold``: scalar, or per-disease array [C] (e.g. the
        operating points from :meth:`optimal_thresholds`)."""
        targets = np.asarray(targets)
        predictions = np.asarray(predictions)
        binary = (predictions > np.asarray(threshold)).astype(np.float64)

        tp = ((binary == 1) & (targets == 1)).sum(axis=0).astype(np.float64)
        tn = ((binary == 0) & (targets == 0)).sum(axis=0).astype(np.float64)
        fp = ((binary == 1) & (targets == 0)).sum(axis=0).astype(np.float64)
        fn = ((binary == 0) & (targets == 1)).sum(axis=0).astype(np.float64)

        def safe_div(a, b):
            return float(a / b) if b > 0 else 0.0

        metrics: dict = {}
        valid = []
        for i, disease in enumerate(self.disease_names):
            if len(np.unique(targets[:, i])) < 2:
                continue  # AUC undefined for single-valued targets
            valid.append(disease)
            metrics[f"{disease}_auc"] = roc_auc(targets[:, i],
                                                predictions[:, i])
            metrics[f"{disease}_ap"] = average_precision(targets[:, i],
                                                         predictions[:, i])
            prec = safe_div(tp[i], tp[i] + fp[i])
            rec = safe_div(tp[i], tp[i] + fn[i])
            metrics[f"{disease}_f1"] = (
                2 * prec * rec / (prec + rec) if (prec + rec) > 0 else 0.0)
            metrics[f"{disease}_sensitivity"] = rec
            metrics[f"{disease}_specificity"] = safe_div(tn[i], tn[i] + fp[i])
            metrics[f"{disease}_precision"] = prec

        for mt in ("auc", "ap", "f1", "sensitivity", "specificity",
                   "precision"):
            vals = [metrics[f"{d}_{mt}"] for d in valid]
            metrics[f"mean_{mt}"] = float(np.mean(vals)) if vals else 0.0

        metrics["exact_match"] = float(np.mean(np.all(binary == targets,
                                                      axis=1)))
        return metrics

    def optimal_thresholds(self, targets, predictions) -> dict:
        """Per-disease operating points maximising Youden's J (sens + spec
        − 1) on the ROC curve, as the midpoint down to the next-lower score
        (the battery thresholds with a strict >). Fit in-sample: metrics at
        them on the same set are optimistic. Single-valued columns are
        skipped."""
        targets = np.asarray(targets)
        predictions = np.asarray(predictions)
        out = {}
        for i, disease in enumerate(self.disease_names):
            if len(np.unique(targets[:, i])) < 2:
                continue
            fpr, tpr, thr = roc_curve(targets[:, i], predictions[:, i])
            j = int(np.argmax(tpr - fpr))
            t = thr[j + 1: j + 2].mean() * 0.5 + thr[j] * 0.5 \
                if j + 1 < len(thr) else thr[j] - 1e-6
            if not np.isfinite(t):  # thr[0] is +inf when j == 0
                t = float(np.max(predictions[:, i]))
            out[disease] = float(t)
        return out

    def calculate_confidence_intervals(
        self, targets, predictions, n_bootstrap: int = 1000,
        alpha: float = 0.05, seed: int | None = None,
    ):
        """Bootstrap CIs over resampled metric distributions."""
        targets = np.asarray(targets)
        predictions = np.asarray(predictions)
        n = len(targets)
        rng = np.random.default_rng(seed)
        samples: list[dict] = []
        for _ in range(n_bootstrap):
            idx = rng.integers(0, n, n)
            samples.append(self.calculate_metrics(targets[idx],
                                                  predictions[idx]))

        keys = set(samples[0])
        for s in samples[1:]:
            keys &= set(s)
        ci = {}
        for key in sorted(keys):
            vals = [s[key] for s in samples]
            ci[f"{key}_ci"] = (
                float(np.percentile(vals, alpha / 2 * 100)),
                float(np.percentile(vals, (1 - alpha / 2) * 100)),
            )
        return ci

    def plot_metrics(self, metrics_history, save_dir) -> None:
        """The loss curve and the per-disease AUC curves over the epochs,
        ``loss_curve.png`` and ``auc_curves.png`` in ``save_dir``, as the
        JAX calculator draws them."""
        from gavit_tpu_torch.utils.visualization import pyplot

        plt = pyplot(f"loss_curve.png and auc_curves.png in {save_dir}")
        if plt is None:
            return
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)

        plt.figure(figsize=(10, 6))
        plt.plot([m["loss"] for m in metrics_history], label="Loss")
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.title("Training Loss")
        plt.legend()
        plt.savefig(save_dir / "loss_curve.png")
        plt.close()

        plt.figure(figsize=(12, 8))
        for disease in self.disease_names:
            series = [m.get(f"{disease}_auc") for m in metrics_history]
            if any(v is not None for v in series):
                plt.plot([v if v is not None else np.nan for v in series],
                         label=disease)
        plt.xlabel("Epoch")
        plt.ylabel("AUC-ROC")
        plt.title("AUC-ROC per Disease")
        plt.legend(bbox_to_anchor=(1.05, 1), loc="upper left")
        plt.tight_layout()
        plt.savefig(save_dir / "auc_curves.png")
        plt.close()
