#!/usr/bin/env python
"""Offline evaluation of a port checkpoint: metrics, bootstrap CIs,
operating points, error analysis and the served p50 (counterpart of
``scripts/evaluate.py``, with its flags).

    python scripts/evaluate_torch.py --config <yaml> \\
        --checkpoint <save_dir>/best_model --dataset nih|chexpert|synthetic \\
        [--calibration-frac F] [--device cuda|cpu] [--set key=value ...]

Loads the model from a checkpoint of ``scripts/train_torch.py``
(``state.pt``, ``gavit_tpu_torch/utils/checkpoint.py``) at dropout 0 in
``training.precision``, runs the eval forward over the dataset (``nih``:
``data.val_dir`` with ``data.val_labels``; ``chexpert``:
``data.chexpert_dir`` with ``data.chexpert_labels``, PNG files decoded on
``data.num_workers`` threads; ``synthetic``) through the
Hopper kernels on the card, and writes
``<save_dir>/evaluation/evaluation_results.json`` with the JAX script's
keys: ``metrics`` (at 0.5), ``optimal_thresholds`` (Youden's J, in-sample)
and ``metrics_at_optimal_thresholds``, ``confidence_intervals`` (1000
bootstrap draws, seed 0), ``error_analysis`` (per-disease error rates and
their co-occurrence), ``p50_single_image_latency_ms`` (50 one-image calls
through ``Predictor``, the served path) and ``batch_latency_ms`` (10 calls
on up to 64 images); with ``--calibration-frac`` the thresholds are fit on
a held-out split and the battery reported on the rest
(``calibration``, ``metrics_at_calibrated_thresholds``). Beside it, as
the JAX script writes them through ``VisualizationManager``:
``roc_curves/roc_curves.pdf`` and ``confusion_matrices/
confusion_matrices.pdf`` (dpi 300; skipped with a log line where
matplotlib is missing, as on the card's machine) and the per-disease
tables ``performance.csv`` and ``performance.tex`` with the AUC-ROC CI
column. The JAX script evaluates in fp32; this one in the precision the
port trains in.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

logger = logging.getLogger("evaluate_torch")


def load_model(checkpoint_path, config, device, precision=None):
    """The model at dropout 0 with the checkpoint's parameters (fresh
    weights from seed 0 without a checkpoint), in eval mode on ``device``,
    computing in ``precision`` (default ``training.precision``)."""
    from gavit_tpu_torch.models.vit import build_model, init_params
    from gavit_tpu_torch.utils import checkpoint as ckpt_lib

    model_cfg = dataclasses.replace(config.model, drop_rate=0.0)
    model = build_model(model_cfg,
                        precision=precision or config.training.precision)
    init_params(model, torch.Generator().manual_seed(0))
    if checkpoint_path:
        state, _ = ckpt_lib.restore(checkpoint_path, map_location="cpu")
        model.load_state_dict(state["model"])
    return model.to(device).eval()


def analyze_error_patterns(predictions, targets, disease_names):
    """Per-disease error rates and the error co-occurrence matrix."""
    binary = (predictions > 0.5).astype(np.int64)
    errors = (binary != targets).astype(np.float64)
    error_rates = errors.mean(axis=0)
    error_df = {
        "Disease": {i: d for i, d in enumerate(disease_names)},
        "Error Rate": {i: float(r) for i, r in enumerate(error_rates)},
    }
    cooc = (errors.T @ errors) / len(errors)
    return error_df, cooc


@torch.no_grad()
def predict(model, dataloader, device) -> tuple[np.ndarray, np.ndarray]:
    """Sigmoid probabilities and targets over the whole loader."""
    from gavit_tpu_torch.data.loader import to_device
    from gavit_tpu_torch.ops.preprocess import val_preprocess

    preds, targets = [], []
    for images, labels in dataloader:
        x = val_preprocess(to_device(images, device))
        preds.append(torch.sigmoid(model(x).float()))
        targets.append(labels)
    return torch.cat(preds).cpu().numpy(), np.concatenate(targets)


def served_latency(config, model, dataset, device) -> tuple[float, dict]:
    """(p50 ms of one image through ``Predictor``, its batch latency stats
    over 10 calls on up to 64 images) with the model's weights."""
    from gavit_tpu_torch.data.loader import read_batch
    from gavit_tpu_torch.serving import Predictor
    from gavit_tpu_torch.utils.convert import to_flax_tree

    pred = Predictor(config, to_flax_tree(model),
                     precision=config.training.precision, device=device)
    one = read_batch(dataset, [0])[0]
    pred.predict_proba(one)  # builds the kernels
    pred._latencies_ms.clear()
    for _ in range(50):
        pred.predict_proba(one)
    p50 = pred.latency_stats()["p50_ms"]
    probe = read_batch(dataset, np.arange(min(len(dataset), 64)))[0]
    pred.predict_proba(probe)
    pred._latencies_ms.clear()
    for _ in range(10):
        pred.predict_proba(probe)
    return p50, pred.latency_stats()


def evaluate(model, dataloader, device, prng_seed: int = 0,
             calibration_frac: float = 0.0, save_dir=None) -> dict:
    """The battery over the loader; with ``save_dir``, the ROC and
    confusion-matrix PDFs and the performance tables there too."""
    from gavit_tpu_torch.utils.metrics import MetricCalculator
    from gavit_tpu_torch.utils.visualization import VisualizationManager

    names = dataloader.dataset.disease_names
    calc = MetricCalculator(names)
    predictions, targets = predict(model, dataloader, device)

    calibration = None
    metrics_at_calibrated = None
    if calibration_frac and 0.0 < calibration_frac < 1.0:
        rng = np.random.default_rng(prng_seed)
        n = len(predictions)
        n_cal = min(max(1, int(round(n * calibration_frac))), n - 1)
        perm = rng.permutation(n)
        cal_idx, eval_idx = perm[:n_cal], perm[n_cal:]
        cal_thresholds = calc.optimal_thresholds(targets[cal_idx],
                                                 predictions[cal_idx])
        predictions, targets = predictions[eval_idx], targets[eval_idx]
        metrics_at_calibrated = calc.calculate_metrics(
            targets, predictions,
            threshold=np.asarray([cal_thresholds.get(d, 0.5) for d in names]))
        calibration = {
            "fraction": float(calibration_frac),
            "n_calibration": int(n_cal),
            "n_eval": int(len(eval_idx)),
            "thresholds": cal_thresholds,
            "note": ("Youden-J thresholds fit on a held-out calibration "
                     "split; metrics/metrics_at_calibrated_thresholds (and "
                     "every other artifact) are computed on the disjoint "
                     "eval split"),
        }

    metrics = calc.calculate_metrics(targets, predictions)
    ci = calc.calculate_confidence_intervals(targets, predictions,
                                             seed=prng_seed)
    thresholds = calc.optimal_thresholds(targets, predictions)
    metrics_at_optimal = calc.calculate_metrics(
        targets, predictions,
        threshold=np.asarray([thresholds.get(d, 0.5) for d in names]))
    if save_dir is not None:
        # the JAX script's evaluation artifacts (scripts/evaluate.py:212-225)
        viz = VisualizationManager(save_dir, names)
        viz.plot_roc_curves(targets, predictions, filename="roc_curves.pdf",
                            title="ROC Curves for All Diseases", dpi=300)
        viz.plot_confusion_matrices(targets, predictions,
                                    filename="confusion_matrices.pdf",
                                    dpi=300)
        viz.save_performance_tables(metrics, ci_metrics=ci)
    error_df, cooc = analyze_error_patterns(predictions, targets, names)
    out = {
        "metrics": metrics,
        "optimal_thresholds": thresholds,
        "optimal_thresholds_note": (
            "Youden-J thresholds fit on this evaluation set; "
            "metrics_at_optimal_thresholds is in-sample-optimistic — refit "
            "on a held-out split before quoting deployed operating points"),
        "metrics_at_optimal_thresholds": metrics_at_optimal,
        "confidence_intervals": {k: list(v) for k, v in ci.items()},
        "error_analysis": {"per_disease_errors": error_df,
                           "error_cooccurrence": cooc.tolist()},
    }
    if calibration is not None:
        out["calibration"] = calibration
        out["metrics_at_calibrated_thresholds"] = metrics_at_calibrated
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--dataset", choices=["nih", "chexpert", "synthetic"],
                   required=True)
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="KEY=VALUE",
                   help="Override a config value (dotted keys, YAML-parsed "
                        "values)")
    p.add_argument("--calibration-frac", type=float, default=0.0,
                   help="Hold out this fraction of the dataset to fit "
                        "Youden-J operating points; the battery is then "
                        "reported on the disjoint remainder at 0.5 AND at "
                        "the calibrated thresholds")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    from gavit_tpu_torch.config import load_config
    from gavit_tpu_torch.data.dataset import (ChestXrayDataset,
                                              SyntheticChestXrayDataset)
    from gavit_tpu_torch.data.loader import DataLoader

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("evaluate_torch: --device cuda needs a CUDA device "
                         "and this PyTorch sees none (use --device cpu)")
    config = load_config(args.config, args.overrides)
    save_dir = Path(config.paths.save_dir) / "evaluation"
    save_dir.mkdir(parents=True, exist_ok=True)
    model = load_model(args.checkpoint, config, device)
    d = config.data
    if args.dataset == "nih":
        dataset = ChestXrayDataset(d.val_dir, d.val_labels,
                                   image_size=d.image_size)
    elif args.dataset == "chexpert":
        dataset = ChestXrayDataset(d.chexpert_dir, d.chexpert_labels,
                                   image_size=d.image_size)
    else:
        dataset = SyntheticChestXrayDataset(size=d.synthetic_size,
                                            image_size=d.image_size)
    loader = DataLoader(dataset, d.batch_size, num_workers=d.num_workers)
    results = evaluate(model, loader, device,
                       calibration_frac=args.calibration_frac,
                       save_dir=save_dir)
    p50, batch = served_latency(config, model, dataset, device)
    results["p50_single_image_latency_ms"] = p50
    results["batch_latency_ms"] = batch
    logger.info(f"mean AUC {results['metrics']['mean_auc']:.4f}; p50 "
                f"single-image latency {p50:.2f} ms; serving batch latency "
                f"{batch}")
    with open(save_dir / "evaluation_results.json", "w") as f:
        json.dump(results, f, indent=4)
    logger.info(f"Wrote {save_dir / 'evaluation_results.json'}")
    return results


if __name__ == "__main__":
    main()
