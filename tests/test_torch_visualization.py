"""The port's figures against the JAX package's, on the CPU at
``tests/test_gradcam_viz.py``'s tiny size (img 32, patch 8, D 32, depth 2,
2 heads; one torch thread):

* every ``VisualizationManager`` method writes the file names the JAX
  manager writes on the same inputs (the model-taking ones with the port's
  model and the JAX one on the same weights), and the performance tables
  are the JAX manager's text;
* with matplotlib hidden, each drawing call logs one line naming the
  figure it skips and returns, after computing its maps; the tables are
  still written;
* ``scripts/train_torch.py``, ``scripts/evaluate_torch.py`` and
  ``scripts/gradcam_torch.py`` on a tiny synthetic config write the
  figure files ``scripts/train.py``, ``scripts/evaluate.py`` and
  ``scripts/gradcam.py`` write (their names, read from those scripts, are
  listed here).
"""

import logging
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.data.dataset import DISEASE_NAMES
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.utils import visualization as jviz
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.training.schedule import warmup_cosine_schedule
from gavit_tpu_torch.utils.convert import to_flax_tree
from gavit_tpu_torch.utils.metrics import MetricCalculator
from gavit_tpu_torch.utils.visualization import VisualizationManager
from test_torch_gradcam import _JittedModel

ROOT = Path(__file__).resolve().parents[1]
RAW = {"model": {"name": "custom", "img_size": 32, "patch_size": 8,
                 "embed_dim": 32, "depth": 2, "num_heads": 2,
                 "num_classes": 14, "drop_rate": 0.0}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(0)
    targets = (rng.random((20, 14)) < 0.4).astype(np.float64)
    preds = np.clip(targets * 0.5 + rng.random((20, 14)) * 0.5, 0, 1)
    hist = [{"loss": 1.0, "mean_auc": 0.5, "mean_ap": 0.3, "mean_f1": 0.2},
            {"loss": 0.8, "mean_auc": 0.6, "mean_ap": 0.4, "mean_f1": 0.3}]
    metrics = {f"{d}_{c}": 0.5 + 0.01 * i for i, d in enumerate(DISEASE_NAMES)
               for c in ("auc", "ap", "f1", "sensitivity", "specificity",
                         "precision")}
    metrics.update({f"mean_{c}": 0.5 for c in
                    ("auc", "ap", "f1", "sensitivity", "specificity",
                     "precision")})
    ci = {f"{d}_auc_ci": (0.41, 0.62) for d in DISEASE_NAMES[:-1]}
    ci["mean_auc_ci"] = (0.45, 0.58)
    images_u8 = rng.integers(0, 255, (4, 32, 32, 3), np.uint8)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return targets, preds, hist, metrics, ci, images_u8, x


class _Unrendered:
    """pyplot for the JAX manager: its figures are built, never laid out
    or rendered, and its files written empty (the names are what the test
    compares; rendering them would double the test's time)."""

    plt = jviz.plt

    def __getattr__(self, name):
        return getattr(self.plt, name)

    @staticmethod
    def savefig(path, **_):
        Path(path).touch()

    @staticmethod
    def tight_layout():
        pass


class _Seaborn:
    """seaborn for the JAX manager's confusion grid: its heatmap as a bare
    image (importing seaborn and building its colour bars took 8 s)."""

    @staticmethod
    def heatmap(data, ax, **_):
        ax.imshow(data)


def _files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*")}


def test_manager_methods_write_the_jax_file_names(tmp_path, monkeypatch):
    targets, preds, hist, metrics, ci, images_u8, x = _inputs()
    monkeypatch.setattr(jviz, "plt", _Unrendered())
    monkeypatch.setitem(sys.modules, "seaborn", _Seaborn())
    model = init_params(build_model(from_dict(RAW).model),
                        torch.Generator().manual_seed(0))
    params = jax.tree.map(np.asarray, to_flax_tree(model))
    jax_model = jax_build_model(jax_from_dict(RAW).model, precision="fp32")
    jmodel = _JittedModel(jax_model)
    port = VisualizationManager(tmp_path / "port", DISEASE_NAMES)
    jaxm = jviz.VisualizationManager(tmp_path / "jax", DISEASE_NAMES)
    for viz in (port, jaxm):
        viz.plot_roc_curves(targets, preds)
        viz.plot_pr_curves(targets, preds)
        viz.plot_confusion_matrices(targets, preds)
        viz.plot_error_analysis(targets, preds)
        viz.plot_training_progress(hist, hist)
        viz.save_performance_tables(metrics)
        viz.save_performance_tables(metrics, basename="perf_ci",
                                    ci_metrics=ci)
        viz.plot_prediction_grid(images_u8, targets[:4], preds[:4])
    for viz in (port, jaxm):
        viz.plot_learning_rate(warmup_cosine_schedule(1e-4, 10, 100), 100)
    xt = torch.from_numpy(x)
    assert port.plot_attention_maps(model, xt, images_u8[:2]).exists()
    jaxm.plot_attention_maps(jmodel, params, x, images_u8[:2])
    assert port.plot_gradcam(model, xt, images_u8[:2], 3).exists()
    # (its Grad-CAM jits the model itself)
    jaxm.plot_gradcam(jax_model, params, x, images_u8[:2], 3)
    paths = port.plot_per_layer_attention(model, xt[:1])
    assert len(paths) == 2 and all(p.exists() for p in paths)
    jaxm.plot_per_layer_attention(jmodel, params, x[:1])

    names = _files(tmp_path / "port")
    assert names == _files(tmp_path / "jax")
    assert {"roc_curves/roc_curves.png", "pr_curves/pr_curves.png",
            "training_progress/f1_progress.pdf",
            "attention_maps/attention_map_blocks_1.pdf",
            "perf_ci.tex"} <= names
    for name in ("performance.csv", "performance.tex", "perf_ci.csv",
                 "perf_ci.tex"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()


def test_hidden_matplotlib_skips_the_drawing_with_a_log_line(
        tmp_path, monkeypatch, caplog):
    targets, preds, hist, metrics, ci, images_u8, x = _inputs()
    model = init_params(build_model(from_dict(RAW).model),
                        torch.Generator().manual_seed(0))
    viz = VisualizationManager(tmp_path, DISEASE_NAMES)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    # the maps are still computed: the model runs for Grad-CAM and for
    # the per-block attention
    calls = []
    model.head.register_forward_hook(lambda m, i, o: calls.append(o.shape))
    with caplog.at_level(logging.INFO):
        assert viz.plot_roc_curves(targets, preds) is None
        assert viz.plot_gradcam(model, torch.from_numpy(x), images_u8[:2],
                                0) is None
        assert viz.plot_per_layer_attention(model, torch.from_numpy(x)) == []
        MetricCalculator(DISEASE_NAMES).plot_metrics(hist, tmp_path / "fig")
        csv_path, tex_path = viz.save_performance_tables(metrics,
                                                         ci_metrics=ci)
    assert calls == [(2, 14), (2, 14)]
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 4 and all(
        line.startswith("figure skipped: ") and "matplotlib" in line
        for line in lines)
    assert "roc_curves.png" in lines[0] and "gradcam.png" in lines[1]
    assert "attention_map_blocks_" in lines[2]
    assert "loss_curve.png" in lines[3]
    assert csv_path.exists() and tex_path.exists()
    assert not any(p.suffix in (".png", ".pdf") for p in tmp_path.rglob("*"))


def _tiny_sets(tmp_path: Path) -> list:
    return ["model.img_size=32", "model.patch_size=8", "model.embed_dim=32",
            "model.depth=2", "model.num_heads=2", "model.graph.k=4",
            "data.image_size=32", "data.batch_size=8",
            "data.synthetic_size=32", "data.num_workers=0",
            "training.epochs=2", "training.warmup_epochs=1",
            f"paths.save_dir={tmp_path / 'ckpt'}",
            f"paths.log_dir={tmp_path / 'logs'}", "wandb.mode=disabled"]


def test_clis_write_the_jax_scripts_figures(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT / "scripts"))
    import evaluate_torch
    import gradcam_torch
    import train_torch

    ci = MetricCalculator.calculate_confidence_intervals
    monkeypatch.setattr(
        MetricCalculator, "calculate_confidence_intervals",
        lambda self, t, p, **kw: ci(self, t, p, n_bootstrap=20, **kw))
    config = tmp_path / "tiny.yaml"
    config.write_text((ROOT / "configs" / "vit_b16_graph2.yaml").read_text())
    sets = [a for kv in _tiny_sets(tmp_path) for a in ("--set", kv)]
    train_torch.main(["--config", str(config), "--synthetic", "--device",
                      "cpu", *sets])
    # scripts/train.py:226-240
    figures = tmp_path / "ckpt" / "figures"
    assert _files(figures) >= {
        "loss_curve.png", "auc_curves.png", "training_progress",
        "training_progress/training_progress.png",
        *(f"training_progress/{m}_progress.pdf"
          for m in ("loss", "auc", "ap", "f1"))}

    best = str(tmp_path / "ckpt" / "best_model")
    evaluate_torch.main(["--config", str(config), "--checkpoint", best,
                         "--dataset", "synthetic", "--device", "cpu", *sets])
    # scripts/evaluate.py:212-225
    evaluation = tmp_path / "ckpt" / "evaluation"
    assert _files(evaluation) >= {
        "evaluation_results.json", "roc_curves/roc_curves.pdf",
        "confusion_matrices/confusion_matrices.pdf", "performance.csv",
        "performance.tex"}
    assert "AUC-ROC CI" in (evaluation / "performance.csv").read_text()

    # scripts/gradcam.py on NIH-layout PNGs with a BBox list: two images
    # with 2 boxes each get an analysis figure
    rng = np.random.default_rng(0)
    val = tmp_path / "val"
    val.mkdir()
    lines = []
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (40, 40), np.uint8)).save(
            val / f"img_{i}.png")
        lines.append(f"img_{i}.png " + " ".join(
            str(int(v)) for v in rng.random(14) < 0.3))
    (val / "labels.txt").write_text("\n".join(lines) + "\n")
    bbox = tmp_path / "bbox.csv"
    bbox.write_text("Image Index,Finding Label,Bbox [x,y,w,h],,,\n"
                    + "".join(f"img_{i}.png,Nodule,{8 * b},{8 * b},16,16,\n"
                              for i in (1, 4) for b in (1, 2)))
    out = gradcam_torch.main([
        "--config", str(config), "--checkpoint", best, "--dataset", "nih",
        "--num-images", "4", "--out", str(tmp_path / "cams"), "--bbox-csv",
        str(bbox), "--bbox-source-size", "40", "--device", "cpu", *sets,
        "--set", f"data.val_dir={val}",
        "--set", f"data.val_labels={val / 'labels.txt'}"])
    names = _files(out)
    cams = {n for n in names if n.startswith("attention_maps/gradcam_")}
    assert cams and cams <= {f"attention_maps/gradcam_{d}.png"
                             for d in DISEASE_NAMES}
    dirs = {"roc_curves", "pr_curves", "confusion_matrices",
            "attention_maps", "error_analysis", "training_progress"}
    assert names == dirs | cams | {
        "attention_maps/attention_maps.png",
        "attention_maps/attention_map_blocks_0.pdf",
        "attention_maps/attention_map_blocks_1.pdf", "predictions.png",
        "analysis_img_1.png", "analysis_img_4.png"}
