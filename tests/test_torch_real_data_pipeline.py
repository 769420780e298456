"""The port's file path end to end on the CPU, in-process through the CLIs'
``main``s at a tiny width (as ``tests/test_real_data_pipeline.py`` runs the
JAX scripts): a PNG corpus in the reference label format →
``scripts/prepare_dataset_torch.py`` → ``scripts/train_torch.py`` without
``--synthetic`` (the packed train split with RandomAffine and the
checkpointable loader, the PNG val split decoded on threads; then the PNG
split as the train split through the threaded loader, and ``--steps``
from the pack) → ``scripts/evaluate_torch.py --dataset nih`` and
``--dataset chexpert``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from gavit_tpu_torch.data.checkpointable import CheckpointableLoader
from gavit_tpu_torch.data.dataset import (ChestXrayDataset,
                                          PackedChestXrayDataset)
from gavit_tpu_torch.data.loader import DataLoader
from gavit_tpu_torch.utils.metrics import MetricCalculator

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_corpus(root: Path, n: int, size: int = 40, seed: int = 0):
    """Grayscale PNGs (as NIH's) and a label file whose classes are all
    two-valued."""
    img_dir = root / "images"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    labels = (rng.random((n, 14)) < 0.3).astype(np.float32)
    labels[0], labels[1] = 1.0, 0.0
    lines = []
    for i in range(n):
        name = f"img_{i:05d}.png"
        Image.fromarray(rng.integers(0, 256, (size, size), np.uint8)).save(
            img_dir / name)
        lines.append(name + " " + " ".join(f"{v:.0f}" for v in labels[i]))
    label_file = root / "train_list.txt"
    label_file.write_text("\n".join(lines) + "\n")
    return img_dir, label_file


def test_png_corpus_to_packed_to_train_to_evaluate(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT / "scripts"))
    import evaluate_torch
    import prepare_dataset_torch
    import train_torch

    ci = MetricCalculator.calculate_confidence_intervals
    monkeypatch.setattr(
        MetricCalculator, "calculate_confidence_intervals",
        lambda self, t, p, **kw: ci(self, t, p, n_bootstrap=20, **kw))
    img_dir, label_file = _make_corpus(tmp_path, n=24)
    packed_dir = tmp_path / "packed"
    prepare_dataset_torch.main([
        "--image-dir", str(img_dir), "--labels", str(label_file), "--out",
        str(packed_dir), "--image-size", "32", "--workers", "2"])

    sets = ["model.img_size=32", "model.patch_size=8", "model.embed_dim=32",
            "model.depth=1", "model.num_heads=2", "model.graph.k=4",
            "data.image_size=32", "data.batch_size=8", "data.num_workers=2",
            f"data.train_dir={packed_dir}", f"data.train_labels={label_file}",
            f"data.val_dir={img_dir}", f"data.val_labels={label_file}",
            f"data.chexpert_dir={img_dir}",
            f"data.chexpert_labels={label_file}",
            "training.epochs=2", "training.warmup_epochs=1",
            f"paths.save_dir={tmp_path / 'ckpt'}",
            f"paths.log_dir={tmp_path / 'logs'}", "wandb.mode=disabled"]

    def args(*extra):
        return ["--config", str(ROOT / "configs" / "vit_b16_graph2.yaml"),
                "--device", "cpu",
                *[a for kv in (*sets, *extra) for a in ("--set", kv)]]

    trainer = train_torch.main(args("data.augment_affine=true",
                                    "data.loader=grain"))
    assert isinstance(trainer.train_loader, CheckpointableLoader)
    assert isinstance(trainer.train_loader.dataset, PackedChestXrayDataset)
    assert isinstance(trainer.val_loader.dataset, ChestXrayDataset)
    assert trainer.val_loader.num_workers == 2
    assert trainer.use_affine and trainer.step == 2 * 3
    hist = trainer.train_metrics_history
    assert len(hist) == 2 and all(np.isfinite(m["loss"]) for m in hist)
    assert all(m["loader_wait_ms"] >= 0 for m in hist)
    assert (tmp_path / "ckpt" / "best_model" / "state.pt").is_file()

    for name in ("nih", "chexpert"):
        res = evaluate_torch.main([
            "--config", str(ROOT / "configs" / "vit_b16_graph2.yaml"),
            "--checkpoint", str(tmp_path / "ckpt" / "best_model"),
            "--dataset", name, "--device", "cpu",
            *[a for kv in sets for a in ("--set", kv)]])
        on_disk = json.loads((tmp_path / "ckpt" / "evaluation" /
                              "evaluation_results.json").read_text())
        auc = on_disk["metrics"]["mean_auc"]
        assert np.isfinite(auc) and 0.0 <= auc <= 1.0
        assert res["metrics"] == on_disk["metrics"]
        assert res["p50_single_image_latency_ms"] > 0

    # the PNG split as the train split, through the threaded loader
    raw = train_torch.main(args(f"data.train_dir={img_dir}",
                                f"paths.save_dir={tmp_path / 'raw'}",
                                "training.epochs=1"))
    assert type(raw.train_loader) is DataLoader
    assert isinstance(raw.train_loader.dataset, ChestXrayDataset)
    assert raw.step == 3 and np.isfinite(raw.train_metrics_history[0]["loss"])
    # --steps from the pack
    assert train_torch.main([*args(), "--steps", "2"]).step == 2
