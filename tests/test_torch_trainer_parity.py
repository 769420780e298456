"""The port's ``Trainer.train()`` against the JAX ``Trainer.train()`` over 2
epochs at ``grad_accum_steps`` 1 and 2 (fp32 on the CPU, the set-up of
``tests/test_torch_trainer_loop.py``: per-epoch train loss, val loss and
val ``mean_auc`` within 1e-4, the parameters within 1e-4 of each tensor's
largest value plus 1e-6; the JAX Trainer built once for the module, its
step rebuilt for accum 2), and ``scripts/evaluate_torch.py`` writing the
JAX script's keys on the synthetic set and on a PNG split.

At most 3 tests a file: with ``--dist loadfile`` pytest-xdist hands out
the files with the most tests first, so these slow tests run beside
``tests/test_evaluate_mesh.py`` instead of ahead of it.
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.data import DataLoader as JaxLoader
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.training import Trainer as JaxTrainer
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.utils.convert import flatten_tree, to_flax_tree

from test_torch_trainer_loop import (BATCH, ROOT, _uint8_sets, data,
                                     port_model, port_trainer, raw_cfg)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs(data, tmp_path_factory):
    """The JAX Trainer's 2-epoch runs at accum 1 and 2 (one Trainer; its
    step rebuilt for accum 2): per run the train and val histories and the
    final model parameters."""
    train_ds, val_ds = data
    tmp = tmp_path_factory.mktemp("jax")
    raw = raw_cfg(tmp)
    jcfg = jax_from_dict(raw)
    params = to_flax_tree(port_model(from_dict(raw)))

    def loaders():
        return (JaxLoader(train_ds, BATCH, shuffle=True, num_workers=1,
                          drop_last=True, seed=jcfg.training.seed),
                JaxLoader(val_ds, BATCH, num_workers=1))

    trainer = JaxTrainer(jax_build_model(jcfg.model, precision="fp32"),
                         params, *loaders(), jcfg)
    # the step donates the state: each run starts from a copy
    start = jax.tree.map(jnp.array, trainer.state)
    runs = {}
    for accum in (1, 2):
        cfg = jax_from_dict(raw_cfg(tmp / str(accum), accum))
        trainer.config = cfg
        trainer._train_step = trainer._build_train_step(False)
        trainer.train_loader, trainer.val_loader = loaders()
        trainer.state = jax.tree.map(jnp.array, start)
        trainer.start_epoch = 0
        trainer.best_val_auc, trainer.patience_counter = 0.0, 0
        trainer.train_metrics_history, trainer.val_metrics_history = [], []
        trainer.train()
        runs[accum] = (list(trainer.train_metrics_history),
                       list(trainer.val_metrics_history),
                       jax.tree.map(np.asarray, trainer.state.params["model"]))
    return runs


@pytest.mark.parametrize("accum", [1, 2])
def test_train_matches_jax_trainer(data, jax_runs, tmp_path, accum):
    train_ds, val_ds = data
    cfg = from_dict(raw_cfg(tmp_path, accum))
    trainer = port_trainer(cfg, train_ds, val_ds)
    result = trainer.train()
    jtrain, jval, jparams = jax_runs[accum]
    assert len(trainer.train_metrics_history) == len(jtrain) == 2
    for got, want in zip(trainer.train_metrics_history, jtrain):
        assert abs(got["loss"] - want["loss"]) <= 1e-4
    for got, want in zip(trainer.val_metrics_history, jval):
        assert abs(got["loss"] - want["loss"]) <= 1e-4
        assert abs(got["mean_auc"] - want["mean_auc"]) <= 1e-4
    assert result["best_val_auc"] == max(m["mean_auc"] for m in
                                         trainer.val_metrics_history)
    got = flatten_tree(to_flax_tree(trainer.model))
    want = flatten_tree(jparams)
    assert set(got) == set(want)
    for key, w in want.items():
        # + 1e-6: the key bias's gradient is zero but for fp32 noise, which
        # AdamW turns into steps of ~lr (5e-7 apart here)
        assert np.abs(got[key] - w).max() <= 1e-4 * np.abs(w).max() + 1e-6, \
            key
    assert not np.array_equal(got["head/kernel"], flatten_tree(to_flax_tree(
        port_model(cfg)))["head/kernel"])


def test_evaluate_cli_writes_the_jax_scripts_keys(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT / "scripts"))
    import evaluate_torch
    from gavit_tpu_torch.utils.metrics import MetricCalculator

    train_ds, val_ds = _uint8_sets()
    cfg = from_dict(raw_cfg(tmp_path, epochs=1))
    port_trainer(cfg, train_ds, val_ds).train()
    ci = MetricCalculator.calculate_confidence_intervals
    monkeypatch.setattr(
        MetricCalculator, "calculate_confidence_intervals",
        lambda self, t, p, **kw: ci(self, t, p, n_bootstrap=20, **kw))
    import yaml

    config = tmp_path / "tiny.yaml"
    config.write_text(yaml.safe_dump(raw_cfg(tmp_path, epochs=1)))
    res = evaluate_torch.main([
        "--config", str(config), "--checkpoint",
        str(tmp_path / "ckpt" / "best_model"), "--dataset", "synthetic",
        "--device", "cpu", "--calibration-frac", "0.25", "--set",
        "data.synthetic_size=20"])
    out = tmp_path / "ckpt" / "evaluation" / "evaluation_results.json"
    on_disk = json.loads(out.read_text())
    assert set(on_disk) == {
        "metrics", "optimal_thresholds", "optimal_thresholds_note",
        "metrics_at_optimal_thresholds", "confidence_intervals",
        "error_analysis", "p50_single_image_latency_ms", "batch_latency_ms",
        "calibration", "metrics_at_calibrated_thresholds"}
    assert np.isfinite(on_disk["metrics"]["mean_auc"])
    assert on_disk["p50_single_image_latency_ms"] > 0
    assert res["metrics"] == on_disk["metrics"]
    # --dataset nih: the PNG split of data.val_dir and data.val_labels
    from PIL import Image

    rng = np.random.default_rng(0)
    lines = []
    for i in range(10):
        Image.fromarray(rng.integers(0, 256, (40, 40), np.uint8)).save(
            tmp_path / f"{i}.png")
        row = np.full(14, float(i % 2))
        lines.append(f"{i}.png " + " ".join(f"{v:.0f}" for v in row))
    (tmp_path / "val.txt").write_text("\n".join(lines) + "\n")
    res = evaluate_torch.main([
        "--config", str(config), "--checkpoint",
        str(tmp_path / "ckpt" / "best_model"), "--dataset", "nih",
        "--device", "cpu", "--set", f"data.val_dir={tmp_path}", "--set",
        f"data.val_labels={tmp_path / 'val.txt'}"])
    on_disk = json.loads(out.read_text())
    assert np.isfinite(on_disk["metrics"]["mean_auc"])
    assert res["metrics"] == on_disk["metrics"]
    assert "calibration" not in on_disk
