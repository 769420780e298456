"""The port's training loop against the JAX package's, and on its own, fp32
on the CPU at a tiny size (32 px, patch 8, embed 32, depth 2, 2 heads, one
kNN graph block with k=4 and its gate at 0.5).

* ``Trainer.train()`` against the JAX ``Trainer.train()`` over 2 epochs
  with ``grad_accum_steps`` 1 and 2: pre-normalised float images (neither
  trainer draws augmentation), drop 0 (the two packages' masks differ), the
  same weights (the port's initialiser through ``to_flax_tree``), the same
  seeded loader order, a ragged val tail; per-epoch train loss, val loss
  and val ``mean_auc`` within 1e-4, the parameters within 1e-4 of each
  tensor's largest value plus 1e-6 (the key bias: its gradient is zero but
  for fp32 noise, which AdamW scales to steps of ~lr). The JAX Trainer is built once for the module
  and its step rebuilt for accum 2.
* accum 2 against accum 1 on one batch, within 1e-5;
* exact resume (stop after epoch 1, ``restore_checkpoint`` into a fresh
  Trainer) and ``steps_per_call=2`` against 1, both ``torch.equal`` on
  every parameter, the λ and both AdamW moments, with dropout 0.1 and the
  uint8 augmentation on;
* early stopping, best and periodic checkpoint names as
  ``checkpoint_name`` gives them, and a pre-armed preemption handler
  (a mid-epoch save marked incomplete, resumed on the next unseen batch);
* ``scripts/evaluate_torch.py`` writing the JAX script's keys, on the
  synthetic set and on a PNG split (``--dataset nih``);
* the 12-step loss trajectory of ``Trainer.train_step`` against
  ``tests/torch_ref.py::TorchRefTrainer`` (the reference's update rule),
  as tests/test_trajectory_parity.py runs it for the JAX Trainer.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

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
from gavit_tpu_torch.data.dataset import (DISEASE_NAMES,
                                          SyntheticChestXrayDataset,
                                          class_weights_from_labels)
from gavit_tpu_torch.data.loader import DataLoader
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.training.trainer import Trainer
from gavit_tpu_torch.utils import checkpoint as ckpt_lib
from gavit_tpu_torch.utils.convert import flatten_tree, to_flax_tree
from gavit_tpu_torch.utils.preemption import PreemptionHandler

ROOT = Path(__file__).resolve().parents[1]
BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny steps: more only spin against the
    other test workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FloatDataset:
    """Pre-normalised float32 images (no augmentation is drawn for them)
    and multi-label targets from a seed."""

    disease_names = DISEASE_NAMES

    def __init__(self, size, seed, image_size=32):
        rng = np.random.default_rng(seed)
        self.images = rng.standard_normal(
            (size, image_size, image_size, 3)).astype(np.float32)
        self.labels = (rng.random((size, 14)) < 0.3).astype(np.float32)
        self.labels[0] = 1.0
        self.labels[1] = 0.0
        self.class_weights = class_weights_from_labels(self.labels)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]


def raw_cfg(tmp, accum=1, epochs=2, drop=0.0, **training):
    return {
        "model": {"name": "custom", "img_size": 32, "patch_size": 8,
                  "embed_dim": 32, "depth": 2, "num_heads": 2,
                  "num_classes": 14, "drop_rate": drop,
                  "graph": {"enabled": True, "num_blocks": 1,
                            "adjacency": "knn", "k": 4}},
        "data": {"batch_size": BATCH, "image_size": 32},
        "training": {"epochs": epochs, "warmup_epochs": 1,
                     "learning_rate": 1e-3, "precision": "fp32",
                     "grad_accum_steps": accum, "seed": 3,
                     "early_stopping_patience": 10, **training},
        "paths": {"save_dir": str(tmp / "ckpt"), "log_dir": str(tmp / "logs")},
        "mesh": {"data": 1},
    }


def port_model(cfg):
    model = init_params(build_model(cfg.model, precision="fp32"),
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.graphs[0].gate.fill_(0.5)
    return model


def port_trainer(cfg, train_ds, val_ds):
    tl = DataLoader(train_ds, BATCH, shuffle=True, drop_last=True,
                    seed=cfg.training.seed)
    vl = DataLoader(val_ds, BATCH)
    return Trainer(cfg, port_model(cfg), train_ds.class_weights, len(tl),
                   device="cpu", train_loader=tl, val_loader=vl)


@pytest.fixture(scope="module")
def data():
    return FloatDataset(32, 0), FloatDataset(20, 1)


def test_accumulation_matches_the_full_batch(data, tmp_path):
    """accum 2 and 4 take the step accum 1 takes on the same batch (drop
    0): loss, components and every parameter within 1e-5."""
    train_ds, _ = data
    images = torch.from_numpy(train_ds.images[:BATCH])
    labels = torch.from_numpy(train_ds.labels[:BATCH])
    out = {}
    for accum in (1, 2, 4):
        cfg = from_dict(raw_cfg(tmp_path, accum, log_grad_norm=True))
        tr = Trainer(cfg, port_model(cfg), train_ds.class_weights, 4,
                     device="cpu")
        tr.train_step(images, labels)
        m = tr.train_step(images, labels)
        out[accum] = (m, [p.detach().clone() for p in tr.model.parameters()])
    m1, p1 = out[1]
    for accum in (2, 4):
        m, p = out[accum]
        for key in ("loss", "wbce", "focal", "asl", "grad_norm"):
            assert abs(m[key].item() - m1[key].item()) <= 1e-5, key
        for a, b in zip(p, p1):
            assert (a - b).abs().max().item() <= 1e-5
    with pytest.raises(ValueError, match="not divisible"):
        cfg = from_dict(raw_cfg(tmp_path, 3))
        Trainer(cfg, port_model(cfg), train_ds.class_weights, 4,
                device="cpu").train_step(images, labels)


def _state(trainer):
    params = [*trainer.model.parameters(), *trainer.criterion.parameters()]
    st = trainer.optimizer.state
    return [t.detach().clone() for p in params
            for t in (p, st[p]["exp_avg"], st[p]["exp_avg_sq"])]


def _uint8_sets():
    return (SyntheticChestXrayDataset(size=24, image_size=32, seed=3),
            SyntheticChestXrayDataset(size=12, image_size=32, seed=4))


def test_exact_resume_and_steps_per_call(tmp_path):
    """uint8 images (flip and jitter drawn), dropout 0.1, accum 2: the
    uninterrupted 2-epoch run, the same with steps_per_call 2, and a run
    stopped after epoch 1 and resumed in a fresh Trainer all end with the
    same bits."""
    train_ds, val_ds = _uint8_sets()
    runs = {}
    for name, spc in (("straight", 1), ("spc2", 2)):
        cfg = from_dict(raw_cfg(tmp_path / name, 2, drop=0.1,
                                steps_per_call=spc))
        tr = port_trainer(cfg, train_ds, val_ds)
        tr.train()
        runs[name] = (_state(tr), tr.step, tr.generator.get_state())
    # stopped after epoch 1: the straight run's own epoch-0 checkpoint,
    # resumed into a fresh Trainer that saves elsewhere
    [first] = [p for p in (tmp_path / "straight" / "ckpt").iterdir()
               if p.name.startswith("checkpoint_epoch_0_auc_")]
    cfg = from_dict(raw_cfg(tmp_path / "resumed", 2, drop=0.1))
    tr = port_trainer(cfg, train_ds, val_ds)
    tr.restore_checkpoint(first)
    assert tr.current_epoch == 1 and tr.step == 3
    tr.train()
    runs["resumed"] = (_state(tr), tr.step, tr.generator.get_state())
    want = runs["straight"]
    assert want[1] == 6
    for name in ("spc2", "resumed"):
        got = runs[name]
        assert got[1] == want[1] and torch.equal(got[2], want[2])
        assert all(torch.equal(a, b) for a, b in zip(got[0], want[0])), name


def test_early_stopping_and_checkpoint_names(tmp_path):
    """An unbeatable best AUC: no best checkpoint, patience runs out after
    one epoch; without validation, save_freq checkpoints named by
    checkpoint_name from the train metrics."""
    train_ds, val_ds = _uint8_sets()
    cfg = from_dict(raw_cfg(tmp_path / "a", epochs=5,
                            early_stopping_patience=1))
    tr = port_trainer(cfg, train_ds, val_ds)
    tr.best_val_auc = 2.0
    tr.train()
    assert len(tr.train_metrics_history) == 1 and tr.patience_counter == 1
    assert not os.path.exists(cfg.paths.save_dir) or not os.listdir(
        cfg.paths.save_dir)

    cfg = from_dict(raw_cfg(tmp_path / "b", epochs=3, eval_freq=3,
                            save_freq=1))
    tr = port_trainer(cfg, train_ds, val_ds)
    tr.train()
    names = sorted(os.listdir(cfg.paths.save_dir))
    want = sorted([ckpt_lib.checkpoint_name(e, tr.train_metrics_history[e][
        "mean_auc"]) for e in (0, 1)] + [ckpt_lib.checkpoint_name(
            2, tr.val_metrics_history[0]["mean_auc"]), "best_model"])
    assert names == want
    assert len(tr.val_metrics_history) == 1
    _, meta = ckpt_lib.restore(os.path.join(cfg.paths.save_dir,
                                            "best_model"))
    assert meta["epoch"] == 2 and meta["best_epoch"] == 2


def test_preempted_run_saves_an_incomplete_checkpoint(tmp_path):
    """A pre-armed handler: train() stops after the first step, saves a
    checkpoint marked incomplete, with the loader's position, and returns;
    resumed, it trains the rest of epoch 0 and then to the epoch count."""
    train_ds, val_ds = _uint8_sets()
    cfg = from_dict(raw_cfg(tmp_path, epochs=2))
    tr = port_trainer(cfg, train_ds, val_ds)
    handler = PreemptionHandler()
    handler._flag.set()
    tr._preemption = handler
    result = tr.train()
    assert isinstance(result, dict) and tr.step == 1
    assert not tr.train_metrics_history
    latest = ckpt_lib.latest_checkpoint(cfg.paths.save_dir)
    assert os.path.basename(latest) == ckpt_lib.checkpoint_name(0, 0.0)
    _, meta = ckpt_lib.restore(latest)
    assert meta["epoch_completed"] is False and meta["next_epoch"] == 0
    tr = port_trainer(cfg, train_ds, val_ds)
    tr.restore_checkpoint(latest)
    assert tr.current_epoch == 0 and tr.step == 1
    tr.train()
    assert len(tr.train_metrics_history) == 2 and tr.step == 3 + 3


def test_loss_trajectory_matches_the_reference_update_rule():
    """12 optimizer steps of the port's Trainer (warmup 10, so both schedule
    segments) against TorchRefTrainer on the same fixed fp32 batches, drop
    0, weights from the reference layout: losses within 1e-4 relative,
    parameters within 5e-5 + 1e-4 relative (the key bias, whose gradient is
    fp32 noise, within two AdamW steps a step), the λ within 1e-5."""
    from gavit_tpu_torch.utils.convert import load_flax_params
    from gavit_tpu_torch.utils.torch_convert import torch_state_dict_to_params
    from tests.torch_ref import (TorchRefCriterion, TorchRefTrainer,
                                 TorchRefViT, reference_state_dict)

    k, batch, img, patch, embed, depth, heads = 12, 8, 64, 16, 192, 2, 3
    lr, wd = 1e-3, 0.05
    rng = np.random.default_rng(0)
    images = rng.standard_normal((k, batch, img, img, 3)).astype(np.float32)
    targets = (rng.uniform(size=(k, batch, 14)) < 0.3).astype(np.float32)
    torch.manual_seed(0)
    tmodel = TorchRefViT(img_size=img, patch_size=patch, embed_dim=embed,
                         depth=depth, num_heads=heads, num_classes=14)
    cfg = from_dict({
        "model": {"name": "custom", "img_size": img, "patch_size": patch,
                  "embed_dim": embed, "depth": depth, "num_heads": heads,
                  "num_classes": 14, "drop_rate": 0.0,
                  "graph": {"enabled": False}},
        "data": {"batch_size": batch, "image_size": img},
        "training": {"epochs": 3, "warmup_epochs": 1, "learning_rate": lr,
                     "weight_decay": wd, "precision": "fp32"}})
    model = load_flax_params(build_model(cfg.model), torch_state_dict_to_params(
        reference_state_dict(tmodel), depth))
    pos_weight = SyntheticChestXrayDataset(size=80, image_size=img,
                                           seed=0).class_weights
    trainer = Trainer(cfg, model, pos_weight, 10, device="cpu")
    losses = [trainer.train_step(torch.from_numpy(images[i]),
                                 torch.from_numpy(targets[i]))["loss"].item()
              for i in range(k)]
    tcrit = TorchRefCriterion(torch.from_numpy(pos_weight))
    ref = TorchRefTrainer(tmodel, tcrit, lr=lr, weight_decay=wd,
                          max_grad_norm=1.0, warmup_steps=10, total_steps=30)
    t_losses = [ref.step(torch.from_numpy(images[i].transpose(0, 3, 1, 2))
                         .contiguous(), torch.from_numpy(targets[i]))
                for i in range(k)]
    np.testing.assert_allclose(losses, t_losses, rtol=1e-4, atol=1e-6)
    assert abs(losses[-1] - losses[0]) > 1e-5
    want = flatten_tree(torch_state_dict_to_params(
        reference_state_dict(tmodel), depth))
    got = flatten_tree(to_flax_tree(trainer.model))
    for key, w in want.items():
        d = np.abs(got[key] - w)
        if key.endswith("attn/qkv/bias"):
            # the key bias adds a per-row constant to the scores, which the
            # softmax cancels: its gradient is fp32 noise that AdamW turns
            # into steps of ~lr either way, on both sides alike
            keys = slice(embed, 2 * embed)
            assert (d[keys] <= 2 * lr * k).all(), key
            d[keys] = 0.0
        assert (d <= 5e-5 + 1e-4 * np.abs(w)).all(), key
    for name in ("lambda_wbce", "lambda_focal", "lambda_asl"):
        tv = float(getattr(tcrit, name).detach())
        assert tv != 1.0
        np.testing.assert_allclose(
            float(getattr(trainer.criterion, name).detach()), tv, rtol=1e-5,
            atol=1e-7)
