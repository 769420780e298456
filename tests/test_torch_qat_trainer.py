"""The QAT Trainer against the JAX one over 2 epochs on the same weights,
data and loader order (act scales within 1e-6 relative, losses and
``mean_auc`` within 1e-4), and its checkpoint restored (scales bit-equal)
and served int8 by the Predictor under those scales. The set-up is
``tests/test_torch_qat.py``'s. At most 3 tests a file (see
``tests/test_torch_trainer_parity.py``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import gavit_tpu.serving
from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.data import DataLoader as JaxLoader
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.training import Trainer as JaxTrainer
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.data.loader import DataLoader
from gavit_tpu_torch.ops.preprocess import val_preprocess
from gavit_tpu_torch.serving import Predictor
from gavit_tpu_torch.training.trainer import Trainer
from gavit_tpu_torch.utils.convert import quant_sites, to_flax_tree

from test_torch_qat import BATCH, IntDataset, _flat_scales, raw_cfg
from tests.test_torch_quant import tiny_model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qat_runs(tmp_path_factory):
    """The JAX and the port QAT Trainers over 2 epochs on the same
    weights, data and loader order: (jax trainer, port trainer, config)."""
    tmp = tmp_path_factory.mktemp("qat")
    raw = raw_cfg(tmp)
    train_ds, val_ds = IntDataset(16, 0), IntDataset(16, 1)
    cfg = from_dict(raw)
    model = tiny_model("fp32", raw=raw)
    jcfg = jax_from_dict({**raw, "paths": {"save_dir": str(tmp / "jax"),
                                           "log_dir": str(tmp / "jlogs")}})
    calibrate = gavit_tpu.serving.calibrate_act_scales
    with pytest.MonkeyPatch.context() as mp:
        # the JAX Trainer calibrates eagerly (10 s of interpreted ops here):
        # the same function under jit
        mp.setattr(gavit_tpu.serving, "calibrate_act_scales",
                   lambda m, p, x: jax.jit(
                       lambda p, x: calibrate(m, p, x))(p, x))
        jt = JaxTrainer(jax_build_model(jcfg.model, precision="fp32"),
                        to_flax_tree(model),
                        JaxLoader(train_ds, BATCH, shuffle=True,
                                  num_workers=1, drop_last=True,
                                  seed=jcfg.training.seed),
                        JaxLoader(val_ds, BATCH, num_workers=1), jcfg)
    jt.train()
    tl = DataLoader(train_ds, BATCH, shuffle=True, drop_last=True,
                    seed=cfg.training.seed)
    pt = Trainer(cfg, model, train_ds.class_weights, len(tl), device="cpu",
                 train_loader=tl, val_loader=DataLoader(val_ds, BATCH))
    pt.train()
    return jt, pt, cfg, val_ds


def test_qat_trainer_matches_jax_trainer(qat_runs):
    jt, pt, _, _ = qat_runs
    want = _flat_scales(jt._quant)
    assert set(pt.quant) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(pt.quant[path]["act_scale"].numpy(), w,
                                   rtol=1e-6, err_msg=path)
    assert len(pt.train_metrics_history) == len(jt.train_metrics_history) == 2
    for got, w in zip(pt.train_metrics_history, jt.train_metrics_history):
        assert abs(got["loss"] - w["loss"]) <= 1e-4
    for got, w in zip(pt.val_metrics_history, jt.val_metrics_history):
        assert abs(got["loss"] - w["loss"]) <= 1e-4
        assert abs(got["mean_auc"] - w["mean_auc"]) <= 1e-4


def test_qat_checkpoint_restores_and_serves_int8(qat_runs):
    _, pt, cfg, val_ds = qat_runs
    best = os.path.join(cfg.paths.save_dir, "best_model")
    with open(os.path.join(best, "meta.json")) as f:
        assert json.load(f)["has_quant"] is True

    fresh = Trainer(cfg, tiny_model("fp32", raw=raw_cfg(Path("."))),
                    val_ds.class_weights, 4,
                    device="cpu", dataset=IntDataset(8, 5))
    assert fresh.quant  # its own calibration, on other images
    fresh.restore_checkpoint(best)
    assert fresh.quant.keys() == pt.quant.keys()
    for path, node in pt.quant.items():
        assert torch.equal(fresh.quant[path]["act_scale"],
                           node["act_scale"])
        assert torch.equal(quant_sites(fresh.model)[path].act_scale,
                           node["act_scale"])

    pred = Predictor(cfg, checkpoint_path=best, precision="int8",
                     device="cpu", buckets=(4,))
    assert pred.calibrated
    imgs = np.random.default_rng(6).integers(0, 256, (3, 32, 32, 3),
                                             np.uint8)
    fresh.model.eval()
    with torch.no_grad():
        want = torch.sigmoid(fresh.model(val_preprocess(
            torch.from_numpy(imgs)))).numpy()
    got = pred.predict_proba(imgs)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)

    served = {p: m.act_scale.clone()
              for p, m in quant_sites(pred.model).items()}
    pred.calibrate(imgs)  # refused: the trained scales stay
    for path, m in quant_sites(pred.model).items():
        assert torch.equal(m.act_scale, served[path])
    pred.calibrate(imgs, force=True)
    assert any(not torch.equal(m.act_scale, served[p])
               for p, m in quant_sites(pred.model).items())
