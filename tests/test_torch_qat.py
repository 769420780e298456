"""Quantisation-aware training in the port against gavit_tpu's, fp32 on the
CPU at a tiny size (32 px, patch 8, embed 32, one block and a kNN graph
block after it with k 4 and its gate at 0.5, 2 heads), one torch thread.

* The QAT model in training mode at drop 0 on the JAX package's
  calibrated scales (``calibrate_act_scales``, carried over by
  ``quant_from_flax``): logits and every parameter's gradient within 1e-4
  of ``jax.value_and_grad`` of the JAX QAT model, with the fake-quantised
  codes that flip between the packages counted at every site and pinned
  to the JAX side's (``tests/test_torch_quant.py::site_codes``): an input
  1.9e-8 apart sat on a rounding boundary at one of 20,880 codes in a
  two-block model, and the flip moved the gradients downstream by ~1e-3.
  At most 2 may flip.
* Without scales the QAT model is the calibration pass: the plain model's
  logits within 1e-6, each site's absmax recorded.
* The contract QAT exists for (tests/test_qat.py:75): the deterministic
  QAT forward equals the int8 forward on ``export_quant``'s state, both in
  fp32, within 2e-4.
* ``Trainer.train()`` with ``training.qat`` over 2 epochs at drop 0
  against the JAX QAT Trainer (the JAX Trainer's eager calibration run
  under ``jax.jit``): the scales each calibrates within 1e-6
  relative, per-epoch train and val losses and val AUC within 1e-4. The
  images are integer-valued floats in [0, 4): both trainers calibrate on
  ``dataset[i][0]`` cast to uint8, and train on the floats as given (no
  augmentation drawn). Then the QAT checkpoint: restored into a fresh
  Trainer, its scales bit-equal (and ``has_quant`` in ``meta.json``);
  served by ``Predictor(checkpoint_path=..., precision='int8')`` under the
  trained scales, within 2e-2 (bf16 int8 model) of the QAT model's own
  probabilities; ``calibrate()`` keeps them, ``force=True`` replaces them
  (tests/test_qat.py:166).
"""

from __future__ import annotations

import json
import os

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gavit_tpu.serving
from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.data import DataLoader as JaxLoader
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.serving import calibrate_act_scales as jax_calibrate_act
from gavit_tpu.training import Trainer as JaxTrainer
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.data.dataset import (DISEASE_NAMES,
                                          class_weights_from_labels)
from gavit_tpu_torch.data.loader import DataLoader
from gavit_tpu_torch.ops.preprocess import val_preprocess
from gavit_tpu_torch.serving import Predictor, export_quant
from gavit_tpu_torch.training.trainer import Trainer
from gavit_tpu_torch.utils.convert import (flatten_tree, flax_layout,
                                           load_quant_state, quant_from_flax,
                                           quant_sites, to_flax_tree)
from tests.test_torch_quant import (TINY, images, jax_site_inputs,
                                    site_codes, tiny_model)

BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_scales(quant):
    flat = flatten_tree(jax.tree.map(np.asarray, quant["quant"]))
    return {k.rpartition("/")[0]: v for k, v in flat.items()}


def test_qat_model_matches_jax_fp32():
    model = tiny_model("fp32", qat=True)
    params = to_flax_tree(model)
    jmodel = jax_build_model(jax_from_dict(TINY).model, precision="fp32",
                             qat=True)
    calib = jnp.asarray(images(4, seed=7))
    scales = jax.jit(lambda p, x: jax_calibrate_act(jmodel, p, x))(params,
                                                                   calib)
    load_quant_state(model, quant_from_flax(jax.tree.map(np.asarray,
                                                         scales["quant"])))
    x = images(3, seed=2)
    gy = np.random.default_rng(4).standard_normal((3, 14)).astype(np.float32)

    def loss(p, x):
        logits, inputs = jax_site_inputs(
            jmodel, {"params": p, **scales}, x, deterministic=False,
            rngs={"dropout": jax.random.key(0)})
        return jnp.sum(logits * gy), (logits, inputs)

    (_, (want, inputs)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params, jnp.asarray(x))
    model.train()
    with site_codes(model, inputs, _flat_scales(scales), pin=True) as counts:
        got = model(torch.from_numpy(x))
    (got * torch.from_numpy(gy)).sum().backward()
    flips = sum(f for f, *_ in counts.values())
    assert len(counts) == len(inputs) and flips <= 2, counts
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    jgrads = flatten_tree(jax.tree.map(np.asarray, grads))
    for path, (p, transpose) in flax_layout(model).items():
        g = p.grad.numpy()
        np.testing.assert_allclose(g.T if transpose else g, jgrads[path],
                                   atol=1e-4, rtol=0, err_msg=path)


def test_qat_without_scales_is_the_calibration_pass():
    qat = tiny_model("fp32", qat=True)
    plain = tiny_model("fp32")
    x = torch.from_numpy(images(2, seed=3))
    with torch.no_grad():
        np.testing.assert_allclose(qat(x).numpy(), plain(x).numpy(),
                                   atol=1e-6, rtol=0)
    assert all(m.act_absmax is not None for m in quant_sites(qat).values())


def test_qat_forward_equals_int8_forward():
    model = tiny_model("fp32", qat=True)
    x = torch.from_numpy(images(2, seed=1))
    from gavit_tpu_torch.serving import calibrate_act_scales

    scales = calibrate_act_scales(model, x)
    load_quant_state(model, scales)
    with torch.no_grad():
        qat_out = model(x)
        model.set_quant("int8")  # the same fp32 compute dtype
        load_quant_state(model, export_quant(model, scales))
        int8_out = model(x)
    np.testing.assert_allclose(qat_out.numpy(), int8_out.numpy(), atol=2e-4,
                               rtol=0)


# --- the QAT Trainer ------------------------------------------------------


class IntDataset:
    """Integer-valued float32 images in [0, 4) (exact as uint8, which both
    trainers' calibration casts them to) and multi-label targets."""

    disease_names = DISEASE_NAMES

    def __init__(self, size, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 4, (size, 32, 32, 3)).astype(np.float32)
        self.labels = (rng.random((size, 14)) < 0.3).astype(np.float32)
        self.labels[0], self.labels[1] = 1.0, 0.0
        self.class_weights = class_weights_from_labels(self.labels)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]


def raw_cfg(tmp):
    return {**TINY, "data": {"batch_size": BATCH, "image_size": 32},
            "training": {"epochs": 2, "warmup_epochs": 1,
                         "learning_rate": 1e-3, "precision": "fp32",
                         "seed": 3, "qat": True, "log_every": 100,
                         "early_stopping_patience": 10},
            "paths": {"save_dir": str(tmp / "ckpt"),
                      "log_dir": str(tmp / "logs")},
            "mesh": {"data": 1}}
