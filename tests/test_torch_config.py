"""The port's own config reader and labels (gavit_tpu_torch.config,
gavit_tpu_torch.data.dataset) against the JAX package's: every YAML file in
``configs/`` gives equal dataclasses through both readers, with and without
``--set`` overrides, and the label list, class weights and synthetic
dataset are the same."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from gavit_tpu import config as jconfig
from gavit_tpu.data import dataset as jdata
from gavit_tpu_torch import config as tconfig
from gavit_tpu_torch.data import dataset as tdata


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs")
                 .rglob("*.yaml"))
OVERRIDES = [
    [],
    ["data.batch_size=128", "model.graph.k=4", "training.learning_rate=3e-4",
     "model.graph.insert_after=[1, 5]", "custom.new_key=7"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=["plain", "set"])
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_readers_agree(path, overrides):
    want = jconfig.load_config(str(path), overrides)
    got = tconfig.load_config(str(path), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_dict() == want.to_dict()
    assert got.model.graph_insert_after() == want.model.graph_insert_after()
    assert got.model.num_patches == want.model.num_patches


def test_presets_and_coercion_agree():
    raw = {"model": {"name": "vit_small_16", "depth": "6",
                     "drop_rate": "0.1", "qkv_bias": "false"},
           "training": {"learning_rate": "1e-3"}, "extra_top": {"a": 1}}
    want = jconfig.from_dict(raw)
    got = tconfig.from_dict(raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model.embed_dim == 384 and got.model.depth == 6
    with pytest.raises(ValueError, match="model.depth"):
        tconfig.from_dict({"model": {"depth": "many"}})


def test_labels_and_synthetic_dataset_agree():
    assert tdata.DISEASE_NAMES == jdata.DISEASE_NAMES
    assert tdata.NUM_CLASSES == jdata.NUM_CLASSES
    labels = np.random.default_rng(0).random((50, 14)) < 0.2
    labels[:, 3] = False
    np.testing.assert_array_equal(
        tdata.class_weights_from_labels(labels.astype(np.float32)),
        jdata.class_weights_from_labels(labels.astype(np.float32)))
    for learnable in (False, True):
        a = tdata.SyntheticChestXrayDataset(40, 32, seed=3,
                                            learnable=learnable)
        b = jdata.SyntheticChestXrayDataset(40, 32, seed=3,
                                            learnable=learnable)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.class_weights, b.class_weights)
        for i in (0, 7, 39):
            np.testing.assert_array_equal(a[i][0], b[i][0])
        imgs, lab = a.batch([1, 2, 39])
        assert imgs.shape == (3, 32, 32, 3) and imgs.dtype == np.uint8
        np.testing.assert_array_equal(imgs[2], b[39][0])
        np.testing.assert_array_equal(lab, b.labels[[1, 2, 39]])
