"""The port's serving artifact with token merging and int8, on the CPU,
against ``tests/test_export.py``'s cases: ToMe, static int8 calibrated on
sample images (refused without them; the dead fp32 weight of every
quantised site left out), and int8 under a QAT checkpoint's scales, each
bit-equal to the port Predictor. At most 3 tests a file (see
``tests/test_torch_export.py``). One bucket of 4 each (5 images: a full
bucket and one padded): each export and load costs test time."""

import numpy as np
import pytest
import torch

from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.serving import (ExportedPredictor, Predictor,
                                     calibrate_act_scales, export_serving)
from gavit_tpu_torch.ops.preprocess import val_preprocess
from gavit_tpu_torch.utils import checkpoint as ckpt_lib
from gavit_tpu_torch.utils.convert import quant_sites
from test_torch_export import CFG, images

BUCKETS = (4,)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tome_artifact_round_trips(tmp_path):
    cfg = from_dict(CFG)
    export_serving(cfg, str(tmp_path / "art"), precision="fp32",
                   buckets=BUCKETS, tome_r=1, device="cpu")
    loaded = ExportedPredictor(str(tmp_path / "art"))
    assert loaded.manifest["tome_r"] == 1
    pred = Predictor(cfg, precision="fp32", device="cpu", buckets=BUCKETS,
                     tome_r=1)
    imgs = images(5, 4)
    assert np.array_equal(loaded.predict_proba(imgs),
                          pred.predict_proba(imgs))


def test_int8_artifact_from_calibration_images(tmp_path):
    cfg = from_dict(CFG)
    calib = images(8, 5)
    with pytest.raises(ValueError, match="calibration"):
        export_serving(cfg, str(tmp_path / "bad"), precision="int8",
                       buckets=BUCKETS, device="cpu")
    manifest = export_serving(cfg, str(tmp_path / "art"), precision="int8",
                              buckets=BUCKETS, device="cpu",
                              calibration_images=calib)
    pred = Predictor(cfg, precision="int8", device="cpu", buckets=BUCKETS)
    pred.calibrate(calib)
    sites = list(quant_sites(pred.model).values())
    assert all(m.w_q is not None for m in sites)
    names = manifest["treedef"]
    # every calibrated site ships w_q, w_scale and act_scale, never its
    # fp32 weight
    n_state = (sum(1 for _ in pred.model.parameters())
               + sum(1 for b in pred.model.buffers() if b is not None))
    assert manifest["n_weights"] == n_state - len(sites)
    assert sum(n.endswith(".w_q") for n in names) == len(sites)
    assert "int8" in manifest["leaf_dtypes"][names.index(
        next(n for n in names if n.endswith(".w_q")))]
    imgs = images(5, 6)
    assert np.array_equal(
        ExportedPredictor(str(tmp_path / "art")).predict_proba(imgs),
        pred.predict_proba(imgs))


def test_int8_artifact_from_a_qat_checkpoint(tmp_path):
    """A checkpoint holding QAT act scales (its ``quant`` entry) exports
    without calibration images, under those scales."""
    cfg = from_dict(CFG)
    model = init_params(build_model(cfg.model, qat=True),
                        torch.Generator().manual_seed(1))
    x = val_preprocess(torch.from_numpy(images(4, 7)))
    scales = calibrate_act_scales(model, x)
    ckpt_lib.save(str(tmp_path / "ckpt"),
                  {"model": model.state_dict(), "quant": scales}, {})
    export_serving(cfg, str(tmp_path / "art"),
                   checkpoint_path=str(tmp_path / "ckpt"), precision="int8",
                   buckets=BUCKETS, device="cpu")
    pred = Predictor(cfg, checkpoint_path=str(tmp_path / "ckpt"),
                     precision="int8", device="cpu", buckets=BUCKETS)
    assert pred.calibrated
    sites = quant_sites(pred.model)
    assert scales.keys() == sites.keys()
    for path, node in scales.items():
        assert torch.equal(sites[path].act_scale, node["act_scale"])
    imgs = images(5, 8)
    assert np.array_equal(
        ExportedPredictor(str(tmp_path / "art")).predict_proba(imgs),
        pred.predict_proba(imgs))
