"""The port's serving artifact (``serving.py::export_serving`` and
``ExportedPredictor``) on the CPU, against ``tests/test_export.py``'s cases:
the fp32 artifact's probabilities equal the port Predictor's bit for bit
(a padded bucket and chunks past the top one) and the JAX Predictor's on
the same weights within 1e-4 (fp32 on both sides, summation order only),
and the dense-engine MoE model round-trips.

At most 3 tests a file: with ``--dist loadfile`` pytest-xdist hands out the
files with the most tests first, so a file of 3 or fewer runs beside
``tests/test_evaluate_mesh.py`` instead of ahead of it."""

import json

import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.serving import Predictor as JaxPredictor
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.serving import (EXPORT_FORMAT, ExportedPredictor,
                                     Predictor, export_serving)
from gavit_tpu_torch.utils.convert import to_flax_tree

# tests/test_export.py's model, its graph block placed after block 0 (the
# even spread puts one block of a depth-1 model after block -1, where it
# never runs)
CFG = {
    "model": {"name": "custom", "img_size": 16, "patch_size": 8,
              "embed_dim": 32, "depth": 1, "num_heads": 2,
              "num_classes": 14,
              "graph": {"enabled": True, "num_blocks": 1,
                        "insert_after": [0], "adjacency": "knn", "k": 2,
                        "dynamic": True}},
    "data": {"image_size": 16},
}
BUCKETS = (1, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 16, 16, 3),
                                                np.uint8)


@pytest.fixture(scope="module")
def fp32_artifact(tmp_path_factory):
    """Seeded weights with nonzero graph gates (so the graph branch reaches
    the probabilities), in the Flax layout, exported in fp32; the artifact
    loaded once for the tests that read it."""
    model = init_params(build_model(from_dict(CFG).model),
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        for gb in model.graphs:
            gb.gate.fill_(0.5)
    params = to_flax_tree(model)
    out = tmp_path_factory.mktemp("fp32") / "art"
    manifest = export_serving(from_dict(CFG), str(out), weights=params,
                              precision="fp32", buckets=BUCKETS,
                              device="cpu")
    return params, out, manifest, ExportedPredictor(str(out))


def test_artifact_equals_the_predictor_bit_for_bit(fp32_artifact):
    """3 images pad to bucket 4, 9 run as 4 + 4 + 1; the manifest carries
    the JAX manifest's fields, the port's format, device and torch
    version; labels and latency as the Predictor's."""
    params, out, manifest, loaded = fp32_artifact
    assert {p.name for p in out.iterdir()} == {
        "manifest.json", "predict_b1.pt2", "predict_b4.pt2", "weights.pt"}
    assert json.loads((out / "manifest.json").read_text()) == manifest
    assert manifest["format"] == EXPORT_FORMAT
    assert manifest["device"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert manifest["buckets"] == list(BUCKETS)
    assert (manifest["image_size"], manifest["num_classes"]) == (16, 14)
    assert manifest["n_weights"] == len(manifest["treedef"]) == len(
        manifest["leaf_dtypes"])
    pred = Predictor(from_dict(CFG), params, precision="fp32", device="cpu",
                     buckets=BUCKETS)
    served = loaded.latency_stats().get("count", 0)
    for n, seed in ((3, 0), (9, 1)):
        imgs = images(n, seed)
        want = pred.predict_proba(imgs)
        got = loaded.predict_proba(imgs)
        assert got.dtype == np.float32 and got.shape == (n, 14)
        assert np.array_equal(got, want)
    assert loaded.disease_names == pred.disease_names
    assert loaded.predict_labels(imgs[:2], 0.0) == [pred.disease_names] * 2
    assert loaded.latency_stats()["count"] == served + 3
    with pytest.raises(ValueError, match="exported on cpu"):
        ExportedPredictor(str(out), device="cuda")


def test_artifact_matches_the_jax_predictor(fp32_artifact):
    """The same weights through the JAX Predictor (jitted, fp32)."""
    params, _, _, loaded = fp32_artifact
    jp = JaxPredictor(jax_from_dict(CFG), precision="fp32", params=params,
                      buckets=BUCKETS)
    imgs = images(4, 2)  # one bucket: one JAX compile
    np.testing.assert_allclose(loaded.predict_proba(imgs),
                               jp.predict_proba(imgs), atol=1e-4, rtol=0)


def test_dense_engine_moe_artifact_round_trips(tmp_path):
    """The MoE model of tests/test_export.py on the dense engine (the
    grouped engine's plain versions read the host: its CPU export raises,
    naming ROADMAP item 15)."""
    moe = {"model": {**CFG["model"],
                     "moe": {"enabled": True, "num_experts": 4, "k": 2,
                             "every": 1, "impl": "dense"}},
           "data": {"image_size": 16}}
    cfg = from_dict(moe)
    export_serving(cfg, str(tmp_path / "art"), precision="fp32",
                   buckets=(4,), device="cpu")
    pred = Predictor(cfg, precision="fp32", device="cpu", buckets=(4,))
    assert pred.model.blocks[0].moe is not None
    imgs = images(5, 3)
    assert np.array_equal(
        ExportedPredictor(str(tmp_path / "art")).predict_proba(imgs),
        pred.predict_proba(imgs))
    grouped = from_dict({**moe, "model": {**moe["model"], "moe": {
        **moe["model"]["moe"], "impl": "grouped"}}})
    with pytest.raises(ValueError, match="item 15"):
        export_serving(grouped, str(tmp_path / "grouped"), precision="fp32",
                       buckets=(1,), device="cpu")
