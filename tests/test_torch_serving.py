"""The port's serving layer: Predictor against gavit_tpu.serving.Predictor on
the same weights and uint8 images (fp32 on the CPU, within 1e-4: fp32 on both
sides, summation order only), the image size taken from the config,
preprocessing, validation and bucketing
against the JAX package's, and the HTTP handler of scripts/serve_torch.py
in-process (the port's isolation from JAX: tests/test_torch_isolation.py)."""

import io
import json
import sys
import threading
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu import serving as jax_serving
from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.data.dataset import DISEASE_NAMES
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu.ops.preprocess import val_preprocess as jax_val_preprocess
from gavit_tpu.serving import Predictor as JaxPredictor
from gavit_tpu_torch import serving
from gavit_tpu_torch.ops.preprocess import val_preprocess
from gavit_tpu_torch.serving import Predictor
from gavit_tpu_torch.utils.convert import to_flax_tree

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import serve_torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = {
    "model": {"name": "custom", "img_size": 32, "patch_size": 8,
              "embed_dim": 64, "depth": 4, "num_heads": 4, "num_classes": 14,
              "graph": {"enabled": True, "num_blocks": 2, "adjacency": "knn",
                        "k": 4}},
    "data": {"image_size": 32},
}


def tiny_cfg():
    return from_dict(TINY)


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                np.uint8)


def test_val_preprocess_matches_jax():
    imgs = _images(2)
    want = np.asarray(jax_val_preprocess(jnp.asarray(imgs)))
    got = val_preprocess(torch.from_numpy(imgs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_predictor_matches_jax_predictor():
    """3 images pad to bucket 8 on both sides; the graph gates are nonzero
    so the graph branch reaches the probabilities. The weights are the
    port's seeded ones in the Flax layout, handed to both Predictors (the
    JAX one jits its forward)."""
    model = init_params(build_model(tiny_cfg().model),
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        for gb in model.graphs:
            gb.gate.fill_(0.5)
    params = to_flax_tree(model)
    jp = JaxPredictor(jax_from_dict(TINY), precision="fp32", params=params)
    pred = Predictor(tiny_cfg(), params, precision="fp32", device="cpu")
    imgs = _images(3, seed=1)
    want = jp.predict_proba(imgs)
    got = pred.predict_proba(imgs)
    assert got.shape == (3, 14) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert pred.latency_stats()["count"] == 1
    assert pred.disease_names == list(DISEASE_NAMES)


def test_predictor_takes_the_config_image_size():
    """A learned-static model at 48 px (9 patches of 16): the Predictor
    validates and buckets images of the config's size, refuses others,
    and keeps the adjacency logits in fp32 while the rest is cast."""
    raw = {"model": {"name": "custom", "img_size": 48, "patch_size": 16,
                     "embed_dim": 64, "depth": 2, "num_heads": 2,
                     "num_classes": 14,
                     "graph": {"enabled": True, "num_blocks": 1,
                               "adjacency": "learned_static"}},
           "data": {"image_size": 48}}
    pred = Predictor(from_dict(raw), precision="bf16", device="cpu",
                     buckets=(1, 4))
    assert pred.model.graphs[0].adj_logits.dtype == torch.float32
    assert pred.model.head.weight.dtype == torch.bfloat16
    imgs = np.random.default_rng(4).integers(0, 256, (5, 48, 48, 3),
                                             np.uint8)
    probs = pred.predict_proba(imgs)
    assert probs.shape == (5, 14) and np.isfinite(probs).all()
    with pytest.raises(ValueError, match="48, 48, 3"):
        pred.predict_proba(_images(1))


@pytest.mark.parametrize("shape", [(32, 32, 3), (2, 32, 32, 3),
                                   (2, 16, 16, 3), (2, 32, 32, 1), (32, 32)])
def test_validate_images_matches_jax(shape):
    """The same uint8 arrays come back, or both sides raise."""
    imgs = np.arange(np.prod(shape), dtype=np.int64).reshape(shape) % 256
    try:
        want = jax_serving.validate_images(imgs, 32)
    except ValueError:
        with pytest.raises(ValueError, match="expected images"):
            serving.validate_images(imgs, 32)
        return
    got = serving.validate_images(imgs, 32)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_bucketed_predict_matches_jax(n):
    """Both sides pad each chunk to the same bucket, chunk past the top one
    and slice the pads off: the calls see the same arrays."""
    imgs = _images(n, seed=n)
    seen = {"port": [], "jax": []}

    def call(side):
        def run(chunk):
            seen[side].append(chunk.copy())
            return chunk.reshape(len(chunk), -1)[:, :5].astype(np.float32)
        return run

    buckets = (1, 4, 8)
    got = serving._bucketed_predict(imgs, buckets, 32, call("port"))
    want = jax_serving._bucketed_predict(imgs, buckets, 32, call("jax"))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n, 5)
    assert [c.shape[0] for c in seen["port"]] == \
        [c.shape[0] for c in seen["jax"]]
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)


def test_predictor_buckets_and_labels():
    pred = Predictor(tiny_cfg(), device="cpu", buckets=(1, 4))
    imgs = _images(6, seed=2)
    probs = pred.predict_proba(imgs)  # chunks 4 + 2 (padded to 4)
    assert probs.shape == (6, 14)
    np.testing.assert_allclose(probs[4:], pred.predict_proba(imgs[4:]),
                               atol=1e-6)
    np.testing.assert_allclose(pred.predict_proba(imgs[0])[0], probs[0],
                               atol=1e-6)
    assert pred.labels_from_probs(probs[:1], 0.0)[0] == pred.disease_names
    with pytest.raises(ValueError, match="expected images"):
        pred.predict_proba(np.zeros((1, 16, 16, 3), np.uint8))


@pytest.mark.parametrize("threshold", [0.0, 1.1])
def test_predict_labels_thresholds(threshold):
    """``predict_labels`` as the JAX Predictor's (tests/test_serving.py):
    every disease at 0.0, none at 1.1."""
    pred = Predictor(tiny_cfg(), device="cpu", buckets=(1, 4))
    labels = pred.predict_labels(_images(3, seed=5), threshold=threshold)
    assert labels == [pred.disease_names if threshold < 1 else []] * 3
    assert pred.latency_stats()["count"] == 1


def test_predictor_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(tiny_cfg(), device="cuda")


def test_http_handler_healthz_and_predict():
    pred = Predictor(tiny_cfg(), device="cpu", buckets=(1, 8))
    server = serve_torch.GavitHTTPServer(
        ("127.0.0.1", 0),
        serve_torch.build_handler(pred, 32, serve_torch.model_desc(
            tiny_cfg())))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"status": "ok", "model": "custom+graph2",
                          "image_size": 32}
        imgs = _images(2, seed=3)
        req = urllib.request.Request(
            base + "/predict", data=json.dumps(imgs.tolist()).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        np.testing.assert_allclose(out["probabilities"],
                                   pred.predict_proba(imgs), atol=1e-5)
        assert len(out["labels"]) == 2 and len(out["disease_names"]) == 14

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(imgs[0]).save(buf, format="PNG")
        req = urllib.request.Request(base + "/predict", data=buf.getvalue(),
                                     headers={"Content-Type": "image/png"})
        with urllib.request.urlopen(req, timeout=30) as r:
            png = json.loads(r.read())
        np.testing.assert_allclose(png["probabilities"][0],
                                   out["probabilities"][0], atol=1e-5)
        bad = urllib.request.Request(
            base + "/predict", data=b"[1, 2, 3]",
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
