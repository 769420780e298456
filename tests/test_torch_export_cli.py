"""The export CLI (``scripts/export_serving_torch.py``) run through its
``main()`` in-process on the CPU, the bf16 artifact it writes bit-equal to
the port Predictor, and ``scripts/serve_torch.py --artifact`` answering an
HTTP request from it (with the JAX CLI's rules: exactly one of
``--config`` / ``--artifact``, and no flag whose choice the export baked).
At most 3 tests a file (see ``tests/test_torch_export.py``)."""

import json
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.serving import ExportedPredictor, Predictor
from test_torch_export import BUCKETS, CFG, images

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import export_serving_torch  # noqa: E402
import serve_torch  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cli_artifact(tmp_path_factory):
    """The CLI's default precision (bf16) over the seeded weights, and the
    artifact loaded once for the tests that read it."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = tmp / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(CFG))
    out = tmp / "art"
    manifest = export_serving_torch.main([
        "--config", str(cfg), "--out", str(out), "--buckets", "1,4",
        "--device", "cpu"])
    return cfg, out, manifest, ExportedPredictor(str(out))


def test_export_cli_writes_the_artifact(cli_artifact):
    cfg, out, manifest, _ = cli_artifact
    assert json.loads((out / "manifest.json").read_text()) == manifest
    assert manifest["precision"] == "bf16" and manifest["buckets"] == [1, 4]
    assert sorted(p.name for p in out.glob("predict_b*.pt2")) == [
        "predict_b1.pt2", "predict_b4.pt2"]
    with pytest.raises(SystemExit):
        export_serving_torch.main(["--config", str(cfg), "--out",
                                   str(out / "x"), "--checkpoint", "c",
                                   "--weights", "w.npz"])


def test_bf16_artifact_round_trips(cli_artifact):
    """bf16 weights stored and read back as bf16; the probabilities equal
    the bf16 Predictor's on the same seeded weights bit for bit."""
    _, out, manifest, loaded = cli_artifact
    weights = torch.load(out / "weights.pt", weights_only=True)
    assert len(weights) == manifest["n_weights"]
    assert "torch.bfloat16" in manifest["leaf_dtypes"]
    for i, dtype in enumerate(manifest["leaf_dtypes"]):
        assert str(weights[str(i)].dtype) == dtype
    pred = Predictor(from_dict(CFG), precision="bf16", device="cpu",
                     buckets=BUCKETS)
    imgs = images(6, 9)
    assert np.array_equal(loaded.predict_proba(imgs),
                          pred.predict_proba(imgs))


def test_serve_cli_answers_from_the_artifact(cli_artifact):
    cfg, out, _, loaded = cli_artifact
    for bad in (["--artifact", str(out), "--config", str(cfg)], [],
                ["--artifact", str(out), "--precision", "int8"],
                ["--artifact", str(out), "--tome-r", "1"]):
        with pytest.raises(SystemExit):
            serve_torch.make_server(bad)
    server, batcher, desc = serve_torch.make_server(
        ["--artifact", str(out), "--port", "0"])
    assert batcher is None and desc == "custom (exported artifact)"
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              kwargs={"poll_interval": 0.05})
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        imgs = images(2, 10)
        req = urllib.request.Request(
            base + "/predict", data=json.dumps(imgs.tolist()).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            reply = json.loads(r.read())
        want = loaded.predict_proba(imgs)
        np.testing.assert_allclose(reply["probabilities"], want.round(5),
                                   atol=1e-6, rtol=0)
        assert len(reply["labels"]) == 2
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            assert json.loads(r.read())["count"] == 1
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
