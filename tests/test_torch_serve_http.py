"""The port's MicroBatcher and its serving CLI on the CPU.

* ``MicroBatcher``: concurrent submits coalesce into fewer predictor calls,
  each caller gets its own rows back in order, a request past the
  admission bound raises ``QueueFull`` while rows are pending, and an
  oversized one is admitted alone when nothing is; ``close`` flushes what
  was accepted.
* ``GET /metrics``: the names and kinds of ``scripts/serve_torch.py``'s
  exposition equal ``scripts/serve.py``'s on the same counters.
* ``scripts/serve_torch.py`` as a subprocess (``--device cpu``) on the
  best checkpoint of a tiny QAT run of ``scripts/train_torch.py``:
  ``--precision int8 --coalesce-ms 2 --max-queue-rows 64 --max-body-mb 4``
  answers ``/predict`` as the in-process int8 ``Predictor`` on that
  checkpoint does (the JSON's 5 decimals), serves ``/metrics`` and the
  ``microbatch`` block of ``/stats``, refuses a body past the limit with
  413 before reading it, sheds a request with 503 and ``Retry-After``
  while 256 rows are in flight, and on SIGTERM exits 0 after logging
  ``shutdown complete``. The same checkpoint in bf16 through the
  ``Predictor``. Every wait has its own timeout.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from gavit_tpu_torch import load_config
from gavit_tpu_torch.serving import MicroBatcher, Predictor, QueueFull

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


TINY = ["model.img_size=32", "model.patch_size=8", "model.embed_dim=32",
        "model.depth=2", "model.num_heads=2", "data.image_size=32"]


class SlowPredictor:
    """Rows back as their first pixel, after ``delay`` seconds a call."""

    image_size = 4
    buckets = (1, 8)

    def __init__(self, delay=0.05):
        self.delay, self.calls = delay, []

    def predict_proba(self, images):
        self.calls.append(len(images))
        time.sleep(self.delay)
        return images[:, 0, 0, :1].astype(np.float32)


def _img(v):
    return np.full((4, 4, 3), v, np.uint8)


def test_microbatcher_coalesces_in_order_and_sheds():
    pred = SlowPredictor()
    mb = MicroBatcher(pred, max_wait_ms=20, max_queue_rows=8)
    out = {}

    def submit(v):
        out[v] = mb.submit(_img(v))

    threads = [threading.Thread(target=submit, args=(v,)) for v in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert sorted(out) == list(range(6))
    for v, rows in out.items():
        np.testing.assert_array_equal(rows, [[v]])
    assert len(pred.calls) < 6 and sum(pred.calls) == 6
    stats = mb.stats()
    assert stats["rows"] == 6 and stats["coalesced_frac"] > 0

    # 8 rows in flight: one more is shed, alone it would be admitted
    big = threading.Thread(target=lambda: mb.submit(
        np.stack([_img(1)] * 8)))
    big.start()
    deadline = time.monotonic() + 10
    while mb.stats()["pending_rows"] < 8 and time.monotonic() < deadline:
        time.sleep(0.001)
    with pytest.raises(QueueFull, match="retry"):
        mb.submit(_img(2))
    big.join(timeout=10)
    assert mb.stats()["rejected"] == 1
    assert mb.submit(np.stack([_img(3)] * 12)).shape == (12, 1)
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(_img(4))


class _Stub:
    disease_names = ["a"]

    def latency_stats(self):
        return {"count": 3, "window": 3, "p50_ms": 1.0, "p95_ms": 2.0,
                "p99_ms": 2.0, "mean_ms": 1.5}

    def stats(self):
        return {"flushes": 2, "rows": 3, "mean_batch": 1.5, "max_batch": 2,
                "coalesced_frac": 0.5, "pending_rows": 0, "rejected": 1}


def _types(text):
    return sorted(line for line in text.splitlines()
                  if line.startswith("# TYPE"))


def test_metrics_names_match_the_jax_server():
    from scripts.serve import GavitHTTPServer, build_handler

    stub = _Stub()
    srv = GavitHTTPServer(("127.0.0.1", 0),
                          build_handler(stub, 4, "stub", batcher=stub))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/metrics"
        with urllib.request.urlopen(url, timeout=30) as r:
            want = r.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
    got = serve_torch.metrics_text(stub, stub)
    assert _types(got) == _types(want) and len(_types(got)) == 11
    assert got == want


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(url, body=None, timeout=60):
    req = urllib.request.Request(url, data=body, headers=(
        {"Content-Type": "application/json"} if body is not None else {}))
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    return raw if url.endswith("/metrics") else json.loads(raw)


@pytest.fixture(scope="module")
def qat_checkpoint(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    import train_torch

    sets = [a for s in TINY + [
        "data.batch_size=8", "data.synthetic_size=16", "training.epochs=1",
        "training.qat=true", f"paths.save_dir={tmp / 'ckpt'}",
        f"paths.log_dir={tmp / 'logs'}", "wandb.mode=disabled"]
        for a in ("--set", s)]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_torch.main(["--config", "configs/vit_b16_graph2.yaml",
                          "--synthetic", "--device", "cpu", *sets])
    finally:
        torch.set_num_threads(n)
    return tmp / "ckpt" / "best_model"


def test_serve_cli_on_a_qat_checkpoint(qat_checkpoint, tmp_path):
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    log = open(tmp_path / "serve.log", "w+")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "scripts" / "serve_torch.py"),
         "--config", "configs/vit_b16_graph2.yaml", "--checkpoint",
         str(qat_checkpoint), "--precision", "int8", "--coalesce-ms", "2",
         "--max-queue-rows", "64", "--max-body-mb", "4", "--device", "cpu",
         "--port", str(port), *[a for s in TINY for a in ("--set", s)]],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, env=env)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                health = _request(base + "/healthz", timeout=5)
                break
            except (urllib.error.URLError, ConnectionError):
                assert proc.poll() is None and time.monotonic() < deadline, \
                    (log.seek(0), log.read())
                time.sleep(0.2)
        assert health["image_size"] == 32

        cfg = load_config("configs/vit_b16_graph2.yaml", TINY)
        pred = Predictor(cfg, checkpoint_path=str(qat_checkpoint),
                         precision="int8", device="cpu")
        imgs = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                                 np.uint8)
        out = _request(base + "/predict", json.dumps(imgs.tolist()).encode())
        np.testing.assert_allclose(out["probabilities"],
                                   pred.predict_proba(imgs), atol=1e-5,
                                   rtol=0)
        bf16 = Predictor(cfg, checkpoint_path=str(qat_checkpoint),
                         precision="bf16", device="cpu")
        np.testing.assert_allclose(bf16.predict_proba(imgs),
                                   out["probabilities"], atol=5e-2, rtol=0)

        # 413: refused on the Content-Length, before any body is sent
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(5 << 20))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413 and b"--max-body-mb" in resp.read()
        conn.close()

        # 503: 256 rows in flight past the bound of 64
        big = json.dumps(np.zeros((256, 32, 32, 3), np.uint8).tolist())
        one = json.dumps(imgs[0].tolist()).encode()
        shed = None
        for _ in range(5):
            t = threading.Thread(target=_request, args=(
                base + "/predict", big.encode()))
            t.start()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and t.is_alive():
                if _request(base + "/stats")["microbatch"][
                        "pending_rows"] >= 256:
                    try:
                        _request(base + "/predict", one)
                    except urllib.error.HTTPError as e:
                        shed = e
                    break
                time.sleep(0.002)
            t.join(timeout=60)
            if shed is not None:
                break
        assert shed is not None and shed.code == 503
        assert shed.headers["Retry-After"] == "1"

        stats = _request(base + "/stats")
        assert stats["microbatch"]["rejected"] >= 1
        metrics = _request(base + "/metrics").decode()
        assert _types(metrics) == _types(serve_torch.metrics_text(
            _Stub(), _Stub()))

        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    log.seek(0)
    text = log.read()
    assert "int8 predictor using QAT-trained scales" in text
    assert "shutdown complete" in text
