"""The port's serving layer: Predictor against gavit_tpu.serving.Predictor on
the same weights and uint8 images (fp32 on the CPU, within 1e-4: fp32 on both
sides, summation order only), the image size taken from the config,
preprocessing, validation and bucketing
against the JAX package's, the HTTP handler of scripts/serve_torch.py
in-process, and the port's isolation from JAX."""

import io
import json
import subprocess
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


def test_port_never_imports_jax(tmp_path):
    """Nothing of jax, flax or gavit_tpu loads while the port is imported
    and driven: the package, its serving and training modules, and the
    CLIs (the trainer takes one tiny step on the CPU), for the graph model
    (also at 512 px with remat, through the blockwise attention's and the
    chunked graph's plain paths) and for the MoE example: a trainer step on
    its grouped engine, and its Predictor behind the serving handler on the
    dense engine, which ``impl: auto`` picks at this size; then the epoch
    loop with accumulation and the static graph (validation, metrics,
    checkpoints), ``--resume auto`` for one more epoch, and the evaluate
    CLI on its best checkpoint; then the file path: PNGs packed by the
    port's packer, an epoch from the pack with RandomAffine through the
    checkpointable loader and the PNGs as the val split, and the evaluate
    CLI on them as ``--dataset nih``, and the Grad-CAM CLI on the same
    checkpoint and PNGs; then an epoch of QAT (``training.qat=true``) and
    the serve CLI's main on its best checkpoint with ``--precision int8
    --tome-r 1 --coalesce-ms 2 --max-queue-rows 8 --max-body-mb 1`` (a
    request and ``/metrics``, then SIGTERM), and its Predictor in bf16
    behind a MicroBatcher; then MAE pretraining through its CLI, the
    ``.pth`` it writes converted to the port's checkpoint and that to a
    reference-layout ``.npz``, both inspected, and an epoch of the train
    CLI under ``--profile``. matplotlib is hidden, as on the card's machine,
    so every figure is skipped with its log line
    (``tests/test_torch_visualization.py`` draws them)."""
    tiny = ["--set", "model.img_size=32", "--set", "model.patch_size=8",
            "--set", "model.embed_dim=64", "--set", "model.depth=2",
            "--set", "model.num_heads=2", "--set", "data.image_size=32",
            "--set", "data.batch_size=2", "--set", "data.synthetic_size=8"]
    moe = "configs/examples/vit_b16_moe.yaml"
    px512 = ["--set", "model.img_size=512", "--set", "model.patch_size=16",
             "--set", "model.embed_dim=32", "--set", "model.depth=1",
             "--set", "model.num_heads=2", "--set", "data.image_size=512",
             "--set", "data.batch_size=1", "--set", "data.synthetic_size=2",
             "--set", "model.remat=true"]
    code = (
        "import sys, runpy\n"
        "sys.modules['matplotlib'] = None  # absent, as on the card\n"
        "import numpy as np\n"
        "import torch\n"
        "torch.set_num_threads(1)  # tiny steps; other test workers share "
        "the cores\n"
        "import gavit_tpu_torch, gavit_tpu_torch.serving\n"
        "import gavit_tpu_torch.training.trainer\n"
        f"serve = runpy.run_path({str(ROOT / 'scripts' / 'serve_torch.py')!r})\n"
        f"train = runpy.run_path({str(ROOT / 'scripts' / 'train_torch.py')!r})\n"
        "for cfg, extra in (('configs/vit_b16_graph2.yaml', []), "
        f"({moe!r}, ['--set', 'model.moe.impl=grouped'])):\n"
        "    train['main'](['--config', cfg, "
        f"'--synthetic', '--steps', '1', '--device', 'cpu', *{tiny!r}, "
        "*extra])\n"
        "train['main'](['--config', 'configs/vit_b16_graph2.yaml', "
        f"'--synthetic', '--steps', '1', '--device', 'cpu', *{px512!r}])\n"
        "config = gavit_tpu_torch.load_config("
        f"{moe!r}, {tiny[1::2]!r})\n"
        "pred = gavit_tpu_torch.serving.Predictor(config, device='cpu', "
        "buckets=(1,))\n"
        "serve['build_handler'](pred, 32, serve['model_desc'](config))\n"
        "assert pred.predict_proba(np.zeros((1, 32, 32, 3), np.uint8))"
        ".shape == (1, 14)\n"
        f"evaluate = runpy.run_path({str(ROOT / 'scripts' / 'evaluate_torch.py')!r})\n"
        f"loop = [*{tiny!r}, '--set', 'data.batch_size=4', '--set', "
        "'training.grad_accum_steps=2', '--set', 'model.graph.dynamic=false', "
        f"'--set', 'paths.save_dir={tmp_path / 'ckpt'}', '--set', "
        f"'paths.log_dir={tmp_path / 'logs'}', '--synthetic', '--device', "
        "'cpu']\n"
        "first = train['main']([*loop, '--set', 'training.epochs=1'])\n"
        "again = train['main']([*loop, '--set', 'training.epochs=2', "
        "'--resume', 'auto'])\n"
        "assert first.step == 2 and again.step == 4, (first.step, again.step)\n"
        "import gavit_tpu_torch.utils.metrics as metrics\n"
        "ci = metrics.MetricCalculator.calculate_confidence_intervals\n"
        "metrics.MetricCalculator.calculate_confidence_intervals = (\n"
        "    lambda self, t, p, **kw: ci(self, t, p, n_bootstrap=10, **kw))\n"
        "res = evaluate['main'](['--config', 'configs/vit_b16_graph2.yaml', "
        f"'--checkpoint', '{tmp_path / 'ckpt' / 'best_model'}', "
        f"'--dataset', 'synthetic', '--device', 'cpu', *{tiny!r}, '--set', "
        f"'model.graph.dynamic=false', '--set', 'paths.save_dir={tmp_path}'])\n"
        "assert res['p50_single_image_latency_ms'] > 0\n"
        "from PIL import Image\n"
        f"png = {str(tmp_path / 'png')!r}\n"
        "import os; os.makedirs(png)\n"
        "rows = []\n"
        "for i in range(8):\n"
        "    Image.fromarray(np.full((40, 40), 30 * i, np.uint8)).save("
        "f'{png}/{i}.png')\n"
        "    rows.append(f'{i}.png ' + ' '.join([str(i % 2)] * 14))\n"
        "open(f'{png}/list.txt', 'w').write('\\n'.join(rows))\n"
        f"pack = runpy.run_path({str(ROOT / 'scripts' / 'prepare_dataset_torch.py')!r})\n"
        "pack['main'](['--image-dir', png, '--labels', f'{png}/list.txt', "
        f"'--out', {str(tmp_path / 'packed')!r}, '--image-size', '32'])\n"
        f"files = [*{tiny!r}, '--set', "
        f"'data.train_dir={tmp_path / 'packed'}', '--set', 'data.val_dir=' + png, "
        "'--set', f'data.val_labels={png}/list.txt', '--set', "
        "'data.augment_affine=true', '--set', 'data.loader=grain', '--set', "
        f"'paths.save_dir={tmp_path / 'files'}', '--device', 'cpu']\n"
        "tr = train['main'](['--config', 'configs/vit_b16_graph2.yaml', "
        "*files, '--set', 'training.epochs=1'])\n"
        "assert tr.step == 4, tr.step\n"
        "res = evaluate['main'](['--config', 'configs/vit_b16_graph2.yaml', "
        f"'--checkpoint', '{tmp_path / 'files' / 'best_model'}', "
        "'--dataset', 'nih', *files])\n"
        "assert np.isfinite(res['metrics']['mean_auc'])\n"
        f"gradcam = runpy.run_path({str(ROOT / 'scripts' / 'gradcam_torch.py')!r})\n"
        "gradcam['main'](['--config', 'configs/vit_b16_graph2.yaml', "
        f"'--checkpoint', '{tmp_path / 'files' / 'best_model'}', "
        "'--dataset', 'nih', '--num-images', '2', *files])\n"
        f"qat_dir = {str(tmp_path / 'qat')!r}\n"
        "qat = train['main'](['--config', 'configs/vit_b16_graph2.yaml', "
        f"'--synthetic', '--device', 'cpu', *{tiny!r}, '--set', "
        "'training.qat=true', '--set', 'training.epochs=1', '--set', "
        "f'paths.save_dir={qat_dir}', '--set', f'paths.log_dir={qat_dir}'])\n"
        "assert qat.quant\n"
        "import os, signal, socket, threading, urllib.request\n"
        "sock = socket.socket(); sock.bind(('127.0.0.1', 0))\n"
        "port = sock.getsockname()[1]; sock.close()\n"
        "def stop():\n"
        "    url = f'http://127.0.0.1:{port}'\n"
        "    for _ in range(600):\n"
        "        try:\n"
        "            urllib.request.urlopen(url + '/healthz', timeout=5)\n"
        "            break\n"
        "        except OSError:\n"
        "            time.sleep(0.1)\n"
        "    req = urllib.request.Request(url + '/predict', data=json.dumps("
        "np.zeros((32, 32, 3), int).tolist()).encode(), headers={"
        "'Content-Type': 'application/json'})\n"
        "    replies.append(json.loads(urllib.request.urlopen(req, "
        "timeout=60).read()))\n"
        "    replies.append(urllib.request.urlopen(url + '/metrics', "
        "timeout=60).read().decode())\n"
        "    os.kill(os.getpid(), signal.SIGTERM)\n"
        "import json, time\n"
        "replies = []\n"
        "threading.Thread(target=stop, daemon=True).start()\n"
        "serve['main'](['--config', 'configs/vit_b16_graph2.yaml', "
        "'--checkpoint', f'{qat_dir}/best_model', '--precision', 'int8', "
        "'--tome-r', '1', '--coalesce-ms', '2', '--max-queue-rows', '8', "
        "'--max-body-mb', '1', '--device', 'cpu', '--port', str(port), "
        f"*{tiny!r}])\n"
        "assert len(replies[0]['probabilities'][0]) == 14, replies\n"
        "assert 'gavit_microbatch_rejected_total' in replies[1]\n"
        "pred = gavit_tpu_torch.serving.Predictor(gavit_tpu_torch.load_config("
        f"'configs/vit_b16_graph2.yaml', {tiny[1::2]!r}), checkpoint_path="
        "f'{qat_dir}/best_model', precision='bf16', device='cpu', "
        "buckets=(1, 4))\n"
        "mb = gavit_tpu_torch.serving.MicroBatcher(pred, max_wait_ms=1)\n"
        "assert mb.submit(np.zeros((2, 32, 32, 3), np.uint8)).shape == "
        "(2, 14)\n"
        "mb.close()\n"
        f"mae_dir = {str(tmp_path / 'mae')!r}\n"
        f"pretrain = runpy.run_path({str(ROOT / 'scripts' / 'pretrain_mae_torch.py')!r})\n"
        "pth = pretrain['main'](['--config', 'configs/vit_b16_graph2.yaml', "
        f"'--synthetic', '--device', 'cpu', *{tiny!r}, '--set', "
        "'training.epochs=1', '--set', f'paths.save_dir={mae_dir}', "
        "'--decoder-dim', '32', '--decoder-depth', '1', '--decoder-heads', "
        "'2'])\n"
        f"convert = runpy.run_path({str(ROOT / 'scripts' / 'convert_checkpoint_torch.py')!r})\n"
        "convert['main'](['--to-jax', pth, f'{mae_dir}/port', '--config', "
        f"'configs/vit_b16_graph2.yaml', *{tiny!r}])\n"
        "convert['main'](['--to-torch', f'{mae_dir}/port', "
        "f'{mae_dir}/ref.npz'])\n"
        f"inspect = runpy.run_path({str(ROOT / 'scripts' / 'inspect_checkpoint_torch.py')!r})\n"
        "assert inspect['main']([f'{mae_dir}/port', '--stats']) > 0\n"
        "assert inspect['main']([f'{mae_dir}/ref.npz']) > 0\n"
        "train['main']([*loop, '--set', 'training.epochs=1', '--set', "
        "f'paths.save_dir={mae_dir}/profiled', '--profile', "
        "f'{mae_dir}/trace'])\n"
        "assert os.path.exists(f'{mae_dir}/trace/trace.json')\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'flax', 'gavit_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card it exits nonzero and prints no result; alone in a
    directory (no port beside it) it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_bytes((ROOT / "chip_smoke.py").read_bytes())
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
