"""The port's isolation from JAX, in fresh interpreters: nothing of jax,
flax or gavit_tpu loads while the package, its CLIs and a tiny run of each
are driven; and chip_smoke.py refuses to run without a card. Each test is
one subprocess, so this file holds few tests: with ``--dist loadfile``
pytest-xdist hands out the files with the most tests first, and a file of
3 or fewer runs beside ``tests/test_evaluate_mesh.py`` instead of ahead of
it."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


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
    behind a MicroBatcher; the export CLI's artifact of that config,
    served by ``ExportedPredictor`` and ``serve_torch.py --artifact``'s
    server; then MAE pretraining through its CLI, the
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
        f"export = runpy.run_path({str(ROOT / 'scripts' / 'export_serving_torch.py')!r})\n"
        f"art = {str(tmp_path / 'artifact')!r}\n"
        "export['main'](['--config', 'configs/vit_b16_graph2.yaml', "
        f"'--out', art, '--buckets', '2', '--device', 'cpu', *{tiny!r}])\n"
        "server, _, _ = serve['make_server'](['--artifact', art, '--port', "
        "'0'])\n"
        "server.server_close()\n"
        "assert gavit_tpu_torch.serving.ExportedPredictor(art).predict_proba("
        "np.zeros((3, 32, 32, 3), np.uint8)).shape == (3, 14)\n"
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
