"""The port's pretrain → convert → fine-tune → inspect chain and its
utilities, on the CPU at a tiny size (img 32, patch 8, embed 32, depth 2,
decoder 32 × 1 × 2), in-process:

* ``scripts/pretrain_mae_torch.py`` for one epoch of two steps: its
  ``mae_epoch_0`` checkpoint (parameters and step) and the reference-layout
  ``.pth`` it writes from them;
* ``scripts/train_torch.py --set model.pretrained_path=<.pth>`` loading the
  encoder ("Loaded MAE pre-trained weights"), the head fresh;
* ``scripts/convert_checkpoint_torch.py`` in its three modes: ``--to-jax``
  (``.pth`` → the port's checkpoint, step 0 and a fresh criterion),
  ``--to-torch`` (checkpoint → reference-layout ``.npz``, the ``.pth``'s
  tensors again) and ``--upcycle-moe`` (a dense checkpoint of
  ``configs/examples/vit_b16_moe.yaml``'s model with MoE off → the MoE
  model, whose forward is the dense one's within 1e-5), with its two
  refusals;
* ``scripts/inspect_checkpoint_torch.py`` on each kind of file: a
  checkpoint directory, an MAE checkpoint, a ``.pth`` and an ``.npz``;
* ``utils/profiling.py`` (``nan_guard`` raising at a NaN in the forward and
  in the backward, ``trace``'s Chrome trace, ``percentile_latency``) and
  ``utils/custom_logging.py`` (the device inventory on the CPU, the log
  file).
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gavit_tpu_torch import load_config
from gavit_tpu_torch.models import mae
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.ops.preprocess import val_preprocess
from gavit_tpu_torch.utils import checkpoint as ckpt_lib
from gavit_tpu_torch.utils.custom_logging import (log_system_info,
                                                  setup_logging)
from gavit_tpu_torch.utils.profiling import (ThroughputMeter, nan_guard,
                                             percentile_latency, trace)
from gavit_tpu_torch.utils.torch_convert import load_mae_weights

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import convert_checkpoint_torch  # noqa: E402
import inspect_checkpoint_torch  # noqa: E402
import pretrain_mae_torch  # noqa: E402
import train_torch  # noqa: E402

CONFIG = str(ROOT / "configs" / "vit_b16_graph2.yaml")
MOE = str(ROOT / "configs" / "examples" / "vit_b16_moe.yaml")
TINY = ["model.img_size=32", "model.patch_size=8", "model.embed_dim=32",
        "model.depth=2", "model.num_heads=2", "data.image_size=32"]
DECODER = ["--decoder-dim", "32", "--decoder-depth", "1", "--decoder-heads",
           "2"]


def _sets(*items):
    return [a for item in items for a in ("--set", item)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """One epoch of two fp32 MAE steps through the CLI's main."""
    root = tmp_path_factory.mktemp("mae")
    torch.set_num_threads(1)
    out = pretrain_mae_torch.main([
        "--config", CONFIG, "--synthetic", "--device", "cpu", *DECODER,
        "--out", str(root / "mae.pth"), *_sets(
            *TINY, "data.batch_size=4", "data.synthetic_size=8",
            "training.epochs=1", "training.precision=fp32",
            f"paths.save_dir={root / 'ckpt'}")])
    return root, Path(out)


def test_pretrain_cli_writes_checkpoint_and_pth(pretrained):
    root, pth = pretrained
    state, meta = ckpt_lib.restore(str(root / "ckpt" / "mae_epoch_0"))
    assert state["step"] == 2 and set(state) == {"params", "step"}
    assert meta["epoch"] == 0 and np.isfinite(meta["loss"])
    assert (meta["decoder_dim"], meta["decoder_depth"],
            meta["decoder_heads"], meta["mask_ratio"]) == (32, 1, 2, 0.75)
    model = mae.build_mae(load_config(CONFIG, TINY).model, decoder_dim=32,
                          decoder_depth=1, decoder_heads=2)
    model.load_state_dict(state["params"])
    got = torch.load(pth, weights_only=True)["model"]
    want = mae.reference_state_dict(model)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_finetune_cli_loads_the_pth(pretrained, caplog):
    _, pth = pretrained
    caplog.set_level("INFO")
    trainer = train_torch.main([
        "--config", CONFIG, "--synthetic", "--steps", "0", "--device", "cpu",
        *_sets(*TINY, "data.batch_size=2", "data.synthetic_size=4",
               f"model.pretrained_path={pth}")])
    assert any("Loaded MAE pre-trained weights" in r.getMessage()
               for r in caplog.records)
    sd = torch.load(pth, weights_only=True)["model"]
    got = trainer.model.state_dict()
    for key, val in sd.items():
        if key == "patch_embed.proj.weight":  # the conv [D, C, p, p]
            val = val.reshape(val.shape[0], -1)
        assert torch.equal(got[key].cpu(), val), key


def test_convert_to_port_and_back(pretrained, tmp_path):
    _, pth = pretrained
    dst = tmp_path / "converted"
    convert_checkpoint_torch.main(["--to-jax", str(pth), str(dst), "--config",
                                   CONFIG, *_sets(*TINY)])
    state, meta = ckpt_lib.restore(str(dst))
    assert state["step"] == 0 and set(state) == {"step", "model",
                                                 "criterion"}
    assert meta["converted_from"] == str(pth) and "config" in meta
    assert all(float(v) == 1.0 for v in state["criterion"].values())
    want = init_params(build_model(load_config(CONFIG, TINY).model),
                       torch.Generator().manual_seed(
                           load_config(CONFIG, TINY).training.seed))
    load_mae_weights(want, str(pth))
    assert all(torch.equal(state["model"][k], v)
               for k, v in want.state_dict().items())

    npz = tmp_path / "ref.npz"
    convert_checkpoint_torch.main(["--to-torch", str(dst), str(npz)])
    sd = torch.load(pth, weights_only=True)["model"]
    with np.load(npz) as z:
        assert set(sd) < set(z.files) and "head.weight" in z.files
        for key, val in sd.items():
            np.testing.assert_array_equal(z[key], val.numpy())


def test_convert_upcycle_moe(pretrained, tmp_path):
    _, pth = pretrained
    dense_sets = _sets(*TINY, "model.moe.enabled=false")
    dense_dir, moe_dir = tmp_path / "dense", tmp_path / "moe"
    convert_checkpoint_torch.main(["--to-jax", str(pth), str(dense_dir),
                                   "--config", MOE, *dense_sets])
    # MLPs and graph blocks that matter: the MLP weights scaled up, their
    # biases drawn from a normal, the graph gates at 0.5
    state, meta = ckpt_lib.restore(str(dense_dir))
    g = torch.Generator().manual_seed(5)
    for key, val in state["model"].items():
        if ".mlp." in key:
            val.mul_(8.0).add_(torch.randn(val.shape, generator=g) * 0.1
                               if key.endswith("bias") else 0.0)
        elif key.endswith(".gate"):
            val.fill_(0.5)
    ckpt_lib.save(str(dense_dir), state, meta)
    convert_checkpoint_torch.main(["--upcycle-moe", str(dense_dir),
                                   str(moe_dir), "--config", MOE,
                                   *_sets(*TINY)])
    dense_state, _ = ckpt_lib.restore(str(dense_dir))
    moe_state, meta = ckpt_lib.restore(str(moe_dir))
    assert meta["upcycled_from"] == str(dense_dir)
    # the grouped engine (dropless): the dense engine's capacity drops the
    # pairs the zero router sends to experts 0 and 1
    cfg = load_config(MOE, [*TINY, "model.moe.impl=grouped"])
    dense = build_model(load_config(MOE, [*TINY, "model.moe.enabled=false"])
                        .model)
    dense.load_state_dict(dense_state["model"])
    sparse = build_model(cfg.model)
    sparse.load_state_dict(moe_state["model"])
    assert any(".moe." in k for k in moe_state["model"])
    x = val_preprocess(torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 32, 32, 3), np.uint8)))
    with torch.no_grad():
        want = torch.sigmoid(dense(x))
        got = torch.sigmoid(sparse(x))
        # not vacuous: without its MLPs the model gives other numbers
        for block in dense.blocks:
            block.mlp.fc2.weight.zero_()
            block.mlp.fc2.bias.zero_()
        bare = torch.sigmoid(dense(x))
    assert (got - want).abs().max().item() <= 1e-5
    assert (bare - want).abs().max().item() > 1e-2

    shallow = tmp_path / "shallow"
    convert_checkpoint_torch.main([
        "--to-jax", str(pth), str(shallow), "--config", MOE,
        *_sets(*TINY, "model.moe.enabled=false", "model.depth=1")])
    with pytest.raises(SystemExit, match="source checkpoint lacks"):
        convert_checkpoint_torch.main(["--upcycle-moe", str(shallow),
                                       str(tmp_path / "x"), "--config", MOE,
                                       *_sets(*TINY)])
    with pytest.raises(SystemExit, match="needs model.moe.enabled"):
        convert_checkpoint_torch.main(["--upcycle-moe", str(dense_dir),
                                       str(tmp_path / "y"), "--config", CONFIG,
                                       *_sets(*TINY)])


def test_inspect_each_kind(pretrained, tmp_path, capsys):
    root, pth = pretrained
    dst, npz = tmp_path / "converted", tmp_path / "ref.npz"
    convert_checkpoint_torch.main(["--to-jax", str(pth), str(dst), "--config",
                                   CONFIG, *_sets(*TINY)])
    convert_checkpoint_torch.main(["--to-torch", str(dst), str(npz)])
    capsys.readouterr()
    sd = torch.load(pth, weights_only=True)["model"]
    n_pth = sum(v.numel() for v in sd.values())
    assert inspect_checkpoint_torch.main([str(pth), "--stats"]) == n_pth
    out = capsys.readouterr().out
    assert "descending into 'model'" in out and "finite=True" in out
    assert f"== total: {n_pth:,} elements ==" in out
    assert "pos_embed" in out and "float32" in out

    n_npz = inspect_checkpoint_torch.main([str(npz)])
    out = capsys.readouterr().out
    with np.load(npz) as z:
        assert f"== npz: {len(z.files)} arrays ==" in out
        assert n_npz == sum(z[k].size for k in z.files)

    state, _ = ckpt_lib.restore(str(dst))
    n_dir = inspect_checkpoint_torch.main([str(dst)])
    out = capsys.readouterr().out
    assert "== metadata ==" in out and '"converted_from"' in out
    assert "model.blocks.0.mlp.fc1.weight" in out and "step" in out
    assert n_dir == sum(v.numel() for part in ("model", "criterion")
                        for v in state[part].values())

    inspect_checkpoint_torch.main([str(root / "ckpt" / "mae_epoch_0"),
                                   "--stats"])
    out = capsys.readouterr().out
    assert '"decoder_dim": 32' in out
    assert "params.decoder_pred.weight" in out and "mean=" in out


def test_nan_guard_raises_at_the_first_non_finite_value():
    x = torch.tensor([1.0, 4.0], requires_grad=True)
    with nan_guard():
        y = (x.sqrt() * 2).sum()
        y.backward()
    with pytest.raises(FloatingPointError, match="log"):
        with nan_guard():
            torch.log(torch.tensor([-1.0, 1.0]))
    z = torch.tensor([0.0, 1.0], requires_grad=True)
    with pytest.raises(FloatingPointError):  # the backward's 0.5 / sqrt(0)
        with nan_guard():
            z.sqrt().sum().backward()
    with nan_guard(enable=False):
        assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


def test_trace_and_latency(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert prof.key_averages()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert events["traceEvents"]
    lat = percentile_latency(lambda a: a + 1, (torch.ones(8),), n_iters=5)
    assert set(lat) == {"p50", "p95", "p99"} and lat["p50"] > 0
    meter = ThroughputMeter(warmup_steps=2)
    meter.step(8)
    assert meter.images_per_sec == 0.0  # the clock starts at step 2
    for _ in range(3):
        meter.step(8)
    assert meter.images_per_sec > 0 and meter.images_per_sec_per_device() > 0


def test_logging_setup_and_system_info_on_cpu(tmp_path, caplog):
    caplog.set_level("INFO")
    log_system_info()
    lines = [r.getMessage() for r in caplog.records]
    assert lines[0].startswith(f"PyTorch {torch.__version__}, CUDA ")
    if not torch.cuda.is_available():
        assert lines[1].startswith("no CUDA device: cpu")
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        setup_logging(load_config(CONFIG, [f"paths.log_dir={tmp_path}"]))
        setup_logging({"paths": {"log_dir": str(tmp_path)}})
        ours = [h for h in root.handlers if getattr(h, "_run_log", False)]
        assert len(ours) == 2  # the second call replaced the first's
        logging.getLogger("probe").info("a line")
        for h in ours:
            h.flush()
        text = "".join(p.read_text() for p in tmp_path.glob("training_*.log"))
        assert "a line" in text and "Logging to" in text
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            if getattr(h, "_run_log", False):
                h.close()
        for h in handlers:
            root.addHandler(h)
        root.setLevel(level)
