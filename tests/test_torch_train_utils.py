"""The port's copies of the JAX package's training utilities, held to the
originals on the CPU:

* ``ops/_build.py::aligned``: a contiguous bf16 view at a 2-byte offset
  becomes a fresh aligned copy (it reads only ``data_ptr`` and strides);
* ``utils/metrics.py::MetricCalculator`` (numpy/scipy) against the JAX one
  (scikit-learn): every key of the battery, the Youden's-J thresholds and
  the bootstrap CIs within 1e-12, on predictions with ties and targets with
  constant columns;
* ``utils/checkpoint.py``: ``checkpoint_name`` and ``latest_checkpoint``
  against the JAX functions on one directory; ``save``/``restore`` round
  trip; the best-model copy;
* ``utils/preemption.py`` and ``utils/wandb_compat.py`` against the JAX
  modules (the signal latch; the JSONL records);
* ``data/loader.py::DataLoader`` against the JAX ``DataLoader``: the same
  batches, epoch by epoch, a ragged last batch and ``drop_last``;
* ``utils/torch_convert.py``: the reference-layout tree against the JAX
  ``torch_state_dict_to_params``, logits of a model loaded from
  ``tests/torch_ref.py::reference_state_dict`` against the JAX model loaded
  by the JAX function within 1e-4 (and against the reference model), the
  reverse direction into the reference's ``Conv2d`` layout and a
  round trip with graph blocks; ``interpolate_pos_embed`` against
  ``jax.image.resize`` within 1e-6 (14→24/32/64, 24→14);
  ``load_mae_weights`` against the JAX one on one ``.pth``.
"""

from __future__ import annotations

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.data import DataLoader as JaxLoader
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.utils import checkpoint as jax_ckpt
from gavit_tpu.utils import torch_convert as jconv
from gavit_tpu.utils import wandb_compat as jax_wandb
from gavit_tpu.utils.metrics import MetricCalculator as JaxCalculator
from gavit_tpu.utils.preemption import PreemptionHandler as JaxHandler
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.data.dataset import SyntheticChestXrayDataset
from gavit_tpu_torch.data.loader import DataLoader
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.ops import _build
from gavit_tpu_torch.utils import checkpoint as ckpt_lib
from gavit_tpu_torch.utils import torch_convert as conv
from gavit_tpu_torch.utils import wandb_compat
from gavit_tpu_torch.utils.convert import (flatten_tree, load_flax_params,
                                           to_flax_tree)
from gavit_tpu_torch.utils.metrics import MetricCalculator
from gavit_tpu_torch.utils.preemption import PreemptionHandler
from tests.torch_ref import TorchRefViT, reference_state_dict

NAMES = [f"d{i}" for i in range(6)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny steps: more only spin against the
    other test workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_aligned_copies_a_misaligned_contiguous_view():
    base = torch.arange(40, dtype=torch.float32).to(torch.bfloat16)
    start = (-base.data_ptr() % 16) // 2  # the first 16-byte aligned element
    view = base[start + 1:start + 33]
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    assert view.contiguous().data_ptr() == view.data_ptr()
    fresh = _build.aligned(view)
    assert fresh.data_ptr() % 16 == 0 and fresh.data_ptr() != view.data_ptr()
    assert torch.equal(fresh, view) and fresh.is_contiguous()
    ok = base[start:start + 32]
    assert _build.aligned(ok) is ok
    rows = base[start:start + 32].view(2, 16)
    assert _build.aligned(rows, rows=True) is rows
    odd = base[start + 1:start + 33].view(2, 16)
    assert _build.aligned(odd, rows=True).data_ptr() % 16 == 0
    strided = base[start:start + 36].view(2, 18)[:, :16]  # rows 36 B apart
    assert not strided.is_contiguous()
    assert _build.aligned(strided, rows=True) is not strided
    wide = base[start:start + 32].view(2, 16)[:, :8]  # rows 32 B apart
    assert _build.aligned(wide, rows=True) is wide
    assert _build.aligned(wide) is not wide  # not contiguous
    bcast = ok[:16].view(1, 16).expand(3, 16)
    assert _build.aligned(bcast, rows=True).stride() == (16, 1)


def _metric_inputs(seed, decimals):
    rng = np.random.default_rng(seed)
    t = (rng.random((80, 6)) < 0.3).astype(np.float32)
    t[:, 2] = 0.0  # single-valued columns are skipped
    t[:, 3] = 1.0
    p = np.round(rng.random((80, 6)), decimals).astype(np.float32)  # ties
    return t, p


@pytest.mark.parametrize("decimals", [1, 2, 7])
def test_metric_battery_matches_jax(decimals):
    t, p = _metric_inputs(decimals, decimals)
    ours, theirs = MetricCalculator(NAMES), JaxCalculator(NAMES)
    for threshold in (0.5, np.linspace(0.2, 0.7, 6)):
        a = ours.calculate_metrics(t, p, threshold=threshold)
        b = theirs.calculate_metrics(t, p, threshold=threshold)
        assert a.keys() == b.keys() and "d2_auc" not in a
        for key in b:
            assert abs(a[key] - b[key]) <= 1e-12, key
    a, b = ours.optimal_thresholds(t, p), theirs.optimal_thresholds(t, p)
    assert a.keys() == b.keys() == {"d0", "d1", "d4", "d5"}
    for key in b:
        assert abs(a[key] - b[key]) <= 1e-12, key
    a = ours.calculate_confidence_intervals(t, p, n_bootstrap=60, seed=4)
    b = theirs.calculate_confidence_intervals(t, p, n_bootstrap=60, seed=4)
    assert a.keys() == b.keys()
    for key in b:
        assert np.abs(np.subtract(a[key], b[key])).max() <= 1e-12, key


def test_checkpoint_names_and_latest_match_jax(tmp_path):
    for epoch, auc in ((0, 0.0), (3, 0.51234), (12, 0.99999), (7, 1.0)):
        assert ckpt_lib.checkpoint_name(epoch, auc) == \
            jax_ckpt.checkpoint_name(epoch, auc)
    assert ckpt_lib.latest_checkpoint(str(tmp_path / "none")) is None
    for epoch, complete in ((1, True), (4, True), (9, False), (2, True)):
        path = tmp_path / jax_ckpt.checkpoint_name(epoch, 0.5)
        path.mkdir()
        if complete:  # each package's mark of a finished checkpoint
            (path / "state").mkdir()
            (path / ckpt_lib.STATE_FILE).write_bytes(b"")
    (tmp_path / "best_model").mkdir()
    want = jax_ckpt.latest_checkpoint(str(tmp_path))
    assert want.endswith("checkpoint_epoch_4_auc_0.5000")
    assert ckpt_lib.latest_checkpoint(str(tmp_path)) == want


def test_checkpoint_save_restore_and_best_copy(tmp_path):
    state = {"w": torch.arange(6.0), "step": 5,
             "gen": torch.Generator().manual_seed(2).get_state()}
    path = tmp_path / "checkpoint_epoch_0_auc_0.5000"
    ckpt_lib.save(str(path), state, {"epoch": 0}, also=(str(tmp_path / "b"),))
    for where in (path, tmp_path / "b"):
        got, meta = ckpt_lib.restore(str(where))
        assert meta == {"epoch": 0} == json.loads(
            (where / "meta.json").read_text())
        assert torch.equal(got["w"], state["w"]) and got["step"] == 5
        assert torch.equal(got["gen"], state["gen"])
    assert not [n for n in os.listdir(path) if ".tmp-" in n]
    ckpt_lib.save(str(path), {"w": torch.zeros(1)}, {"epoch": 1})
    assert ckpt_lib.restore(str(path))[1] == {"epoch": 1}
    assert ckpt_lib.restore(str(tmp_path / "b"))[1] == {"epoch": 0}


def test_preemption_handler_latches_as_the_jax_one():
    before = signal.getsignal(signal.SIGUSR1)
    for cls in (PreemptionHandler, JaxHandler):
        h = cls(signals=(signal.SIGUSR1,)).install()
        assert not h.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.preempted
        h.uninstall()
        assert signal.getsignal(signal.SIGUSR1) == before


def test_wandb_sink_writes_the_jax_records(tmp_path):
    cfg = from_dict({"wandb": {"mode": "disabled", "name": "run"}})
    jcfg = jax_from_dict({"wandb": {"mode": "disabled", "name": "run"}})
    lines = []
    for mod, c, sub in ((wandb_compat, cfg, "port"),
                        (jax_wandb, jcfg, "jax")):
        run = mod.init(c, log_dir=str(tmp_path / sub))
        run.log({"train/loss": np.float32(0.5), "epoch": 1, "note": "x"})
        run.log({"val/mean_auc": 0.75}, step=7)
        run.finish()
        [name] = os.listdir(tmp_path / sub)
        assert name.startswith("metrics_run_")
        lines.append((tmp_path / sub / name).read_text().splitlines())
    assert lines[0][1:] == lines[1][1:]
    assert json.loads(lines[0][0])["_type"] == "config"


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_match_the_jax_loader(drop_last):
    ds = SyntheticChestXrayDataset(size=21, image_size=16, seed=2)
    ours = DataLoader(ds, 8, shuffle=True, drop_last=drop_last, seed=5)
    theirs = JaxLoader(ds, 8, shuffle=True, num_workers=1,
                       drop_last=drop_last, seed=5)
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    for epoch in (0, 1, 0):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b)
        for (ia, la), (ib, lb) in zip(a, b):
            assert ia.dtype == np.uint8 and np.array_equal(ia, ib)
            assert np.array_equal(la, lb)
    assert a[-1][0].shape[0] == (8 if drop_last else 5)
    plain = DataLoader(ds, 8)
    assert np.array_equal(np.concatenate([lb for _, lb in plain]), ds.labels)


REF = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2)


def _port_cfg(**graph):
    return from_dict({"model": {
        "name": "custom", "img_size": REF["img_size"],
        "patch_size": REF["patch_size"], "embed_dim": REF["embed_dim"],
        "depth": REF["depth"], "num_heads": REF["num_heads"],
        "num_classes": 14, "graph": graph or {"enabled": False}}})


def test_reference_layout_bridge_matches_jax():
    torch.manual_seed(0)
    ref = TorchRefViT(num_classes=14, **REF).eval()
    sd = reference_state_dict(ref)
    tree = conv.torch_state_dict_to_params(sd, REF["depth"])
    want = jconv.torch_state_dict_to_params(
        {k: v.numpy() for k, v in sd.items()}, depth=REF["depth"])
    got_flat, want_flat = flatten_tree(tree), flatten_tree(
        jax.tree.map(np.asarray, want))
    assert got_flat.keys() == want_flat.keys()
    assert all(np.array_equal(got_flat[k], want_flat[k]) for k in got_flat)

    cfg = _port_cfg()
    model = load_flax_params(build_model(cfg.model), tree)
    x = np.random.default_rng(1).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        logits = model(torch.from_numpy(x)).numpy()
        ref_logits = ref(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    jmodel = jax_build_model(jax_from_dict(
        {"model": dict(cfg.to_dict()["model"])}).model, precision="fp32")
    jlogits = np.asarray(jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, deterministic=True))(want, jnp.asarray(x)))
    np.testing.assert_allclose(logits, jlogits, atol=1e-4, rtol=0)
    np.testing.assert_allclose(logits, ref_logits, atol=1e-4, rtol=0)

    back = conv.params_to_torch_state_dict(model)
    assert back["patch_embed.proj.weight"].shape == (64, 3, 8, 8)
    assert back.keys() == sd.keys()
    for key, val in sd.items():
        assert np.array_equal(back[key], val.numpy()), key
    ref2 = TorchRefViT(num_classes=14, **REF)
    ref2.load_state_dict({k.replace("attn.", "").replace("mlp.", ""):
                          torch.from_numpy(v) for k, v in back.items()})


@pytest.mark.parametrize("adjacency", ["knn", "learned_static"])
def test_bridge_round_trip_with_graph_blocks(adjacency):
    cfg = _port_cfg(enabled=True, num_blocks=2, insert_after=[0, 1],
                    adjacency=adjacency, k=4)
    model = init_params(build_model(cfg.model),
                        torch.Generator().manual_seed(3))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())) * 0.01)
    sd = conv.params_to_torch_state_dict(model)
    assert {"graphs.1.gate", "graphs.1.value.weight", "graphs.0.norm.bias"} \
        <= sd.keys()
    assert ("graphs.0.adj_logits" in sd) == (adjacency == "learned_static")
    fresh = load_flax_params(build_model(cfg.model),
                             conv.torch_state_dict_to_params(sd, 2))
    for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), name
    assert conv.params_to_torch_state_dict(
        to_flax_tree(model), patch_size=8).keys() == sd.keys()


@pytest.mark.parametrize("old,new", [(14, 24), (14, 32), (14, 64), (24, 14)])
def test_interpolate_pos_embed_matches_jax_resize(old, new):
    pe = np.random.default_rng(old * new).standard_normal(
        (1, old * old + 1, 48)).astype(np.float32) * 0.02
    got = conv.interpolate_pos_embed(pe, new * new)
    want = np.asarray(jconv.interpolate_pos_embed(pe, new * new))
    assert got.shape == want.shape == (1, new * new + 1, 48)
    assert np.abs(got.numpy() - want).max() <= 1e-6
    assert torch.equal(got[:, :1], torch.from_numpy(pe[:, :1]))


def test_load_mae_weights_matches_jax(tmp_path, caplog):
    """A reference-layout checkpoint of a 32-px model (a 4×4 grid, with its
    own head and an unexpected key) loaded into a 48-px model (6×6): the
    pos-embed interpolated, every other matching entry copied, the head
    kept, as the JAX loader does."""
    torch.manual_seed(1)
    ref = TorchRefViT(num_classes=5, **REF)
    path = tmp_path / "mae.pth"
    torch.save({"model": {**reference_state_dict(ref),
                          "decoder_head.weight": torch.zeros(2)}}, path)
    cfg = from_dict({"model": {**_port_cfg().to_dict()["model"],
                               "img_size": 48}})
    model = init_params(build_model(cfg.model),
                        torch.Generator().manual_seed(0))
    head = model.head.weight.detach().clone()
    params = jax.tree.map(np.copy, to_flax_tree(model))  # not views
    caplog.set_level("INFO")
    conv.load_mae_weights(model, str(path))
    want = flatten_tree(jax.tree.map(np.asarray, jconv.load_mae_weights(
        jax.tree.map(jnp.asarray, params), str(path), depth=REF["depth"])))
    got = flatten_tree(to_flax_tree(model))
    assert got.keys() == want.keys()
    for key in want:
        assert np.abs(got[key] - want[key]).max() <= 1e-6, key
    assert torch.equal(model.head.weight, head)
    assert not np.array_equal(got["pos_embed"], flatten_tree(params)[
        "pos_embed"])
    assert any("interpolated pos_embed" in r.getMessage()
               for r in caplog.records)
