"""MAE pretraining on the port (``models/mae.py``,
``training/optimizer.py::make_mae_optimizer``, ``ops/mlp.py``'s
differentiable kernel-B entry point) against the JAX package, fp32 on the
CPU at a tiny size (img 32, patch 8, embed 32, depth 2, 2 heads, decoder
32 × 1 × 2), the JAX side under ``jax.jit``, the weights from the port's
initialiser carried across through ``to_flax_tree`` and held path for path
against ``jax.eval_shape`` of the JAX model's init:

* ``random_masking``'s ids, mask and visible tokens exactly, ``patchify``
  exactly, ``mae_loss`` within 1e-6 relative (with and without
  ``norm_pix``), on the same noise;
* ``MAEViT``'s forward and gradients, and ``fused_mlp_inference``'s
  gradients, against the JAX ones: ``tests/test_torch_mae_parity.py``;
* three updates of the MAE optimiser (global-norm clipping at 1.0, AdamW
  with weight decay on every parameter, the warmup-cosine schedule) within
  1e-5 of the optax chain of ``scripts/pretrain_mae.py``, on the same
  gradients;
* ``export_reference_pth`` tensor for tensor equal to the JAX package's on
  the same weights, and read back by both packages' ``load_mae_weights``;
* two pretraining runs of ``scripts/pretrain_mae_torch.py``'s step from
  one seed bit-equal, and the blocks deterministic in ``train()``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gavit_tpu.models import mae as jmae
from gavit_tpu.training.schedule import warmup_cosine_schedule as jax_sched
from gavit_tpu.utils import torch_convert as jconv
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models import mae
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.utils import torch_convert as conv
from gavit_tpu_torch.utils.convert import (flatten_tree, flax_layout,
                                           to_flax_tree)
from test_torch_train_step import _assert_tree_close

ROOT = Path(__file__).resolve().parent.parent
DECODER = dict(decoder_dim=32, decoder_depth=1, decoder_heads=2)
RAW = {"model": {"name": "custom", "img_size": 32, "patch_size": 8,
                 "embed_dim": 32, "depth": 2, "num_heads": 2,
                 "num_classes": 14},
       "data": {"image_size": 32, "batch_size": 4, "synthetic_size": 8},
       "training": {"precision": "fp32", "epochs": 5, "warmup_epochs": 1,
                    "learning_rate": 1e-3, "weight_decay": 30.0}}
BATCH = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_mae(seed=0, **kw):
    model = mae.build_mae(from_dict(RAW).model, **DECODER, **kw)
    return init_params(model, torch.Generator().manual_seed(seed))


def _inputs(seed=0, n=16):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    noise = rng.random((BATCH, n)).astype(np.float32)
    return images, noise


def test_random_masking_and_patchify_are_exact():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, 16, 8)).astype(np.float32)
    # ties in the noise: the stable sorts must order them alike
    noise = rng.integers(0, 5, (BATCH, 16)).astype(np.float32)
    for n_keep in (1, 4, 16):
        want = jax.tree.map(np.asarray, jmae.random_masking(
            jnp.asarray(x), jnp.asarray(noise), n_keep))
        got = mae.random_masking(torch.from_numpy(x), torch.from_numpy(noise),
                                 n_keep)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    images, _ = _inputs()
    np.testing.assert_array_equal(
        mae.patchify(torch.from_numpy(images), 8).numpy(),
        np.asarray(jmae.patchify(jnp.asarray(images), 8)))


@pytest.mark.parametrize("norm_pix", [True, False])
def test_mae_loss_matches_jax(norm_pix):
    images, noise = _inputs(2)
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((BATCH, 16, 192)).astype(np.float32)
    mask = (noise < 0.75).astype(np.float32)
    want = float(jmae.mae_loss(jnp.asarray(pred), jnp.asarray(images),
                               jnp.asarray(mask), 8, norm_pix))
    got = mae.mae_loss(torch.from_numpy(pred), torch.from_numpy(images),
                       torch.from_numpy(mask), 8, norm_pix).item()
    assert got == pytest.approx(want, rel=1e-6)
    # the mask count is clamped at 1: no patch masked gives 0, not NaN
    zero = mae.mae_loss(torch.from_numpy(pred), torch.from_numpy(images),
                        torch.zeros(BATCH, 16), 8, norm_pix)
    assert zero.item() == 0.0


def _pretrainer(raw=RAW, steps_per_epoch=2, **kw):
    sys.path.insert(0, str(ROOT / "scripts"))
    from pretrain_mae_torch import MAEPretrainer

    return MAEPretrainer(from_dict(raw), "cpu", steps_per_epoch, **DECODER,
                         **kw)


def test_mae_optimizer_three_updates_match_optax():
    """Gradients drawn from a seed, their global norm ~30 (clipping on):
    step 0 at lr 0 (the decay moves nothing either), steps 1-2 on the
    warmup; weight decay 30 moves every nonzero leaf, so a masked leaf
    would show."""
    pre = _pretrainer()
    tr, op = from_dict(RAW).training, from_dict(RAW).optimizer
    tx = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(jax_sched(tr.learning_rate, 2 * tr.warmup_epochs,
                              2 * tr.epochs),
                    b1=op.beta1, b2=op.beta2, eps=op.eps,
                    weight_decay=tr.weight_decay))
    layout = flax_layout(pre.model)
    params = jax.tree.map(jnp.asarray, to_flax_tree(pre.model))
    state = tx.init(params)

    @jax.jit
    def step_fn(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    rng = np.random.default_rng(7)
    before = flatten_tree(to_flax_tree(pre.model))
    for step in range(3):
        tree: dict = {}
        for path, (p, transpose) in layout.items():
            g = rng.standard_normal(p.shape).astype(np.float32)
            # a copy: the clip scales p.grad in place, and jnp.asarray of
            # g below may share its memory with the JAX step in flight
            p.grad = torch.tensor(g)
            if transpose:
                g = g.T
            node = tree
            *parents, leaf = path.split("/")
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = jnp.asarray(g)
        params, state = step_fn(tree, state, params)
        pre.update()
        _assert_tree_close(to_flax_tree(pre.model),
                           jax.tree.map(np.asarray, params), atol=1e-5)
        if step == 0:
            _assert_tree_close(to_flax_tree(pre.model), before, atol=0)
    moved = max(np.abs(v - before[k]).max()
                for k, v in flatten_tree(to_flax_tree(pre.model)).items())
    assert moved > 1e-4 and pre.step == 3


def test_export_reference_pth_matches_jax_and_loads_in_both(tmp_path):
    model = _port_mae(seed=8)
    with torch.no_grad():  # nonzero biases and norms: a swap would show
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())) * 0.01)
    ours = mae.export_reference_pth(model, str(tmp_path / "port.pth"))
    jmae.export_reference_pth(to_flax_tree(model), str(tmp_path / "jax.pth"),
                              patch_size=8, in_chans=3)
    got = torch.load(ours, weights_only=True)["model"]
    want = torch.load(tmp_path / "jax.pth", weights_only=True)["model"]
    assert got.keys() == want.keys()
    assert not any(k.startswith(("decoder", "mask_token")) for k in got)
    for key in want:
        assert got[key].dtype == want[key].dtype == torch.float32, key
        assert torch.equal(got[key], want[key]), key
    # the port's ViT and the JAX one both take it
    vit = init_params(build_model(from_dict(RAW).model),
                      torch.Generator().manual_seed(9))
    params = jax.tree.map(np.copy, to_flax_tree(vit))
    conv.load_mae_weights(vit, ours)
    jparams = flatten_tree(jax.tree.map(np.asarray, jconv.load_mae_weights(
        jax.tree.map(jnp.asarray, params), ours, depth=2)))
    port = flatten_tree(to_flax_tree(vit))
    enc = mae.encoder_params(to_flax_tree(model))
    for key, val in flatten_tree(enc).items():
        np.testing.assert_array_equal(port[key], val)
        np.testing.assert_array_equal(jparams[key], val)


def test_encoder_params_filters_both_layouts():
    model = _port_mae()
    sd = mae.encoder_params(model.state_dict())
    assert sd and all(not k.startswith(("decoder", "mask_token"))
                      for k in sd)
    vit = build_model(from_dict(RAW).model)
    assert set(sd) == set(vit.state_dict()) - {"head.weight", "head.bias"} \
        - {k for k in vit.state_dict() if k.startswith("graphs.")}
    tree = mae.encoder_params(to_flax_tree(model))
    assert set(tree) == {"patch_embed", "cls_token", "pos_embed", "norm",
                         "blocks_0", "blocks_1"}


def test_pretrain_steps_rerun_bit_equal():
    """Two runs of two steps from one seed (uint8 images, the affine on):
    the same losses and parameters bit for bit; the draws are keyed by
    (seed, step), so a later step's draws do not depend on the earlier
    ones."""
    raw = {**RAW, "data": {**RAW["data"], "augment_affine": True},
           "training": {**RAW["training"], "weight_decay": 0.05}}
    images = torch.from_numpy(np.random.default_rng(10).integers(
        0, 256, (4, 32, 32, 3), np.uint8))
    runs = []
    for _ in range(2):
        pre = _pretrainer(raw)
        losses = [pre.train_step(images).item() for _ in range(2)]
        runs.append((losses, [p.detach().clone() for p in pre.params]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    pre = _pretrainer(raw)
    pre.step = 1
    x1, n1 = pre.draws(images)
    pre.step = 0
    pre.draws(images)
    pre.step = 1
    x1b, n1b = pre.draws(images)
    assert torch.equal(x1, x1b) and torch.equal(n1, n1b)
