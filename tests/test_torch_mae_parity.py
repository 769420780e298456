"""The MAE model's forward and gradients, and kernel B's chain backward,
against the JAX package's on the CPU (the rest of the MAE path:
``tests/test_torch_mae.py``).

At most 3 tests a file: with ``--dist loadfile`` pytest-xdist hands out the
files with the most tests first, so a file of 3 or fewer runs beside
``tests/test_evaluate_mesh.py`` instead of ahead of it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models import mae as jmae
from gavit_tpu.ops.mlp import fused_mlp_inference as jax_fmi
from gavit_tpu_torch.models import mae
from gavit_tpu_torch.ops import mlp as M
from gavit_tpu_torch.utils.convert import (flatten_tree, flax_layout,
                                           to_flax_tree)

from test_torch_mae import DECODER, RAW, _inputs, _port_mae
from test_torch_train_step import _assert_tree_close


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mae_forward_and_gradients_match_jax():
    model = _port_mae(seed=4)
    jcfg = jax_from_dict(RAW).model
    jmodel = jmae.MAEViT(cfg=jcfg, mask_ratio=0.75, **DECODER)
    params = to_flax_tree(model)
    images, noise = _inputs(5)
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.asarray(images), jnp.asarray(noise)),
        jax.random.key(0))["params"]
    assert {k: v.shape for k, v in flatten_tree(params).items()} == {
        "/".join(p.key for p in path): leaf.shape
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}

    def loss_fn(p):
        pred, mask = jmodel.apply({"params": p}, jnp.asarray(images),
                                  jnp.asarray(noise))
        return jmae.mae_loss(pred, jnp.asarray(images), mask, 8), (pred, mask)

    (jloss, (jpred, jmask)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))

    model.train()
    assert not any(b.training for b in (*model.blocks, *model.decoder_blocks))
    pred, mask = model(torch.from_numpy(images), torch.from_numpy(noise))
    loss = mae.mae_loss(pred, torch.from_numpy(images), mask, 8)
    loss.backward()
    assert pred.dtype == mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert np.abs(pred.detach().numpy() - np.asarray(jpred)).max() <= 1e-4
    assert loss.item() == pytest.approx(float(jloss), rel=1e-4)
    grads = to_flax_tree(model)  # the layout, then the gradients into it
    flat = flatten_tree(grads)
    for path, (p, transpose) in flax_layout(model).items():
        g = p.grad.numpy()
        flat[path] = g.T if transpose else g
    _assert_tree_close(flat, jax.tree.map(np.asarray, jgrads), rel=1e-4)
    # every MLP weight has a gradient (the chain backward behind kernel B)
    for block in (*model.blocks, *model.decoder_blocks):
        assert block.mlp.fc1.weight.grad.abs().max() > 0
        assert block.mlp.fc2.weight.grad.abs().max() > 0


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_mlp_inference_gradients_match_jax_vjp(approximate):
    rng = np.random.default_rng(6)
    d, f = 16, 64
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    w1 = (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) * f ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(d) * 0.1).astype(np.float32)
    gy = rng.standard_normal((2, 5, d)).astype(np.float32)
    jy, vjp = jax.vjp(lambda *a: jax_fmi(*a, approximate),
                      *map(jnp.asarray, (x, w1, b1, w2, b2)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(gy))]
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
    y = M.fused_mlp_inference(*args, approximate=approximate)
    # the output's reshape, then the Function
    assert type(y.grad_fn.next_functions[0][0]).__name__ == \
        "_MlpInferenceBackward"
    assert np.abs(y.detach().numpy() - np.asarray(jy)).max() <= 1e-5
    y.backward(torch.from_numpy(gy))
    got = [a.grad.numpy() for a in args]
    got[1], got[3] = got[1].T, got[3].T  # nn.Linear's layout → JAX's
    for name, g, w in zip(("x", "w1", "b1", "w2", "b2"), got, want):
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1.0), name
    # without gradients: the same values, no graph
    with torch.no_grad():
        again = M.fused_mlp_inference(*args, approximate=approximate)
    assert again.grad_fn is None and torch.equal(again, y.detach())
