"""The port's MoE model against gavit_tpu's, fp32 on the CPU at a tiny size
(32 px with patch 8, embed 32, 2 heads, depth 2 with both blocks MoE, E=4,
k=2, F=128, one kNN graph block with its gate at 0.5), drop rate 0, the
weights from the port's initialiser in the Flax layout, held leaf for leaf
against the JAX model's tree:

* ``MoEMlp`` alone, on the dense and on the grouped engine: the output, the
  gradient of the input and of every weight, and the weighted aux loss;
* the model: the logits within 1e-4 and every parameter's gradient (the
  routers, the expert banks and the λ included) within 1e-4 of its
  tensor's largest, against ``jax.value_and_grad`` of the JAX trainer's
  objective (``dynamic_weighted_loss`` plus the sown MoE aux loss), on both
  engines, with block 0's router at zero (every expert tied: the dense
  engine drops past capacity) and block 1's drawn from the initialiser;
* the weight bridge round trip of ``blocks_{i}/moe/*`` (no transpose);
* the weight-decay groups against the JAX optimizer's mask, leaf by leaf
  (the ``[E, F]`` expert biases exempt, the router decayed).

The JAX grouped engine on the CPU is its unfused ragged one; the port's is
the plain version of the fused one: both dropless, the same function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models.moe import MoEMlp as JaxMoEMlp
from gavit_tpu.models.moe import moe_aux_loss
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.models.vit import init_params as jax_init_params
from gavit_tpu.training import losses as jlosses
from gavit_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.moe import MoEMlp
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.training.losses import DynamicWeightedLoss
from gavit_tpu_torch.training.optimizer import make_optimizer
from gavit_tpu_torch.utils.convert import (criterion_tree, flatten_tree,
                                           flax_layout, load_flax_params,
                                           to_flax_tree)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GATE, BATCH = 0.5, 3


def tiny_raw(impl="dense", **training):
    return {
        "model": {"name": "custom", "img_size": 32, "patch_size": 8,
                  "embed_dim": 32, "depth": 2, "num_heads": 2,
                  "num_classes": 14, "drop_rate": 0.0,
                  "graph": {"enabled": True, "num_blocks": 1,
                            "insert_after": [0], "adjacency": "knn",
                            "k": 4},
                  "moe": {"enabled": True, "num_experts": 4, "k": 2,
                          "every": 1, "impl": impl, "aux_weight": 0.01,
                          "router_z_weight": 0.001}},
        "data": {"image_size": 32, "batch_size": BATCH},
        "training": {"precision": "fp32", "epochs": 5, "warmup_epochs": 1,
                     **training},
    }


def port_model(raw, seed=0):
    """The port's model from ``seed``, graph gate at GATE, block 0's router
    at zero; and its Flax tree, held against the JAX model's."""
    model = init_params(build_model(from_dict(raw).model),
                        torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.graphs[0].gate.fill_(GATE)
        model.blocks[0].moe.router.zero_()
    params = to_flax_tree(model)
    jmodel = jax_build_model(jax_from_dict(raw).model, precision="fp32")
    want = jax.eval_shape(lambda k: jax_init_params(jmodel, k),
                          jax.random.key(0))
    assert {k: v.shape for k, v in flatten_tree(params).items()} == {
        "/".join(p.key for p in path): leaf.shape
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    return model, params, jmodel


def _rel_close(got, want, rel, name):
    want = np.asarray(want, np.float32)
    tol = rel * max(np.abs(want).max(), 1e-12)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol, f"{name}: max err {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("impl", ["dense", "grouped"])
def test_moe_mlp_matches_jax(impl):
    cfg = from_dict(tiny_raw(impl)).model.moe
    jcfg = jax_from_dict(tiny_raw(impl)).model.moe
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, 17, 32)).astype(np.float32)
    r = rng.standard_normal((BATCH, 17, 32)).astype(np.float32)
    mod = MoEMlp(cfg, 32, 64)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(p.shape).astype(np.float32) * 0.3))
    params = {n: p.detach().numpy() for n, p in mod.named_parameters()}
    jmod = JaxMoEMlp(cfg=jcfg, hidden_dim=64, out_dim=32)

    def loss(params, x):
        out, mvars = jmod.apply({"params": params}, x, deterministic=False,
                                mutable=["moe_losses"])
        aux = moe_aux_loss(mvars)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    mod.train()
    tx = torch.from_numpy(x).requires_grad_(True)
    out = mod(tx)
    ((out * torch.from_numpy(r)).sum() + mod.aux_loss).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4, rtol=0)
    assert abs(mod.aux_loss.item() - float(jaux)) <= 1e-6
    _rel_close(tx.grad.numpy(), jgrads[1], 1e-4, "x")
    for n, p in mod.named_parameters():
        _rel_close(p.grad.numpy(), jgrads[0][n], 1e-4, n)


def test_moe_bridge_round_trip_and_strict():
    raw = tiny_raw()
    model, params, _ = port_model(raw, seed=2)
    flat = flatten_tree(params)
    assert flat["blocks_1/moe/fc1_kernel"].shape == (4, 32, 128)
    assert flat["blocks_1/moe/fc2_bias"].shape == (4, 32)
    back = to_flax_tree(load_flax_params(build_model(from_dict(raw).model),
                                         params))
    again = flatten_tree(back)
    assert set(again) == set(flat)
    for key, val in flat.items():
        np.testing.assert_array_equal(again[key], val)
    # no transpose: the bank is the module's tensor as it is
    np.testing.assert_array_equal(
        model.blocks[1].moe.fc2_kernel.detach().numpy(),
        flat["blocks_1/moe/fc2_kernel"])
    bad = dict(flat)
    bad["blocks_0/moe/router"] = np.zeros((4, 32), np.float32)
    with pytest.raises(ValueError, match="blocks_0/moe/router"):
        load_flax_params(build_model(from_dict(raw).model), bad)
    missing = dict(flat)
    del missing["blocks_1/moe/fc1_bias"]
    with pytest.raises(KeyError, match="fc1_bias"):
        load_flax_params(build_model(from_dict(raw).model), missing)
