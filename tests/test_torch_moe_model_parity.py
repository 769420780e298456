"""The MoE model against the JAX one (the set-up of
``tests/test_torch_moe_model.py``): loss, logits and every gradient on
the dense and the grouped engine, and the weight-decay groups against the
JAX optimizer's mask. At most 3 tests a file (see
``tests/test_torch_trainer_parity.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models.moe import moe_aux_loss
from gavit_tpu.training import losses as jlosses
from gavit_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.vit import build_model
from gavit_tpu_torch.training.losses import DynamicWeightedLoss
from gavit_tpu_torch.training.optimizer import make_optimizer
from gavit_tpu_torch.utils.convert import (criterion_tree, flatten_tree,
                                           flax_layout, load_flax_params,
                                           to_flax_tree)

from test_torch_moe_model import BATCH, _rel_close, port_model, tiny_raw


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("impl", ["dense", "grouped"])
def test_moe_model_loss_logits_and_grads_match_jax(impl):
    raw = tiny_raw(impl)
    model, params, jmodel = port_model(raw)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    labels = (rng.random((BATCH, 14)) < 0.3).astype(np.float32)
    pw = rng.uniform(0.5, 4.0, 14).astype(np.float32)
    jparams = {"model": params,
               "criterion": jlosses.init_criterion_params()}

    def objective(p):
        logits, mvars = jmodel.apply(
            {"params": p["model"]}, jnp.asarray(x), deterministic=False,
            rngs={"dropout": jax.random.key(1)}, mutable=["moe_losses"])
        total, _ = jlosses.dynamic_weighted_loss(
            p["criterion"], logits, jnp.asarray(labels), jnp.asarray(pw))
        return total + moe_aux_loss(mvars), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(jparams)

    model = load_flax_params(build_model(from_dict(raw).model), params)
    model.train()
    crit = DynamicWeightedLoss()
    logits = model(torch.from_numpy(x), seed=0)
    loss, _ = crit(logits, torch.from_numpy(labels), torch.from_numpy(pw))
    aux = model.moe_aux_loss()
    (loss + aux).backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    assert abs((loss + aux).item() - float(jloss)) <= 1e-4
    assert aux.item() > 0
    want = flatten_tree(jax.tree.map(np.asarray, jgrads["model"]))
    got = {path: (p.grad.numpy().T if t else p.grad.numpy())
           for path, (p, t) in flax_layout(model).items()}
    assert set(got) == set(want)
    for path in sorted(want):
        _rel_close(got[path], want[path], 1e-4, path)
    for n, p in crit.named_parameters():
        _rel_close(p.grad.numpy(), jgrads["criterion"][n], 1e-4, n)
    # the routers and the expert banks get real gradients (block 0's router
    # from zero: through the gates and the aux loss)
    for i in (0, 1):
        assert np.abs(got[f"blocks_{i}/moe/router"]).max() > 1e-7
        assert np.abs(got[f"blocks_{i}/moe/fc1_kernel"]).max() > 1e-6


def test_moe_decay_groups_match_jax_mask():
    """As tests/test_torch_train_step.py::test_decay_groups_match_jax_mask,
    for the MoE model with weight_decay_all_params off: optax's second
    update at zero gradients moves a leaf of ones only if it decays."""
    raw = tiny_raw(weight_decay_all_params=False)
    model = build_model(from_dict(raw).model)
    crit = DynamicWeightedLoss()
    ones = jax.tree.map(jnp.ones_like,
                        {"model": to_flax_tree(model),
                         "criterion": criterion_tree(crit)})
    tx = jax_make_optimizer(jax_from_dict(raw), 2)
    zeros, state = jax.tree.map(jnp.zeros_like, ones), tx.init(ones)
    for _ in range(2):
        updates, state = jax.jit(tx.update)(zeros, state, ones)
    want = {k: bool(np.abs(v).max() > 0)
            for k, v in flatten_tree(updates).items()}
    opt, _ = make_optimizer(from_dict(raw), model, crit, 2)
    decayed = {id(p): g["weight_decay"] > 0
               for g in opt.param_groups for p in g["params"]}
    got = {f"model/{path}": decayed[id(p)]
           for path, (p, _) in flax_layout(model).items()}
    got.update({f"criterion/{n}": decayed[id(p)]
                for n, p in crit.named_parameters()})
    assert got == want
    for i in (0, 1):
        assert want[f"model/blocks_{i}/moe/router"]
        assert want[f"model/blocks_{i}/moe/fc1_kernel"]
        assert not want[f"model/blocks_{i}/moe/fc1_bias"]
        assert not want[f"model/blocks_{i}/moe/fc2_bias"]
