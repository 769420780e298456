"""Three optimizer steps of the port's ``Trainer.train_step`` against the
JAX package's ``make_optimizer`` (optax: two-group AdamW, model-only global
norm clipping, warmup-cosine schedule with a warmup of 2 steps, lr 1e-4),
fp32 on the CPU, on the tiny model and batch of ``test_torch_train_step.py``,
with weight decay on every parameter and with the JAX package's mask.

The weight decay is 30, not the config's 0.05: at 0.05 decay moves a weight
by less than the tolerance, so a wrong mask would pass. At 30 it moves every
nonzero leaf (LayerNorm scales, gates, λ, kernels, embeddings) by at least
9e-5, nine times the tolerance.

The parameters after each step agree within 1e-5 — a tenth of one step's
move: Adam's normalised update turns a gradient difference at the fp32
noise floor into a move of up to the lr. Step 0 runs at lr 0 and moves
nothing on either side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gavit_tpu.training import losses as jlosses
from gavit_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.training.trainer import Trainer
from gavit_tpu_torch.utils.convert import (criterion_tree, flatten_tree,
                                           to_flax_tree)
from test_torch_train_step import (_assert_tree_close, jax_loss_fn,
                                   port_model, setup)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("decay_all", [True, False])
def test_three_adamw_steps_match_optax(decay_all):
    raw, jcfg, jmodel, params, x, labels, pos_weight = setup(
        seed=1, learning_rate=1e-4, weight_decay=30.0,
        weight_decay_all_params=decay_all)
    steps_per_epoch = 2  # warmup_epochs 1 → warmup of 2 steps
    tx = jax_make_optimizer(jcfg, steps_per_epoch)
    jparams = {"model": jax.tree.map(jnp.asarray, params),
               "criterion": jlosses.init_criterion_params()}
    state = tx.init(jparams)
    grad_fn = jax.jit(jax.grad(jax_loss_fn(jmodel, x, labels, pos_weight),
                               has_aux=True))
    update = jax.jit(tx.update)

    trainer = Trainer(from_dict(raw), port_model(raw, params), pos_weight,
                      steps_per_epoch, device="cpu")
    before = to_flax_tree(trainer.model)
    for step in range(3):
        grads, _ = grad_fn(jparams)
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        m = trainer.train_step(torch.from_numpy(x), torch.from_numpy(labels))
        assert m["lr"] == pytest.approx(1e-4 * step / 2)
        _assert_tree_close(to_flax_tree(trainer.model),
                           jax.tree.map(np.asarray, jparams["model"]),
                           atol=1e-5)
        _assert_tree_close(criterion_tree(trainer.criterion),
                           jax.tree.map(np.asarray, jparams["criterion"]),
                           atol=1e-5)
        if step == 0:
            # lr 0: nothing moves (the moments do, on both sides)
            _assert_tree_close(to_flax_tree(trainer.model), before, atol=0)
    after = flatten_tree(to_flax_tree(trainer.model))
    moved = max(np.abs(after[k] - v).max()
                for k, v in flatten_tree(before).items())
    assert moved > 1e-4  # Adam moves each weight by ~lr a step: not vacuous


