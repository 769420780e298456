"""The port's training step against ``jax.value_and_grad`` of the JAX loss
(the set-up of ``tests/test_torch_train_step.py``): loss, logits and
every gradient, for the dynamic and the learned-static graph, and the loss
with the dynamic λ weights. At most 3 tests a file (see
``tests/test_torch_trainer_parity.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.training import losses as jlosses
from gavit_tpu_torch.training.losses import DynamicWeightedLoss
from gavit_tpu_torch.utils.convert import load_criterion_params

from test_torch_train_step import LEARNED, _check_loss_logits_and_grads


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_logits_and_grads_match_jax():
    grads = _check_loss_logits_and_grads()
    # the graph branch is live in the gradient (graph_1 sits after the last
    # block, where no attention carries the patch tokens to the CLS token)
    assert np.abs(grads["graph_0"]["value"]["kernel"]).max() > 1e-6


def test_learned_static_loss_logits_and_grads_match_jax():
    """The 384-px fine-tune's graph (learned_static) at the tiny size, batch
    3: the adjacency logits' gradient is held like every other."""
    grads = _check_loss_logits_and_grads(LEARNED, batch=3)
    # small (one block carries the patches to the CLS token, through weights
    # of σ 0.02) but not vacuous: held above at 1e-4 of its largest entry
    assert np.abs(grads["graph_0"]["adj_logits"]).max() > 1e-8


def test_loss_matches_jax_with_lambdas():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((8, 14)) * 4).astype(np.float32)
    labels = (rng.random((8, 14)) < 0.3).astype(np.float32)
    pw = rng.uniform(0.5, 4.0, 14).astype(np.float32)
    lam = {"lambda_wbce": np.float32(0.3), "lambda_focal": np.float32(1.2),
           "lambda_asl": np.float32(-0.5)}
    want, comps = jlosses.dynamic_weighted_loss(
        jax.tree.map(jnp.asarray, lam), jnp.asarray(logits),
        jnp.asarray(labels), jnp.asarray(pw))
    crit = load_criterion_params(DynamicWeightedLoss(), lam)
    got, tcomps = crit(torch.from_numpy(logits), torch.from_numpy(labels),
                       torch.from_numpy(pw))
    assert abs(got.item() - float(want)) <= 1e-6
    for k in ("wbce", "focal", "asl"):
        assert abs(tcomps[k].item() - float(comps[k])) <= 1e-6
    np.testing.assert_allclose(
        crit.weights().detach().numpy(),
        np.asarray(jlosses.get_loss_weights(jax.tree.map(jnp.asarray, lam))),
        atol=1e-7)
