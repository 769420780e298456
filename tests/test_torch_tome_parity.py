"""Token merging against the JAX package's (the set-up of
``tests/test_torch_tome.py``): ``bipartite_merge``, ``tome_forward`` (at
r = 0 the model bit for bit) and the int8 ToMe Predictor. At most 3 tests
a file (see ``tests/test_torch_trainer_parity.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models.tome import bipartite_merge as jax_merge
from gavit_tpu.models.tome import tome_forward as jax_tome_forward
from gavit_tpu.ops.preprocess import val_preprocess as jax_val_preprocess
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.tome import bipartite_merge, tome_forward
from gavit_tpu_torch.serving import Predictor
from gavit_tpu_torch.utils.convert import (quant_state, quant_to_flax,
                                           to_flax_tree)

from test_torch_tome import TINY
from tests.test_torch_quant import images, tiny_model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bipartite_merge_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 33, 16)).astype(np.float32)
    x[:, 5] = x[:, 8] + 1e-3    # near-duplicates across the A/B split
    x[:, 11] = x[:, 2]
    sizes = rng.integers(1, 4, (3, 33, 1)).astype(np.float32)
    want_x, want_s = jax_merge(jnp.asarray(x), jnp.asarray(sizes), 6)
    got_x, got_s = bipartite_merge(torch.from_numpy(x),
                                   torch.from_numpy(sizes), 6)
    assert got_x.shape == (3, 27, 16) and got_s.shape == (3, 27, 1)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(got_x[:, 0].numpy(), x[:, 0])
    # r clamps to ⌊(N-1)/2⌋ - 1, and below 1 returns the tokens as given
    assert bipartite_merge(torch.from_numpy(x), torch.from_numpy(sizes),
                           99)[0].shape[1] == 33 - 15
    same, _ = bipartite_merge(torch.from_numpy(x[:, :4]),
                              torch.from_numpy(sizes[:, :4]), 3)
    assert same.shape[1] == 4


def test_tome_forward_matches_model_and_jax():
    model = tiny_model("fp32", raw=TINY)
    x = torch.from_numpy(images(2, seed=3))
    with torch.no_grad():
        assert torch.equal(tome_forward(model, x, 0), model(x))
        got = tome_forward(model, x, 2).numpy()
    jcfg = jax_from_dict(TINY).model
    want = jax.jit(lambda p, x: jax_tome_forward(jcfg, p, x, 2))(
        to_flax_tree(model), jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_int8_tome_predictor_matches_jax():
    model = tiny_model("fp32", raw=TINY)
    params = to_flax_tree(model)
    pred = Predictor(from_dict(TINY), params, precision="int8", device="cpu",
                     buckets=(4,), tome_r=2)
    imgs = np.random.default_rng(2).integers(0, 256, (3, 32, 32, 3),
                                             np.uint8)
    with pytest.raises(RuntimeError, match="static scales"):
        pred.predict_proba(imgs)
    pred.warmup()
    got = pred.predict_proba(imgs)
    quant = jax.tree.map(jnp.asarray, quant_to_flax(quant_state(pred.model)))
    jcfg = jax_from_dict(TINY).model
    want = jax.jit(lambda p, q, x: jax.nn.sigmoid(jax_tome_forward(
        jcfg, p, jax_val_preprocess(x), 2, dtype=jnp.bfloat16, quant=q)))(
        params, quant, jnp.asarray(imgs))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-2, rtol=0)
