"""The tiny ViT's fp32 logits against the JAX model's on the same weights,
for each graph mode (the rest of the model's checks:
``tests/test_torch_model.py``).

At most 3 tests a file: with ``--dist loadfile`` pytest-xdist hands out the
files with the most tests first, so a file of 3 or fewer runs beside
``tests/test_evaluate_mesh.py`` instead of ahead of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu_torch.models.vit import build_model
from gavit_tpu_torch.utils.convert import load_flax_params

from test_torch_model import (_jax_side, assert_matches_jax_tree, port_weights,
                              tiny_cfg, tiny_raw)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("graph", [
    {"include_cls": False},
    {"include_cls": True},
    {"include_cls": False, "adjacency": "threshold", "threshold": 0.2},
])
def test_vit_fp32_logits_match_jax(graph):
    cfg = tiny_cfg(**graph)
    shapes, forward, _ = _jax_side(jax_from_dict(tiny_raw(**graph)))
    model, params = port_weights(cfg, 0)
    assert_matches_jax_tree(params, shapes)
    x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(forward(params, jnp.asarray(x)))
    # the bridge carries the tree into a fresh model
    model = load_flax_params(build_model(cfg.model, precision="fp32"), params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 14)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # the graph branch is live: a zero gate changes the logits
    with torch.no_grad():
        for gb in model.graphs:
            gb.gate.zero_()
        assert (model(torch.from_numpy(x)) - got).abs().max() > 1e-5
