"""The static graph (``graph.dynamic: false``) against the JAX model, fp32
on the CPU: two graph blocks (after blocks 0 and 1), the first building the
adjacency from its tokens and the second reusing it, for knn, threshold and
dense adjacency, ``include_cls`` on and off; gates at 0.5 (zero at init
would make the graph vacuous), drop 0. Logits and every parameter's
gradient of ``sum(logits · r)`` within 1e-4 (gradients: of each tensor's
largest |grad|), with the same weights (the port's initialiser through
``to_flax_tree``). One adjacency is built a forward: the second block
takes the first block's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models import graph as graph_mod
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.utils.convert import flatten_tree, flax_layout, to_flax_tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny steps: more only spin against the
    other test workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(adjacency, include_cls, dynamic=False):
    return {"model": {
        "name": "custom", "img_size": 32, "patch_size": 8, "embed_dim": 32,
        "depth": 2, "num_heads": 2, "num_classes": 14, "drop_rate": 0.0,
        "graph": {"enabled": True, "num_blocks": 2, "insert_after": [0, 1],
                  "adjacency": adjacency, "k": 4, "threshold": 0.1,
                  "temperature": 0.7, "dynamic": dynamic,
                  "include_cls": include_cls}}}


@pytest.mark.parametrize("adjacency,include_cls", [
    ("knn", False), ("knn", True), ("threshold", False), ("dense", True)])
def test_static_graph_matches_jax(adjacency, include_cls, monkeypatch):
    raw = _raw(adjacency, include_cls)
    model = init_params(build_model(from_dict(raw).model),
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        for gb in model.graphs:
            gb.gate.fill_(0.5)
    params = to_flax_tree(model)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    r = rng.standard_normal((3, 14)).astype(np.float32)

    jmodel = jax_build_model(jax_from_dict(raw).model, precision="fp32")

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x),
                              deterministic=True)
        return jnp.sum(logits * r), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    logits = model.train()(torch.from_numpy(x))
    (logits * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    want = flatten_tree(jax.tree.map(np.asarray, jgrads))
    for path, (p, transpose) in flax_layout(model).items():
        g = p.grad.numpy().T if transpose else p.grad.numpy()
        tol = 1e-4 * max(np.abs(want[path]).max(), 1e-12)
        assert np.abs(g - want[path]).max() <= tol, path
    assert np.abs(want["graph_0/value/kernel"]).max() > 0

    # one adjacency a forward: the first block builds it, the second reuses
    calls = []
    build = graph_mod.build_adjacency
    monkeypatch.setattr(graph_mod, "build_adjacency",
                        lambda *a, **kw: calls.append(1) or build(*a, **kw))
    with torch.no_grad():
        again = model(torch.from_numpy(x))
    assert calls == [1] and torch.equal(again, logits.detach())
