"""The port at 512 px against the JAX package, fp32 on the CPU: a tiny
model with the 512-px token count (patch 16: N = 1025 with CLS, 1024 patch
tokens for the graph), embed 32, 2 heads, depth 2, two kNN graph blocks
(k = 8, gates 0.5), one image. At this N both packages leave their exact
attention for the blockwise path (JAX: ``flash_attention_large`` in
interpret mode; the port: the plain versions of kernels L/L′) and their
graph blocks for the row-chunked path (``graph_aggregate_chunked``, chunk
512), which the tests check were taken.

* loss, logits and every gradient against ``jax.value_and_grad`` under
  ``jax.jit`` (the Flax layout of the port's seeded weights on both sides),
  with ``model.remat`` off and on: within 1e-4 (fp32, sums in other orders;
  the same bar as tests/test_torch_train_step.py);
* the port's training forward with remat on and off, at dropout 0.1 and
  drop_path 0.1, from the same seed and generator state: the same loss and
  the same gradients, bit for bit (the recompute runs the same operations
  on the same inputs, and drop_path's draws are made once, outside the
  checkpointed part).
"""

import jax
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.ops import attention as jattn
from gavit_tpu.ops import graph_ops as jgraph
from gavit_tpu.training import losses as jlosses
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.ops import attention as tattn
from gavit_tpu_torch.ops import graph_ops as tgraph
from gavit_tpu_torch.training.losses import DynamicWeightedLoss
from gavit_tpu_torch.utils.convert import flax_layout, to_flax_tree
from test_torch_train_step import (_assert_tree_close, jax_loss_fn,
                                   port_model)

SIZE = 512


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: beside the other test processes, a pool of
    threads per process made the remat test 25x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def raw_config(remat=False, drop=0.0, drop_path=0.0):
    return {
        "model": {"name": "custom", "img_size": SIZE, "patch_size": 16,
                  "embed_dim": 32, "depth": 2, "num_heads": 2,
                  "num_classes": 14, "drop_rate": drop,
                  "drop_path_rate": drop_path, "remat": remat,
                  "graph": {"enabled": True, "num_blocks": 2,
                            "insert_after": [0, 1], "adjacency": "knn",
                            "k": 8}},
        "data": {"image_size": SIZE, "batch_size": 1},
        "training": {"precision": "fp32"},
    }


def inputs(batch=1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, SIZE, SIZE, 3)).astype(np.float32)
    labels = (rng.random((batch, 14)) < 0.3).astype(np.float32)
    pos_weight = rng.uniform(0.5, 4.0, 14).astype(np.float32)
    return x, labels, pos_weight


def seeded_params(raw):
    model = init_params(build_model(from_dict(raw).model),
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        for gb in model.graphs:
            gb.gate.fill_(0.5)
    return to_flax_tree(model)


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_512px_model_matches_jax(monkeypatch, remat):
    raw = raw_config(remat=remat)
    params = seeded_params(raw)
    x, labels, pos_weight = inputs()
    calls = []
    for module, name in ((jattn, "flash_attention_large"),
                         (jgraph, "graph_aggregate_chunked"),
                         (tattn, "blockwise_attention_reference"),
                         (tattn, "blockwise_attention_backward_reference"),
                         (tgraph, "graph_aggregate_chunked")):
        _spy(monkeypatch, module, name, calls)
    jmodel = jax_build_model(jax_from_dict(raw).model, precision="fp32")
    jparams = {"model": params,
               "criterion": jlosses.init_criterion_params()}
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jmodel, x, labels, pos_weight), has_aux=True))(jparams)
    # JAX traced each block's attention and each graph block once (twice
    # more for the graph blocks would mean a second trace)
    assert calls.count("flash_attention_large") == 2
    assert calls.count("graph_aggregate_chunked") == 2

    calls.clear()
    model = port_model(raw, params)
    logits = model(torch.from_numpy(x), seed=0)
    loss, _ = DynamicWeightedLoss()(logits, torch.from_numpy(labels),
                                    torch.from_numpy(pos_weight))
    loss.backward()
    # forward per block (and again in the backward's recompute with remat),
    # backward per block; the chunked graph in both graph blocks
    assert calls.count("blockwise_attention_reference") == 2 * (1 + remat)
    assert calls.count("blockwise_attention_backward_reference") == 2
    assert calls.count("graph_aggregate_chunked") == 2
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    assert abs(loss.item() - float(jloss)) <= 1e-4
    grads: dict = {}
    for path, (p, transpose) in flax_layout(model).items():
        node = grads
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = p.grad.numpy().T if transpose else p.grad.numpy()
    _assert_tree_close(grads, jax.tree.map(np.asarray, jgrads["model"]),
                       rel=1e-4)
    assert np.abs(grads["graph_0"]["value"]["kernel"]).max() > 1e-6


def test_remat_on_and_off_give_the_same_step():
    x, labels, pos_weight = inputs(batch=2, seed=1)
    out = {}
    for remat in (False, True):
        raw = raw_config(remat=remat, drop=0.1, drop_path=0.1)
        model = port_model(raw, seeded_params(raw))
        gen = torch.Generator().manual_seed(7)
        logits = model(torch.from_numpy(x), seed=3, generator=gen)
        loss, _ = DynamicWeightedLoss()(logits, torch.from_numpy(labels),
                                        torch.from_numpy(pos_weight))
        loss.backward()
        out[remat] = (loss.detach(), [(n, p.grad) for n, p in
                                      model.named_parameters()],
                      gen.get_state())
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert torch.equal(l0, l1)
    # drop_path drew the same masks, and no more of them, under remat
    assert torch.equal(s0, s1)
    for (name, a), (_, b) in zip(g0, g1):
        assert torch.equal(a, b), name
