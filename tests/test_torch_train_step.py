"""The port's training step against the JAX package's, fp32 on the CPU at a
tiny size (depth 2, embed 64, 2 heads, 32 px with patch 8, two kNN graph
blocks with k=4 and gates at 0.5 — they are zero at init, which would make
graph parity vacuous), drop rate 0, the same weights (the port's seeded
initialiser in the Flax layout, held leaf for leaf against the JAX model's
tree, through ``load_flax_params``), the same images, labels and
pos_weight. A second configuration is the 384-px fine-tune's graph at the
same size: one learned-static graph block, batch 3 (M = 51 rows: no row
block, so both packages take the unfused MLP chain), its adjacency logits
drawn from a seed (zero at init, which would make the adjacency uniform).

* the loss, the logits and every parameter's gradient (the λ included)
  against ``jax.value_and_grad`` of ``dynamic_weighted_loss(model.apply(...,
  deterministic=False))``, the Pallas kernels in interpret mode: loss and
  logits within 1e-4, each gradient within 1e-4 of the largest |grad| of
  its tensor (fp32 products in different orders);
* (tests/test_torch_train_adamw.py: three optimizer steps against optax;)
* the loss, the schedule and the weight-decay mask on their own, the mask
  name by name against the one the JAX package's ``make_optimizer`` applies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.models.vit import init_params as jax_init_params
from gavit_tpu.training import losses as jlosses
from gavit_tpu.training.optimizer import make_optimizer as jax_make_optimizer
from gavit_tpu.training.schedule import warmup_cosine_schedule as jax_sched
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.ops.preprocess import val_preprocess
from gavit_tpu_torch.training.losses import DynamicWeightedLoss
from gavit_tpu_torch.training.optimizer import decays, make_optimizer
from gavit_tpu_torch.training.schedule import warmup_cosine_schedule
from gavit_tpu_torch.utils.convert import (criterion_tree, flatten_tree,
                                           flax_layout, load_criterion_params,
                                           load_flax_params, to_flax_tree)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GATE = 0.5
BATCH = 4


KNN = {"enabled": True, "num_blocks": 2, "insert_after": [0, 1],
       "adjacency": "knn", "k": 4}
LEARNED = {"enabled": True, "num_blocks": 1, "adjacency": "learned_static",
           "temperature": 0.7}


def tiny_raw(graph=None, batch=BATCH, **training):
    return {
        "model": {"name": "custom", "img_size": 32, "patch_size": 8,
                  "embed_dim": 64, "depth": 2, "num_heads": 2,
                  "num_classes": 14, "drop_rate": 0.0,
                  "graph": graph or KNN},
        "data": {"image_size": 32, "batch_size": batch},
        "training": {"precision": "fp32", "epochs": 5, "warmup_epochs": 1,
                     **training},
    }


def setup(seed=0, graph=None, batch=BATCH, **training):
    raw = tiny_raw(graph, batch, **training)
    jcfg = jax_from_dict(raw)
    jmodel = jax_build_model(jcfg.model, precision="fp32")
    model = init_params(build_model(from_dict(raw).model),
                        torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for gb in model.graphs:
            gb.gate.fill_(GATE)
            if gb.adj_logits is not None:
                gb.adj_logits.copy_(torch.randn(gb.adj_logits.shape,
                                                generator=g))
    params = to_flax_tree(model)
    want = jax.eval_shape(lambda k: jax_init_params(jmodel, k),
                          jax.random.key(0))
    assert {k: v.shape for k, v in flatten_tree(params).items()} == {
        "/".join(p.key for p in path): leaf.shape
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (batch, 32, 32, 3), np.uint8)
    x = val_preprocess(torch.from_numpy(imgs)).numpy()
    labels = (rng.random((batch, 14)) < 0.3).astype(np.float32)
    pos_weight = rng.uniform(0.5, 4.0, 14).astype(np.float32)
    return raw, jcfg, jmodel, params, x, labels, pos_weight


def jax_loss_fn(jmodel, x, labels, pos_weight):
    def loss_fn(params):
        logits = jmodel.apply({"params": params["model"]}, jnp.asarray(x),
                              deterministic=False,
                              rngs={"dropout": jax.random.key(1)})
        total, _ = jlosses.dynamic_weighted_loss(
            params["criterion"], logits, jnp.asarray(labels),
            jnp.asarray(pos_weight))
        return total, logits
    return loss_fn


def port_model(raw, params):
    model = build_model(from_dict(raw).model, precision="fp32")
    return load_flax_params(model, params).train()


def _assert_tree_close(got: dict, want: dict, *, rel=None, atol=None):
    got, want = flatten_tree(got), flatten_tree(want)
    assert set(got) == set(want)
    for key in sorted(want):
        w = np.asarray(want[key], np.float32)
        g = np.asarray(got[key], np.float32)
        tol = atol if atol is not None else rel * max(np.abs(w).max(), 1e-12)
        err = np.abs(g - w).max()
        assert err <= tol, f"{key}: max err {err:.3e} > {tol:.3e}"


def _check_loss_logits_and_grads(graph=None, batch=BATCH):
    raw, jcfg, jmodel, params, x, labels, pos_weight = setup(graph=graph,
                                                             batch=batch)
    jparams = {"model": params,
               "criterion": jlosses.init_criterion_params()}
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jax_loss_fn(jmodel, x, labels, pos_weight), has_aux=True))(jparams)

    model = port_model(raw, params)
    crit = DynamicWeightedLoss()
    logits = model(torch.from_numpy(x), seed=0)
    loss, _ = crit(logits, torch.from_numpy(labels),
                   torch.from_numpy(pos_weight))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=0)
    assert abs(loss.item() - float(jloss)) <= 1e-4
    grads: dict = {}
    for path, (p, transpose) in flax_layout(model).items():
        node = grads
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        g = p.grad.numpy()
        node[leaf] = g.T if transpose else g
    _assert_tree_close(grads, jax.tree.map(np.asarray, jgrads["model"]),
                       rel=1e-4)
    _assert_tree_close({n: p.grad.numpy() for n, p in crit.named_parameters()},
                       jax.tree.map(np.asarray, jgrads["criterion"]),
                       rel=1e-4)
    return grads


def test_schedule_and_decay_mask_match_jax():
    for warmup, total in ((2, 10), (5, 100), (0, 7)):
        a = warmup_cosine_schedule(1e-3, warmup, total)
        b = jax_sched(1e-3, warmup, total)
        for step in range(total + 2):
            # JAX evaluates in fp32, the port in Python floats: within
            # 1e-6 of the base lr
            assert a(step) == pytest.approx(float(b(step)), rel=0, abs=1e-9)
    assert warmup_cosine_schedule(1e-3, 2, 10)(0) == 0.0
    model = build_model(from_dict(tiny_raw()).model)
    masked = {n for n, p in model.named_parameters() if not decays(n, p)}
    assert {"cls_token", "pos_embed", "graphs.0.gate", "norm.weight",
            "head.bias"} <= masked
    assert not any(n.endswith("qkv.weight") for n in masked)


@pytest.mark.parametrize("decay_all,graph", [
    pytest.param(True, KNN, id="True"),
    pytest.param(False, KNN, id="False"),
    pytest.param(False, LEARNED, id="learned_static"),
])
def test_decay_groups_match_jax_mask(decay_all, graph):
    """Each parameter, the λ included, sits in a group of the port's AdamW
    with weight decay exactly where the JAX package's optimizer decays it
    (the learned-static adjacency logits included). The JAX side is read
    off optax's second update (the first runs at lr 0) at zero gradients on
    parameters of ones: Adam's step is 0 there, so a leaf moves only if it
    decays."""
    raw = tiny_raw(graph, weight_decay_all_params=decay_all)
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
    assert any(want.values())
    assert all(want.values()) == decay_all  # the mask exempts some leaves
    if graph is LEARNED:
        assert want["model/graph_0/adj_logits"]
