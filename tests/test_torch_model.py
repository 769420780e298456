"""The port's VisionTransformer against gavit_tpu's on the same weights
(carried over with ``load_flax_params``), fp32 on the CPU, graph gates
nonzero (they are zero at init, which would hide the graph branch) and
learned-static adjacency logits drawn from a seed (zero at init, which would
make the adjacency uniform), with the CLS token inside and outside the
graph. The bar is logits within 1e-4, well under the repo's 1e-3: both
sides run fp32 products in different orders.

The weights come from the port's initialiser through ``to_flax_tree``; the
tree is held leaf for leaf (path and shape) against the JAX model's own
parameter tree from ``jax.eval_shape`` of its ``init_params``. The JAX
forward runs under ``jax.jit``, its Pallas kernels in interpret mode: one
compile per model instead of an eager interpretation of every op.

The shipped configurations are held here; the tiny model in each graph
mode in ``tests/test_torch_model_parity.py``. Also: the weight bridge is
strict and round-trips a learned-static tree, and the initialisers follow
the JAX package's distributions.
"""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.config import load_config as jax_load_config
from gavit_tpu.models.vit import build_model as jax_build_model
from gavit_tpu.models.vit import count_params as jax_count_params
from gavit_tpu.models.vit import init_params as jax_init_params
from gavit_tpu_torch.config import from_dict, load_config
from gavit_tpu_torch.models.graph import GraphBlock
from gavit_tpu_torch.models.vit import build_model, count_params, init_params
from gavit_tpu_torch.utils.convert import (flatten_tree, load_flax_params,
                                           to_flax_tree)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: the test processes share the
    cores, and a pool of threads in each slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GATE = 0.5


def tiny_raw(**graph):
    return {
        "model": {"name": "custom", "img_size": 32, "patch_size": 8,
                  "embed_dim": 64, "depth": 4, "num_heads": 4,
                  "num_classes": 14,
                  "graph": {"enabled": True, "num_blocks": 2,
                            "adjacency": "knn", "k": 4, **graph}},
        "data": {"image_size": 32},
    }


def tiny_cfg(**graph):
    return from_dict(tiny_raw(**graph))


def _jax_side(jcfg):
    """(shapes of the JAX model's parameter tree by '/'-joined path, its
    jitted deterministic forward, its parameter count) for a JAX config,
    built once per model: configurations whose models are equal (two
    shipped files are, at this width) share one compile."""
    return _jax_model(json.dumps(dataclasses.asdict(jcfg.model),
                                 sort_keys=True))


@functools.lru_cache(maxsize=None)
def _jax_model(model_json: str):
    jmodel = jax_build_model(jax_from_dict({"model": json.loads(model_json)})
                             .model, precision="fp32")
    tree = jax.eval_shape(lambda k: jax_init_params(jmodel, k),
                          jax.random.key(0))
    shapes = {"/".join(p.key for p in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    forward = jax.jit(lambda params, x: jmodel.apply(
        {"params": params}, x, deterministic=True))
    return shapes, forward, jax_count_params(tree)


def port_weights(cfg, seed):
    """The port's model at ``seed`` with the graph gates at GATE and any
    learned-static logits drawn from a normal, and its Flax tree."""
    model = init_params(build_model(cfg.model),
                        torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for gb in model.graphs:
            gb.gate.fill_(GATE)
            if gb.adj_logits is not None:
                gb.adj_logits.copy_(torch.randn(gb.adj_logits.shape,
                                                generator=g))
    return model, to_flax_tree(model)


def assert_matches_jax_tree(params, shapes):
    got = {k: tuple(v.shape) for k, v in flatten_tree(params).items()}
    assert got == shapes


CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs")
                 .rglob("*.yaml"))
# each file's own graph settings, at a tiny width and depth (the graph sites
# follow the depth as the file's rule places them)
NARROW = ["model.img_size=32", "model.patch_size=8", "model.embed_dim=64",
          "model.num_heads=4", "model.depth=4", "data.image_size=32"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_shipped_config_logits_match_jax(path):
    """Every YAML file of the repository, read by each package's loader:
    the port's model matches the JAX model's fp32 logits (1e-4, as above),
    the MoE example's expert blocks included (both packages resolve its
    ``impl: auto`` to the dense engine at this size on the CPU)."""
    cfg = load_config(str(path), NARROW)
    jcfg = jax_load_config(str(path), NARROW)
    sites = jcfg.model.graph_insert_after()
    assert sites
    shapes, forward, _ = _jax_side(jcfg)
    model, params = port_weights(cfg, 1)
    assert_matches_jax_tree(params, shapes)
    assert model.graph_sites == tuple(sorted(set(sites)))
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(forward(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_bridge_is_strict_and_reads_npz(tmp_path):
    cfg = tiny_cfg()
    _, params = port_weights(cfg, 0)
    model = build_model(cfg.model)
    _, _, jax_count = _jax_side(jax_from_dict(tiny_raw()))
    assert count_params(model) == jax_count
    flat = flatten_tree(params)

    missing = dict(flat)
    del missing["blocks_1/mlp/fc2/bias"]
    with pytest.raises(KeyError, match="fc2/bias"):
        load_flax_params(model, missing)
    with pytest.raises(KeyError, match="unexpected"):
        load_flax_params(model, {**flat, "graph_0/adj_logits": np.zeros(1)})
    bad = dict(flat)
    bad["head/kernel"] = np.zeros((64, 13), np.float32)
    with pytest.raises(ValueError, match="head/kernel"):
        load_flax_params(model, bad)

    path = tmp_path / "params.npz"
    np.savez(path, **flat)
    from_npz = load_flax_params(build_model(cfg.model), str(path))
    from_tree = load_flax_params(build_model(cfg.model), params)
    for a, b in zip(from_npz.parameters(), from_tree.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # Dense kernels arrive transposed into nn.Linear's [out, in]
    np.testing.assert_array_equal(
        from_tree.blocks[0].attn.qkv.weight.detach().numpy(),
        params["blocks_0"]["attn"]["qkv"]["kernel"].T)


@pytest.mark.parametrize("include_cls", [False, True])
def test_bridge_round_trips_learned_static(include_cls):
    """graph_0/adj_logits ([n, n] over the tokens the block sees, as the JAX
    model's tree holds it) goes through to_flax_tree and load_flax_params
    exactly; a wrong shape raises naming the key."""
    graph = {"adjacency": "learned_static", "num_blocks": 1,
             "include_cls": include_cls}
    cfg = tiny_cfg(**graph)
    shapes, _, _ = _jax_side(jax_from_dict(tiny_raw(**graph)))
    n = 16 + int(include_cls)
    assert shapes["graph_0/adj_logits"] == (n, n)
    model, params = port_weights(cfg, 2)
    assert_matches_jax_tree(params, shapes)
    back = to_flax_tree(load_flax_params(build_model(cfg.model), params))
    flat, again = flatten_tree(params), flatten_tree(back)
    assert set(flat) == set(again)
    for key, val in flat.items():
        np.testing.assert_array_equal(again[key], val)
    assert np.abs(flat["graph_0/adj_logits"]).max() > 0
    bad = dict(flat)
    bad["graph_0/adj_logits"] = np.zeros((n - 1, n - 1), np.float32)
    with pytest.raises(ValueError, match="graph_0/adj_logits"):
        load_flax_params(build_model(cfg.model), bad)


def test_init_params_distributions_and_seed():
    cfg = tiny_cfg()
    a = init_params(build_model(cfg.model), torch.Generator().manual_seed(3))
    b = init_params(build_model(cfg.model), torch.Generator().manual_seed(3))
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    qkv = a.blocks[0].attn.qkv.weight
    assert qkv.abs().max() <= 0.04 and 0.01 < qkv.std() < 0.02
    fan = 3 * 8 * 8 + 64
    assert a.patch_embed.proj.weight.abs().max() <= (6 / fan) ** 0.5
    assert a.pos_embed.abs().max() <= 0.04
    assert (a.blocks[1].mlp.fc1.bias == 0).all()
    assert (a.norm.weight == 1).all() and (a.norm.bias == 0).all()
    assert all(g.gate.item() == 0 for g in a.graphs)
    static = init_params(build_model(tiny_cfg(
        adjacency="learned_static").model), torch.Generator().manual_seed(3))
    assert all((g.adj_logits == 0).all() for g in static.graphs)


@pytest.mark.parametrize("graph", [
    {"dynamic": False},
    {"dynamic": False, "adjacency": "threshold", "threshold": 0.2},
])
def test_unported_graph_modes_raise(graph):
    """The static adjacency shared across graph blocks (``dynamic: false``)
    was refused until ROADMAP Queue 1 item 2; now no block raises: a block
    given no adjacency builds one (row-stochastic ``[B, n, n]`` fp32) and
    returns it, a block given one reuses it. The learned-static graph
    ignores ``dynamic``, as in the JAX model."""
    cfg = tiny_cfg(**graph)
    block = GraphBlock(64, cfg.model.graph)
    assert block.adj_logits is None
    x = torch.randn(2, 17, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        block.gate.fill_(0.5)
        out, adj = block(x)
        assert out.shape == x.shape and adj.shape == (2, 16, 16)
        torch.testing.assert_close(adj.sum(-1), torch.ones(2, 16))
        again, reused = block(x * 2, adj=adj)
    assert reused is adj and not torch.equal(again, out)
    static = tiny_cfg(dynamic=False, adjacency="learned_static")
    assert GraphBlock(64, static.model.graph, num_patches=16).adj_logits \
        .shape == (16, 16)
