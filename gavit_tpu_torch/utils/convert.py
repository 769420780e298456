"""Weights between the JAX package's Flax parameter tree and the port.

``load_flax_params(model, tree)`` takes the tree as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)``), or the path of an ``.npz``
whose keys are the '/'-joined Flax paths (``blocks_0/attn/qkv/kernel``).
Dense kernels ``[in, out]`` are transposed into ``nn.Linear``'s
``[out, in]``; LayerNorm ``scale`` becomes ``weight``; an MoE block's
``blocks_{i}/moe/{router, fc1_kernel, fc1_bias, fc2_kernel, fc2_bias}``
keep the Flax layout both ways, with no transpose. Strict: a missing or
unexpected key, or a shape mismatch, raises. ``to_flax_tree`` is the
reverse direction (port → nested dicts of numpy arrays in the Flax layout).
``load_criterion_params`` / ``criterion_tree`` carry the loss's λ
(``{'lambda_wbce', 'lambda_focal', 'lambda_asl'}``, the JAX package's
``params['criterion']``).

Reading an orbax checkpoint needs JAX and waits for the checkpoint port.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from gavit_tpu_torch.models.layers import Dense, LayerNorm


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts → ``{'a/b/c': array}``."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(flatten_tree(val, path + "/"))
        else:
            flat[path] = np.asarray(val)
    return flat


def _flax_module_path(name: str) -> str:
    """``blocks.3.attn.qkv`` → ``blocks_3/attn/qkv``; ``graphs.1`` →
    ``graph_1``."""
    name = re.sub(r"^blocks\.(\d+)", r"blocks_\1", name)
    name = re.sub(r"^graphs\.(\d+)", r"graph_\1", name)
    return name.replace(".", "/")


def flax_layout(model: nn.Module) -> dict:
    """``{flax path: (parameter, transpose)}`` for every parameter."""
    owners = {}
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            owners[f"{mod_name}.{p_name}" if mod_name else p_name] = (mod, p)
    layout = {}
    for full, (mod, p) in owners.items():
        mod_name, _, p_name = full.rpartition(".")
        if isinstance(mod, LayerNorm):
            leaf, transpose = {"weight": "scale", "bias": "bias"}[p_name], False
        elif isinstance(mod, Dense):
            leaf, transpose = {"weight": "kernel", "bias": "bias"}[p_name], \
                p_name == "weight"
        else:  # cls_token, pos_embed, graph gate, MoE router and banks
            leaf, transpose = p_name, False
        path = f"{_flax_module_path(mod_name)}/{leaf}" if mod_name else leaf
        layout[path] = (p, transpose)
    return layout


@torch.no_grad()
def load_flax_params(model: nn.Module, tree) -> nn.Module:
    """Fill ``model``'s parameters from a Flax tree or ``.npz`` path."""
    if isinstance(tree, (str, bytes)) or hasattr(tree, "__fspath__"):
        with np.load(tree) as z:
            flat = {k: z[k] for k in z.files}
    else:
        flat = flatten_tree(tree)
    layout = flax_layout(model)
    missing = sorted(set(layout) - set(flat))
    unexpected = sorted(set(flat) - set(layout))
    if missing or unexpected:
        raise KeyError(f"Flax tree does not match the model: missing "
                       f"{missing}, unexpected {unexpected}")
    for path, (p, transpose) in layout.items():
        arr = np.asarray(flat[path], np.float32)
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{path}: shape {arr.shape} (after transpose) "
                             f"does not match {tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
    return model


def to_flax_tree(model: nn.Module) -> dict:
    """The model's parameters as nested dicts of fp32 numpy arrays in the
    Flax layout (Dense kernels ``[in, out]``)."""
    tree: dict = {}
    for path, (p, transpose) in flax_layout(model).items():
        arr = p.detach().float().cpu().numpy()
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = arr.T.copy() if transpose else arr
    return tree


def criterion_tree(criterion: nn.Module) -> dict:
    """The loss's λ as ``{name: 0-dim fp32 array}``."""
    return {name: p.detach().float().cpu().numpy()
            for name, p in criterion.named_parameters()}


@torch.no_grad()
def load_criterion_params(criterion: nn.Module, tree) -> nn.Module:
    """Fill the loss's λ from ``params['criterion']`` of the JAX package."""
    own = dict(criterion.named_parameters())
    if set(own) != set(tree):
        raise KeyError(f"criterion tree has {sorted(tree)}, expected "
                       f"{sorted(own)}")
    for name, p in own.items():
        p.copy_(torch.tensor(np.asarray(tree[name], np.float32)))
    return criterion
