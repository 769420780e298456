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
Both take the MAE model (``models/mae.py``) too: its encoder as the ViT's,
and ``decoder_embed``, ``mask_token``, ``decoder_pos_embed``,
``decoder_blocks_{i}``, ``decoder_norm`` and ``decoder_pred`` as the JAX
``MAEViT`` names them.
``load_criterion_params`` / ``criterion_tree`` carry the loss's λ
(``{'lambda_wbce', 'lambda_focal', 'lambda_asl'}``, the JAX package's
``params['criterion']``).

The int8 quant state: :func:`quant_state` / :func:`load_quant_state` read
and set the quantised Dense sites' ``act_scale``, ``w_q`` and ``w_scale``
(``models/layers.py::Dense``) as a flat dict ``{flax module path: {key:
tensor}}``, the paths of the JAX "quant" collection (``blocks_0/attn/qkv``,
``graph_0/value``, ``head``); ``w_q`` is ``[N, K]`` there, as the port's
weights are. :func:`quant_from_flax` / :func:`quant_to_flax` carry a JAX
"quant" tree (nested dicts of numpy arrays, ``w_q`` ``[K, N]``) into that
state and back.

Reading an orbax checkpoint needs JAX and waits for the checkpoint port.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from gavit_tpu_torch.models.layers import QUANT_KEYS, Dense, LayerNorm


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
    ``graph_1``; the MAE decoder's ``decoder_blocks.2`` →
    ``decoder_blocks_2``."""
    name = re.sub(r"^(decoder_)?blocks\.(\d+)", r"\1blocks_\2", name)
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


# ---------------------------------------------------------------------------
# the int8 quant state
# ---------------------------------------------------------------------------


def quant_sites(model: nn.Module) -> dict:
    """``{flax module path: Dense}`` for every quantised Dense of ``model``
    (the sites of the JAX "quant" collection)."""
    return {_flax_module_path(name): mod
            for name, mod in model.named_modules()
            if isinstance(mod, Dense) and mod.quant}


def quant_state(model: nn.Module, keys=QUANT_KEYS) -> dict:
    """The sites' state that is set, ``{path: {key: tensor}}`` (empty where
    nothing is calibrated)."""
    out = {}
    for path, mod in quant_sites(model).items():
        node = {k: getattr(mod, k) for k in keys
                if getattr(mod, k) is not None}
        if node:
            out[path] = node
    return out


@torch.no_grad()
def load_quant_state(model: nn.Module, state: dict) -> nn.Module:
    """Set the sites' state from ``{path: {key: tensor}}`` (copied to each
    site's device; ``act_scale`` alone for QAT, all three keys for static
    int8). Every site not in ``state`` is cleared. Strict: a path that is
    no quantised site, an unknown key, or a shape that does not fit the
    site's weight raises."""
    sites = quant_sites(model)
    unknown = sorted(set(state) - set(sites))
    if unknown:
        raise KeyError(f"quant state for {unknown}: no such quantised site "
                       f"(the model has {sorted(sites)})")
    for path, mod in sites.items():
        node = state.get(path, {})
        bad = sorted(set(node) - set(QUANT_KEYS))
        if bad:
            raise KeyError(f"{path}: unknown quant keys {bad}")
        n, k = mod.weight.shape
        want = {"act_scale": (), "w_q": (n, k), "w_scale": (1, n)}
        dev = mod.weight.device
        for key in QUANT_KEYS:
            val = node.get(key)
            if val is not None:
                val = torch.as_tensor(val)
                if tuple(val.shape) != want[key]:
                    raise ValueError(f"{path}/{key}: shape "
                                     f"{tuple(val.shape)}, expected "
                                     f"{want[key]}")
                val = val.to(device=dev, dtype=(
                    torch.int8 if key == "w_q" else torch.float32))
            setattr(mod, key, val)
    return model


def quant_from_flax(tree) -> dict:
    """A JAX "quant" tree (nested dicts of arrays) → the port's quant state
    (``w_q`` transposed to ``[N, K]``)."""
    out: dict = {}
    for path, arr in flatten_tree(tree).items():
        site, _, key = path.rpartition("/")
        arr = np.array(arr.T if key == "w_q" else arr, order="C")
        out.setdefault(site, {})[key] = torch.from_numpy(arr)
    return out


def quant_to_flax(state: dict) -> dict:
    """The port's quant state → a JAX "quant" tree of numpy arrays
    (``w_q`` ``[K, N]`` int8, ``w_scale`` ``[1, N]`` and ``act_scale`` fp32)."""
    tree: dict = {}
    for path, node in state.items():
        parent = tree
        for key in path.split("/"):
            parent = parent.setdefault(key, {})
        for key, val in node.items():
            arr = torch.as_tensor(val).detach().cpu().numpy()
            parent[key] = arr.T.copy() if key == "w_q" else arr
    return tree
