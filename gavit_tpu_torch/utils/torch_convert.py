"""Weights in the reference's PyTorch state-dict layout (the MAE-pretrained
``vit-b_CXR_0.5M_mae.pth`` of ``configs/baseline_config.yaml``) to and from
the port's modules (counterpart of ``gavit_tpu/utils/torch_convert.py``).

Layout rules (reference key → port parameter):

* ``nn.Linear`` weight ``[out, in]`` → the port's ``Dense`` weight
  ``[out, in]`` as it is (the Flax tree in between holds ``[in, out]``);
* ``patch_embed.proj`` Conv2d ``[D, C, p, p]`` → the patchify GEMM's
  ``[D, C·p·p]`` (the patch extractor orders features channel-major, so the
  reshape is exact), and back;
* ``LayerNorm.weight/bias``, ``cls_token``, ``pos_embed`` → the same;
* the graph blocks, which the reference does not have, as the port names
  them: ``graphs.{j}.norm/value/proj.{weight,bias}``, ``graphs.{j}.gate``
  and, learned-static, ``graphs.{j}.adj_logits`` (the Flax tree's
  ``graph_{j}``).

:func:`torch_state_dict_to_params` gives the Flax-layout tree the JAX
function gives (nested dicts of fp32 numpy arrays; ``graph_{j}`` subtrees
added when the state dict has them), which ``utils/convert.py`` loads.
:func:`load_mae_weights` follows the reference's loader: take
``checkpoint['model']``, drop every key containing ``head``, update the
matching entries non-strictly, skip a shape mismatch with a warning, and
interpolate the position embeddings to the model's grid as
``jax.image.resize(..., 'bilinear')`` does (:func:`interpolate_pos_embed`).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from gavit_tpu_torch.utils.convert import (flatten_tree, flax_layout,
                                           to_flax_tree)

logger = logging.getLogger(__name__)


def _t(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().float().numpy()
    return np.asarray(w, np.float32)


def torch_state_dict_to_params(state_dict: dict, depth: int) -> dict:
    """Reference-layout state dict → the Flax-layout tree (model part)."""
    sd = {k: _t(v) for k, v in state_dict.items()}
    params: dict = {}

    w = sd["patch_embed.proj.weight"]  # [D, C, p, p]
    params["patch_embed"] = {"proj": {"kernel": w.reshape(w.shape[0], -1).T,
                                      "bias": sd["patch_embed.proj.bias"]}}
    params["cls_token"] = sd["cls_token"]
    params["pos_embed"] = sd["pos_embed"]

    def dense(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T,
                "bias": sd[f"{prefix}.bias"]}

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}

    for i in range(depth):
        p = f"blocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": ln(f"{p}.norm1"),
            "attn": {"qkv": dense(f"{p}.attn.qkv"),
                     "proj": dense(f"{p}.attn.proj")},
            "norm2": ln(f"{p}.norm2"),
            "mlp": {"fc1": dense(f"{p}.mlp.fc1"), "fc2": dense(f"{p}.mlp.fc2")},
        }
    j = 0
    while f"graphs.{j}.gate" in sd:
        p = f"graphs.{j}"
        graph = {"norm": ln(f"{p}.norm"), "value": dense(f"{p}.value"),
                 "proj": dense(f"{p}.proj"), "gate": sd[f"{p}.gate"]}
        if f"{p}.adj_logits" in sd:
            graph["adj_logits"] = sd[f"{p}.adj_logits"]
        params[f"graph_{j}"] = graph
        j += 1

    params["norm"] = ln("norm")
    if "head.weight" in sd:
        params["head"] = dense("head")
    return params


def params_to_torch_state_dict(params, *, patch_size: int | None = None,
                               in_chans: int = 3) -> dict:
    """A port model (or its Flax-layout tree) → reference-layout fp32 numpy
    arrays, the patch-embed weight as the reference's Conv2d ``[D, C, p,
    p]`` (a tree needs ``patch_size``; a model gives its own)."""
    if isinstance(params, nn.Module):
        patch_size, in_chans = params.cfg.patch_size, params.cfg.in_chans
        params = to_flax_tree(params)
    if patch_size is None:
        raise ValueError("a Flax-layout tree needs patch_size")
    p, sd = params, {}
    k = _t(p["patch_embed"]["proj"]["kernel"])  # [C*p*p, D]
    sd["patch_embed.proj.weight"] = np.ascontiguousarray(k.T).reshape(
        k.shape[1], in_chans, patch_size, patch_size)
    sd["patch_embed.proj.bias"] = _t(p["patch_embed"]["proj"]["bias"])
    sd["cls_token"] = _t(p["cls_token"])
    sd["pos_embed"] = _t(p["pos_embed"])

    def put_dense(prefix, node):
        sd[f"{prefix}.weight"] = np.ascontiguousarray(_t(node["kernel"]).T)
        sd[f"{prefix}.bias"] = _t(node["bias"])

    def put_ln(prefix, node):
        sd[f"{prefix}.weight"] = _t(node["scale"])
        sd[f"{prefix}.bias"] = _t(node["bias"])

    i = 0
    while f"blocks_{i}" in p:
        b = p[f"blocks_{i}"]
        if "mlp" not in b:
            raise ValueError(f"blocks_{i} has no dense MLP (an MoE block): "
                             "the reference layout has no place for it")
        put_ln(f"blocks.{i}.norm1", b["norm1"])
        put_dense(f"blocks.{i}.attn.qkv", b["attn"]["qkv"])
        put_dense(f"blocks.{i}.attn.proj", b["attn"]["proj"])
        put_ln(f"blocks.{i}.norm2", b["norm2"])
        put_dense(f"blocks.{i}.mlp.fc1", b["mlp"]["fc1"])
        put_dense(f"blocks.{i}.mlp.fc2", b["mlp"]["fc2"])
        i += 1
    j = 0
    while f"graph_{j}" in p:
        g = p[f"graph_{j}"]
        put_ln(f"graphs.{j}.norm", g["norm"])
        put_dense(f"graphs.{j}.value", g["value"])
        put_dense(f"graphs.{j}.proj", g["proj"])
        sd[f"graphs.{j}.gate"] = _t(g["gate"])
        if "adj_logits" in g:
            sd[f"graphs.{j}.adj_logits"] = _t(g["adj_logits"])
        j += 1
    put_ln("norm", p["norm"])
    if "head" in p:
        put_dense("head", p["head"])
    return sd


def _resize_weights(old: int, new: int) -> torch.Tensor:
    """``[old, new]`` weights of ``jax.image.resize``'s linear method along
    one axis (``compute_weight_mat``: the triangle kernel, widened by the
    scale when downsampling, each column normalised, samples outside the
    input zeroed), in fp32."""
    inv_scale = 1.0 / (new / old)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(new, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(old, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= old - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(pos_embed, target_num_patches: int) -> torch.Tensor:
    """Resize the patch-grid part of a ``[1, N+1, D]`` position embedding to
    ``target_num_patches`` tokens, bilinearly as ``jax.image.resize`` does:
    plain interpolation upsampling, a triangle filter widened by the scale
    (antialiased) downsampling. fp32 tensor out."""
    pos_embed = torch.as_tensor(_t(pos_embed))
    n = pos_embed.shape[1] - 1
    if n == target_num_patches:
        return pos_embed
    d = pos_embed.shape[2]
    old = int(round(float(np.sqrt(n))))
    new = int(round(float(np.sqrt(target_num_patches))))
    if old * old != n or new * new != target_num_patches:
        raise ValueError(f"non-square patch grids: {n} → {target_num_patches}")
    w = _resize_weights(old, new)
    grid = pos_embed[0, 1:].reshape(old, old, d).double()
    grid = torch.einsum("hwd,hi,wj->ijd", grid, w.double(), w.double())
    return torch.cat([pos_embed[:, :1],
                      grid.float().reshape(1, new * new, d)], dim=1)


@torch.no_grad()
def load_mae_weights(model: nn.Module, checkpoint_path: str) -> nn.Module:
    """Non-strict pretrained init in place (reference ``vit.py:182-200``):
    every matching non-head entry of ``checkpoint['model']`` replaces the
    model's parameter; the head keeps its init. Returns ``model``."""
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    state_dict = {k: v for k, v in state_dict.items() if "head" not in k}
    converted = (torch_state_dict_to_params(state_dict, model.cfg.depth)
                 if "patch_embed.proj.weight" in state_dict else {})
    layout = flax_layout(model)
    for path, val in flatten_tree(converted).items():
        if path not in layout:
            logger.info(f"MAE load: skipping unexpected {path}")
            continue
        param, transpose = layout[path]
        val = val.T if transpose else val
        if tuple(val.shape) != tuple(param.shape):
            if path == "pos_embed":
                val = interpolate_pos_embed(val, param.shape[1] - 1)
                logger.info("MAE load: interpolated pos_embed")
            else:
                logger.warning(f"MAE load: shape mismatch at {path} "
                               f"{tuple(val.shape)} vs {tuple(param.shape)}; "
                               "skipping")
                continue
        param.copy_(torch.as_tensor(np.asarray(val, np.float32)))
    logger.info(f"Loaded MAE pre-trained weights from {checkpoint_path}")
    return model
