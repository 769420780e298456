"""Masked-autoencoder (MAE) pretraining for the ViT backbone (counterpart of
``gavit_tpu/models/mae.py``).

The encoder is the production trunk: the same ``PatchEmbed`` and ``Block``
modules under the same names (``patch_embed``, ``cls_token``,
``pos_embed``, ``blocks.{i}``, ``norm``), so its weights carry over to
:class:`~gavit_tpu_torch.models.vit.VisionTransformer` by name and every
kernel of the trunk trains the MAE too. The decoder (``decoder_embed``,
``mask_token``, ``decoder_pos_embed``, ``decoder_blocks.{i}``,
``decoder_norm``, ``decoder_pred``) is dropped after pretraining;
:func:`export_reference_pth` writes the encoder as the reference-layout
``.pth`` that ``model.pretrained_path``
(``utils/torch_convert.py::load_mae_weights``) loads.

The mask count is fixed by the config (``n_keep = round(N·(1 −
mask_ratio))``, at least 1), and masking is a stable argsort of uniform
noise the caller draws, so the forward is a function of its inputs.

Every block runs deterministic, as the JAX MAE calls each ``Block`` with
``deterministic=True`` (mae.py:107, :128): :meth:`MAEViT.train` keeps the
blocks in eval mode, so the MLPs take :func:`fused_mlp_inference` (kernel
B on a CUDA bf16 tensor, tanh GELU in bf16, erf in fp32) with its chain
backward, and never the training kernels D/D′ with their erf GELU.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gavit_tpu_torch.config import ModelConfig
from gavit_tpu_torch.models.layers import Block, Dense, LayerNorm, PatchEmbed
from gavit_tpu_torch.models.vit import PRECISIONS
from gavit_tpu_torch.utils.convert import to_flax_tree
from gavit_tpu_torch.utils.torch_convert import params_to_torch_state_dict

_ENCODER = ("patch_embed", "cls_token", "pos_embed", "norm")


def random_masking(x, noise, n_keep: int):
    """Shuffle-split masking (mae.py:36-53): keep the ``n_keep`` tokens with
    the smallest noise, in noise order.

    ``x`` ``[B, N, D]``, ``noise`` ``[B, N]`` uniform → ``(x_vis [B, n_keep,
    D], mask [B, N] in x's dtype, 1 = masked, ids_restore [B, N])``; the
    sorts are stable, as ``jnp.argsort``."""
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :n_keep]
    x_vis = torch.gather(x, 1, ids_keep[..., None].expand(-1, -1, x.shape[-1]))
    mask = torch.ones(noise.shape, dtype=x.dtype, device=x.device)
    mask[:, :n_keep] = 0.0
    return x_vis, torch.gather(mask, 1, ids_restore), ids_restore


def patchify(images, patch_size: int):
    """NHWC ``[B, H, W, C]`` → ``[B, N, C·p·p]``, each patch ordered ``(c,
    ph, pw)`` as :class:`PatchEmbed` orders it (mae.py:56-63)."""
    b, h, w, c = images.shape
    p = patch_size
    x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


class MAEViT(nn.Module):
    """The production encoder trunk on the visible tokens plus a light
    decoder over every token (mae.py:66-133). ``forward(images, noise)``
    → ``(pred [B, N, C·p·p] fp32, mask [B, N] fp32)``; combine with
    :func:`mae_loss`. ``dtype`` is the compute dtype; the parameters are
    fp32. ``impl`` as the ViT's: ``'auto'`` launches the Hopper kernels on
    CUDA tensors, ``'reference'`` takes the plain versions."""

    def __init__(self, cfg: ModelConfig, *, decoder_dim: int = 512,
                 decoder_depth: int = 4, decoder_heads: int = 8,
                 mask_ratio: float = 0.75, dtype=torch.float32,
                 impl: str = "auto", device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d, p, n = cfg.embed_dim, cfg.patch_size, cfg.num_patches
        self.n_keep = max(1, int(round(n * (1.0 - mask_ratio))))
        kw = dict(dtype=dtype, impl=impl, device=device)
        self.patch_embed = PatchEmbed(p, cfg.in_chans, d, **kw)
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, d, device=device))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, qkv_bias=cfg.qkv_bias, **kw)
            for _ in range(cfg.depth))
        self.norm = LayerNorm(d, dtype=dtype, device=device)
        dd = decoder_dim
        self.decoder_embed = Dense(d, dd, **kw)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dd, device=device))
        self.decoder_pos_embed = nn.Parameter(
            torch.zeros(1, n + 1, dd, device=device))
        self.decoder_blocks = nn.ModuleList(
            Block(dd, decoder_heads, cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                  **kw)
            for _ in range(decoder_depth))
        self.decoder_norm = LayerNorm(dd, dtype=dtype, device=device)
        self.decoder_pred = Dense(dd, cfg.in_chans * p * p, **kw)

    def train(self, mode: bool = True) -> "MAEViT":
        """Every block stays deterministic (eval mode) in training too, as
        the JAX MAE runs them (module docstring)."""
        super().train(mode)
        for block in (*self.blocks, *self.decoder_blocks):
            block.eval()
        return self

    def forward(self, images, noise):
        dt = self.dtype
        x = self.patch_embed(images.to(dt))
        b, n, d = x.shape
        x = x + self.pos_embed[:, 1:].to(dt)
        x_vis, mask, ids_restore = random_masking(x, noise, self.n_keep)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(dt).expand(b, 1, d)
        x = torch.cat([cls, x_vis], dim=1)
        for block in self.blocks:
            x = block(x)
        x = self.decoder_embed(self.norm(x))
        dd = x.shape[-1]
        masked = self.mask_token.to(dt).expand(b, n - self.n_keep, dd)
        full = torch.cat([x[:, 1:], masked], dim=1)  # no CLS
        full = torch.gather(full, 1,
                            ids_restore[..., None].expand(-1, -1, dd))
        full = torch.cat([x[:, :1], full], dim=1)  # the CLS back
        full = full + self.decoder_pos_embed.to(dt)
        for block in self.decoder_blocks:
            full = block(full)
        pred = self.decoder_pred(self.decoder_norm(full))[:, 1:]
        return pred.float(), mask.float()


def build_mae(cfg: ModelConfig, *, precision: str = "fp32",
              impl: str = "auto", device=None, **decoder) -> MAEViT:
    """:class:`MAEViT` computing in ``precision`` ('fp32' or 'bf16');
    ``decoder``: ``decoder_dim``, ``decoder_depth``, ``decoder_heads``,
    ``mask_ratio``. ``models/vit.py::init_params`` fills the parameters
    as it fills the ViT's (the mask token and the decoder position
    embeddings truncated normal, as the CLS token)."""
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"MAE precision must be 'fp32' or 'bf16', not "
                         f"{precision!r}")
    return MAEViT(cfg, dtype=PRECISIONS[precision], impl=impl,
                  device=device, **decoder)


def mae_loss(pred, images_f32, mask, patch_size: int, norm_pix: bool = True):
    """Mean squared error over the masked patches only, in fp32, against
    per-patch normalised targets (mae.py:136-145): the population variance
    (``correction=0``, as ``jnp.var``) plus 1e-6, the mean over the masked
    patches with the count clamped at 1."""
    target = patchify(images_f32.float(), patch_size)
    if norm_pix:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, correction=0)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    per_patch = ((pred - target) ** 2).mean(dim=-1)
    return (per_patch * mask).sum() / mask.sum().clamp(min=1.0)


def encoder_params(params: dict) -> dict:
    """The encoder's entries (mae.py:148-153), named as
    ``VisionTransformer``'s: of the port's state dict (``blocks.0.…``)
    or of a Flax-layout tree (``blocks_0``); the decoder and the mask token
    stay behind."""
    return {k: v for k, v in params.items()
            if k.split(".")[0] in _ENCODER
            or k.startswith(("blocks.", "blocks_"))}


def reference_state_dict(model: MAEViT) -> dict:
    """The encoder in the reference's layout: ``{key: fp32 tensor}``, the
    patch projection as the Conv2d ``[D, C, p, p]``
    (``utils/torch_convert.py::params_to_torch_state_dict``)."""
    sd = params_to_torch_state_dict(
        encoder_params(to_flax_tree(model)), patch_size=model.cfg.patch_size,
        in_chans=model.cfg.in_chans)
    return {k: torch.from_numpy(np.array(v, np.float32, copy=True))
            for k, v in sd.items()}


def export_reference_pth(model: MAEViT, path: str) -> str:
    """Write the encoder as a reference-layout ``.pth``, ``{"model":
    state_dict}`` (mae.py:156-175): what ``configs/baseline_config.yaml``'s
    ``pretrained_path`` names, loaded by this port's and the JAX package's
    ``load_mae_weights``. Returns ``path``."""
    torch.save({"model": reference_state_dict(model)}, path)
    return path
