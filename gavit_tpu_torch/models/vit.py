"""Graph-augmented Vision Transformer (counterpart of
``gavit_tpu/models/vit.py``), deterministic forward.

NHWC images in (already normalised), the image cast to the compute dtype
before patchify → +CLS → +position embeddings → blocks, with graph blocks
after the configured blocks → final LayerNorm → CLS → head → fp32 logits.
"""

from __future__ import annotations

import torch
from torch import nn

from gavit_tpu.config import ModelConfig
from gavit_tpu_torch.models.graph import GraphBlock
from gavit_tpu_torch.models.layers import (
    Block,
    Dense,
    LayerNorm,
    PatchEmbed,
)

PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16}


class VisionTransformer(nn.Module):
    """ViT backbone with interleaved graph blocks.

    ``attn_impl`` / ``graph_impl`` / ``mlp_impl``: ``'auto'`` launches the
    Hopper kernels on CUDA tensors and takes the plain versions on CPU
    tensors; ``'reference'`` always takes the plain versions.
    """

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 attn_impl: str = "auto", graph_impl: str = "auto",
                 mlp_impl: str = "auto", device=None):
        super().__init__()
        if cfg.moe.enabled:
            raise NotImplementedError(
                "MoE blocks wait for ROADMAP Queue 1 item 11")
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, d,
                                      dtype=dtype, device=device)
        n = cfg.num_patches
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, d, device=device))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                  dtype=dtype, attn_impl=attn_impl, mlp_impl=mlp_impl,
                  device=device)
            for _ in range(cfg.depth)
        )
        # a set, as in the JAX model: two blocks placed at one site are one
        self.graph_sites = tuple(sorted(set(cfg.graph_insert_after())))
        self.graphs = nn.ModuleList(
            GraphBlock(d, cfg.graph, dtype=dtype, impl=graph_impl,
                       device=device)
            for _ in self.graph_sites
        )
        self.norm = LayerNorm(d, dtype=dtype, device=device)
        self.head = Dense(d, cfg.num_classes, dtype=dtype, device=device)

    def forward(self, x):
        """``[B, H, W, C]`` normalised images → ``[B, num_classes]`` fp32."""
        dt = self.dtype
        x = self.patch_embed(x.to(dt))
        b, _, d = x.shape
        cls = self.cls_token.to(dt).expand(b, 1, d)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        graphs = dict(zip(self.graph_sites, self.graphs))
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in graphs:
                x = graphs[i](x)
        x = self.norm(x)
        return self.head(x[:, 0]).float()


def build_model(cfg: ModelConfig, *, precision: str = "fp32",
                attn_impl: str = "auto", graph_impl: str = "auto",
                mlp_impl: str = "auto", device=None) -> VisionTransformer:
    """``precision``: ``'fp32'`` (parity) or ``'bf16'`` (serving). The
    parameters are fp32 either way; ``init_params`` fills them."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, "
                         f"not {precision!r}")
    return VisionTransformer(
        cfg, dtype=PRECISIONS[precision], attn_impl=attn_impl,
        graph_impl=graph_impl, mlp_impl=mlp_impl, device=device,
    )


@torch.no_grad()
def init_params(model: VisionTransformer, generator: torch.Generator):
    """The JAX package's initialisers: truncated normal (σ=0.02, cut at ±2σ)
    for Dense kernels, CLS and position embeddings; Xavier uniform for the
    patch projection; zeros for biases and graph gates; LayerNorm scale 1.

    The draws come from ``generator`` on the CPU and are copied to the
    parameters' device, so a seed gives the same weights on every device.
    """

    def fill(p, draw):
        cpu = torch.empty(p.shape, dtype=torch.float32)
        draw(cpu)
        p.copy_(cpu)

    def trunc(t):
        nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                              generator=generator)

    for name, mod in model.named_modules():
        if isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, Dense):
            if mod is model.patch_embed.proj:
                fill(mod.weight, lambda t: nn.init.xavier_uniform_(
                    t, generator=generator))
            else:
                fill(mod.weight, trunc)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, GraphBlock):
            mod.gate.zero_()
    fill(model.cls_token, trunc)
    fill(model.pos_embed, trunc)
    return model


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
