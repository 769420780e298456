"""Graph-augmented Vision Transformer (counterpart of
``gavit_tpu/models/vit.py``).

NHWC images in (already normalised), the image cast to the compute dtype
before patchify → +CLS → +position embeddings → embedding dropout → blocks
(stochastic depth linearly spaced over depth), with graph blocks after the
configured blocks → final LayerNorm → CLS → head → fp32 logits. The
blocks of ``cfg.moe_sites()`` carry a mixture-of-experts MLP
(``models/moe.py``); :meth:`VisionTransformer.moe_aux_loss` reads the
summed, config-weighted auxiliary loss of the last training forward.

``eval()`` (the state ``build_model`` returns) is the deterministic
forward. In ``train()`` mode the forward takes the step's dropout seed
(``ops/philox.py::step_seed``) and a generator for drop_path; every dropout
site has a fixed id (:func:`dropout_sites`), so the backward regenerates its
mask. With ``model.remat`` a training forward keeps only each transformer
block's input and recomputes the block in the backward (the same numbers,
less memory: the 1024-px step).
"""

from __future__ import annotations

import torch
from torch import nn

from gavit_tpu_torch.config import ModelConfig
from gavit_tpu_torch.models.graph import GraphBlock
from gavit_tpu_torch.models.moe import MoEMlp
from gavit_tpu_torch.models.layers import (
    Block,
    Dense,
    Dropout,
    LayerNorm,
    Mlp,
    PatchEmbed,
)

# int8: bf16 everywhere but the quantised GEMMs (vit.py:158-173)
PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.bfloat16}


def dropout_sites(depth: int, n_graph: int) -> dict:
    """The fixed site ids of the model's dropout masks: the embedding 0;
    block i's attention projection 1+3i and its MLP's hidden and output
    masks 2+3i and 3+3i; graph block j's projection 1+3·depth+j."""
    sites = {"embed": 0}
    for i in range(depth):
        sites[f"blocks.{i}.attn"] = 1 + 3 * i
        sites[f"blocks.{i}.mlp"] = (2 + 3 * i, 3 + 3 * i)
    for j in range(n_graph):
        sites[f"graphs.{j}"] = 1 + 3 * depth + j
    return sites


def attention_probs_sites(depth: int, n_graph: int) -> list[int]:
    """The site of block i's attention-probability mask (``attn_drop_rate``
    > 0): 1+3·depth+n_graph+i, past every id of :func:`dropout_sites`, so
    no other mask moves."""
    return [1 + 3 * depth + n_graph + i for i in range(depth)]


class VisionTransformer(nn.Module):
    """ViT backbone with interleaved graph blocks.

    ``impl``, for every op of the model: ``'auto'`` launches the Hopper
    kernels on CUDA tensors and takes the plain versions on CPU tensors;
    ``'reference'`` always takes the plain versions.

    ``quant``: None, ``'int8'`` (serving PTQ) or ``'qat'`` (fake-quantised
    GEMMs for quantisation-aware training), at every GEMM the JAX model
    quantises: the patch projection, each block's qkv, attention
    projection, fc1 and fc2 (not an MoE block's experts), each graph
    block's value and projection, and the head (``layers.py::Dense``).
    """

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 quant=None, impl: str = "auto", device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.quant = quant
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, d,
                                      dtype=dtype, quant=quant, impl=impl,
                                      device=device)
        n = cfg.num_patches
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, d, device=device))
        # a set, as in the JAX model: two blocks placed at one site are one
        self.graph_sites = tuple(sorted(set(cfg.graph_insert_after())))
        sites = dropout_sites(cfg.depth, len(self.graph_sites))
        attn_sites = attention_probs_sites(cfg.depth, len(self.graph_sites))
        self.pos_drop = Dropout(cfg.drop_rate, sites["embed"], impl)
        dpr = [cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
               for i in range(cfg.depth)]
        moe_sites = set(cfg.moe_sites())
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
                  drop=cfg.drop_rate, attn_drop=cfg.attn_drop_rate,
                  drop_path_rate=dpr[i], site=sites[f"blocks.{i}.attn"],
                  attn_site=attn_sites[i], dtype=dtype, quant=quant,
                  impl=impl, moe=cfg.moe if i in moe_sites else None,
                  device=device)
            for i in range(cfg.depth)
        )
        self.graphs = nn.ModuleList(
            GraphBlock(d, cfg.graph, num_patches=n, drop=cfg.drop_rate,
                       site=sites[f"graphs.{j}"], dtype=dtype,
                       quant=quant, impl=impl, device=device)
            for j in range(len(self.graph_sites))
        )
        self.norm = LayerNorm(d, dtype=dtype, device=device)
        self.head = Dense(d, cfg.num_classes, dtype=dtype, quant=quant,
                          impl=impl, device=device)

    def set_quant(self, quant) -> "VisionTransformer":
        """Switch every quantised site (and the MLPs' route) to ``quant``
        (None, 'int8' or 'qat'), as the JAX model's ``clone(quant=...)``
        does; the parameters and any quant state stay."""
        self.quant = quant
        for mod in self.modules():
            if isinstance(mod, (Dense, Mlp)):
                mod.quant = quant
        return self

    def forward(self, x, seed: int | None = None, generator=None,
                capture: str | None = None, token_probe: tuple | None = None):
        """``[B, H, W, C]`` normalised images → ``[B, num_classes]`` fp32.

        ``seed``: the step's 64-bit dropout seed, needed in training mode
        when ``drop_rate > 0``. ``generator``: drop_path's draws (training
        mode, ``drop_path_rate > 0``).

        The JAX model's interpretability hooks (vit.py:52-70, :117-138):
        ``capture='tokens'`` returns ``(logits, list)`` with each block's
        output (after the probe, before any graph block at that site);
        ``capture='attention'`` returns ``(logits, list)`` with each block's
        fp32 ``[B, H, N, N]`` attention probabilities, from the plain
        attention (:class:`~gavit_tpu_torch.models.layers.Attention`).
        ``token_probe=(i, probe)`` adds ``probe`` to block ``i``'s output
        (``i`` modulo the depth), before any graph block there: its
        gradient is the gradient with respect to those tokens (Grad-CAM,
        ``utils/gradcam.py``)."""
        if capture not in (None, "tokens", "attention"):
            raise ValueError(f"capture must be None, 'tokens' or "
                             f"'attention', not {capture!r}")
        probe_index = (None if token_probe is None
                       else token_probe[0] % self.cfg.depth)
        captured = []
        dt = self.dtype
        x = self.patch_embed(x.to(dt))
        b, _, d = x.shape
        cls = self.cls_token.to(dt).expand(b, 1, d)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        x = self.pos_drop(x, seed)
        graphs = dict(zip(self.graph_sites, self.graphs))
        # model.remat: each transformer block (not the graph blocks, as in
        # the JAX model) rematerialised in the backward of a training step
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        # the static graph (graph.dynamic false): the first graph block's
        # adjacency, reused by the later ones
        static = not self.cfg.graph.dynamic
        adj = None
        for i, block in enumerate(self.blocks):
            x = block(x, seed, generator, remat=remat,
                      return_probs=capture == "attention")
            if capture == "attention":
                x, probs = x
                captured.append(probs)
            if i == probe_index:
                x = x + token_probe[1].to(x.dtype)
            if capture == "tokens":
                captured.append(x)
            if i in graphs:
                x, built = graphs[i](x, seed, adj=adj if static else None)
                if static and adj is None:
                    adj = built
        x = self.norm(x)
        logits = self.head(x[:, 0]).float()
        return logits if capture is None else (logits, captured)

    def reads_host(self, batch: int) -> str | None:
        """Why a forward on ``batch`` images reads the host (a CUDA graph
        cannot capture it, nor ``torch.export`` trace it), decided from
        shapes alone, else None: an MoE block whose engine's plain versions
        read their group sizes there (:meth:`MoEMlp.reads_host`)."""
        tokens = self.cfg.num_patches + 1  # patches + CLS
        cuda = self.pos_embed.is_cuda
        if any(hasattr(b, "moe") and b.moe.reads_host(batch, tokens, cuda)
               for b in self.blocks):
            return ("the grouped MoE engine's plain versions read the group "
                    "sizes on the host")
        return None

    def moe_aux_loss(self):
        """The sum of the MoE blocks' config-weighted auxiliary losses
        (load balance and router z) of the last training forward; an fp32
        zero when there is none (no MoE block, or an eval forward)."""
        losses = [b.moe.aux_loss for b in self.blocks
                  if hasattr(b, "moe") and b.moe.aux_loss is not None]
        if not losses:
            return torch.zeros((), device=self.pos_embed.device)
        return torch.stack(losses).sum()


def build_model(cfg: ModelConfig, *, precision: str = "fp32",
                impl: str = "auto", qat: bool = False,
                device=None) -> VisionTransformer:
    """``precision``: ``'fp32'`` (parity), ``'bf16'`` (serving and
    training) or ``'int8'`` (PTQ serving: int8 GEMMs, bf16 elsewhere).
    ``qat``: quantisation-aware training, every GEMM the int8 path
    quantises fake-quantised against the same static scales. The
    parameters are fp32 either way; ``init_params`` fills them. The model
    comes back in eval mode (deterministic, as the JAX model's default);
    ``train()`` switches dropout and drop_path on."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, "
                         f"not {precision!r}")
    quant = "int8" if precision == "int8" else ("qat" if qat else None)
    return VisionTransformer(
        cfg, dtype=PRECISIONS[precision], quant=quant, impl=impl,
        device=device,
    ).eval()


@torch.no_grad()
def init_params(model: VisionTransformer, generator: torch.Generator):
    """The JAX package's initialisers: truncated normal (σ=0.02, cut at ±2σ)
    for Dense kernels, MoE routers and expert kernels, CLS and position
    embeddings; Xavier uniform for the patch projection; zeros for biases
    (the expert banks' too), graph gates and learned-static adjacency
    logits; LayerNorm scale 1. Takes the MAE model too (``models/mae.py``:
    its mask token and decoder position embeddings truncated normal).

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
        elif isinstance(mod, MoEMlp):
            for p in (mod.router, mod.fc1_kernel, mod.fc2_kernel):
                fill(p, trunc)
            mod.fc1_bias.zero_()
            mod.fc2_bias.zero_()
        elif isinstance(mod, GraphBlock):
            mod.gate.zero_()
            if mod.adj_logits is not None:
                mod.adj_logits.zero_()
    # the model's own parameters in their order: the CLS token and the
    # position embeddings (and the MAE's mask token and decoder position
    # embeddings, models/mae.py)
    for p in model.parameters(recurse=False):
        fill(p, trunc)
    return model


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
