"""Core ViT layers (counterpart of ``gavit_tpu/models/layers.py``).

``eval()`` is the deterministic forward (serving); ``train()`` the training
one, with dropout and drop_path, as JAX's ``deterministic=False``.
Parameters are fp32; each module computes in its ``dtype`` (fp32 or bf16)
the way the JAX modules do: weights cast to the compute dtype at use (so
the gradients reach the fp32 parameters through the cast), LayerNorm
statistics and affine in fp32 with ε=1e-5, outputs rounded to the compute
dtype.

Dropout sites carry fixed ids (``site``; see ``models/vit.py``) and draw
their masks from the step seed passed down the forward, so the backward
regenerates them (``ops/philox.py``).

Dense weights use ``nn.Linear``'s ``[out, in]`` layout (the JAX kernels are
``[in, out]``; ``utils/convert.py`` transposes).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from gavit_tpu_torch.models.moe import MoEMlp
from gavit_tpu_torch.ops import philox
from gavit_tpu_torch.ops.attention import (attention_reference,
                                           fused_qkv_attention)
from gavit_tpu_torch.ops.dropout import fused_dropout, fused_gelu_dropout
from gavit_tpu_torch.ops.mlp import fused_mlp, fused_mlp_inference
from gavit_tpu_torch.ops.quant import (fake_quant_act, fake_quant_weight,
                                       int8_matmul, static_int8_matmul)

LN_EPS = 1e-5
# a quantised Dense's state, as the JAX "quant" collection names it
QUANT_KEYS = ("act_scale", "w_q", "w_scale")


class Dense(nn.Module):
    """``x·Wᵀ + b`` in the compute dtype (the non-quantised ``QDense``), the
    bias added in the GEMM's epilogue before the one rounding to the dtype.

    ``quant`` (``QDense``'s quantised modes, layers.py:60-152):

    * ``'int8'`` with a calibrated state (``w_q`` int8 ``[N, K]``,
      ``w_scale`` fp32 ``[1, N]``, ``act_scale`` an fp32 scalar): static
      PTQ through :func:`~gavit_tpu_torch.ops.quant.static_int8_matmul`;
      without one, dynamic PTQ (:func:`~gavit_tpu_torch.ops.quant.int8_matmul`)
      recording the activation's absmax for calibration (the JAX ``sow``
      into ``quant_stats`` with ``reduce_fn=max``).
    * ``'qat'`` with an ``act_scale``: both operands fake-quantised, the
      activation against the scale, the live weight per output channel, and
      the GEMM in the compute dtype; without one, the absmax recorded and
      the GEMM unquantised (the calibration pass).

    Either way the product is cast to the compute dtype and then gets the
    bias in that dtype, as the JAX ``QDense`` does. The state is held in
    non-persistent buffers (they follow ``.to(device)`` and stay out of
    ``state_dict``); ``utils/convert.py::quant_state`` reads it by the JAX
    "quant" collection's paths.
    """

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, dtype=torch.float32, quant=None,
                 impl: str = "auto", device=None):
        super().__init__()
        self.dtype = dtype
        self.quant = quant
        self.impl = impl
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)
        for name in QUANT_KEYS + ("act_absmax",):
            self.register_buffer(name, None, persistent=False)

    def forward(self, x):
        if self.quant is None:
            bias = None if self.bias is None else self.bias.to(self.dtype)
            return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                            bias)
        y = (self._qat(x) if self.quant == "qat" else self._int8(x))
        y = y.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)

    def _record(self, x):
        m = x.detach().float().abs().amax()
        self.act_absmax = m if self.act_absmax is None else \
            torch.maximum(self.act_absmax, m)

    def _int8(self, x):
        if self.w_q is not None:
            return static_int8_matmul(x, self.w_q, self.w_scale,
                                      self.act_scale, self.impl)
        self._record(x)
        return int8_matmul(x, self.weight, self.impl)

    def _qat(self, x):
        dt = self.dtype
        if self.act_scale is not None:
            return F.linear(fake_quant_act(x.to(dt), self.act_scale),
                            fake_quant_weight(self.weight).to(dt))
        self._record(x)
        return F.linear(x.to(dt), self.weight.to(dt))


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm(epsilon=1e-5, dtype=...)``: fp32 statistics and
    affine, result in the compute dtype."""

    def __init__(self, dim: int, *, dtype=torch.float32, device=None):
        super().__init__(dim, eps=LN_EPS, device=device)
        self.dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(self.dtype)


class Dropout(nn.Module):
    """``FusedDropout`` (layers.py:308-320): kernel F in training mode with
    the step seed and this site's id; the identity in eval mode or at rate
    0."""

    def __init__(self, rate: float, site: int, impl: str = "auto"):
        super().__init__()
        self.rate = rate
        self.site = site
        self.impl = impl

    def forward(self, x, seed):
        if not self.training or self.rate == 0.0:
            return x
        return fused_dropout(x, seed, self.site, self.rate, impl=self.impl)


def drop_path_keep(x, rate: float, training: bool, generator=None):
    """Stochastic depth's per-sample keep mask (layers.py:323-338), drawn
    from ``generator`` (on x's device): ``[B, 1, ...]`` bool, or None where
    nothing is dropped (eval mode or rate 0)."""
    if not training or rate == 0.0:
        return None
    keep = torch.rand(x.shape[0], generator=generator, device=x.device) \
        < 1.0 - rate
    return keep.reshape((-1,) + (1,) * (x.ndim - 1))


def apply_drop_path(x, keep, rate: float):
    """The residual branch ``x`` zeroed for the samples ``keep`` (from
    :func:`drop_path_keep`) drops, the kept ones scaled by 1/(1-rate)."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def drop_path(x, rate: float, training: bool, generator=None):
    """Stochastic depth (layers.py:323-338): drop whole residual branches per
    sample with probability ``rate``, the kept ones scaled by 1/(1-rate).
    The draw comes from ``generator`` (on x's device)."""
    return apply_drop_path(x, drop_path_keep(x, rate, training, generator),
                           rate)


class PatchEmbed(nn.Module):
    """NHWC image ``[B, H, W, C]`` → patch tokens ``[B, N, D]``: a reshape and
    one GEMM, patch features ordered ``(c, ph, pw)`` (layers.py:165-182)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, *,
                 dtype=torch.float32, quant=None, impl: str = "auto",
                 device=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Dense(in_chans * patch_size * patch_size, embed_dim,
                          dtype=dtype, quant=quant, impl=impl, device=device)

    def forward(self, x):
        b, h, w, c = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(
                f"image size {h}x{w} not divisible by patch size {p}")
        gh, gw = h // p, w // p
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
        return self.proj(x.reshape(b, gh * gw, c * p * p))


class HeadMergeProj(Dense):
    """Attention output projection on ``[B, H, N, d]``; the weight is the
    Dense over the merged heads, ``[D, H·d]``. Quantised, it merges the
    heads and then runs the int8 (or fake-quantised) GEMM, as the JAX
    ``HeadMergeProj``'s quant path does (layers.py:365-369)."""

    def forward(self, out4):
        b, h, n, d = out4.shape
        return super().forward(out4.transpose(1, 2).reshape(b, n, h * d))


class Attention(nn.Module):
    """Fused-QKV multi-head self-attention: qkv GEMM → kernel A, K or L on
    the raw rows by sequence length (A′, K′ or L′ in the backward) →
    head-merging output projection → projection dropout (layers.py:425).

    In training with ``attn_drop`` > 0 the attention leaves the kernels, as
    the JAX model's leaves Pallas (layers.py:409-452): the plain
    ``attention_reference`` in tensor ops drops the fp32 probabilities by
    the Philox mask of (step seed, ``attn_site``), element ``((b·H + h)·N
    + i)·N + j`` of ``[B, H, N, N]``; a recompute (``model.remat``) draws
    the same mask.

    ``return_probs`` (the model's ``capture='attention'``) also returns the
    fp32 ``[B, H, N, N]`` probabilities: the attention then takes the plain
    ``attention_reference`` too, as the JAX model's ``return_probs`` does
    (layers.py:410-441), since no kernel materialises them."""

    def __init__(self, dim: int, num_heads: int, *, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 site: int = 0, attn_site: int = 0, dtype=torch.float32,
                 quant=None, impl: str = "auto", device=None):
        super().__init__()
        self.num_heads = num_heads
        self.impl = impl
        self.attn_drop = attn_drop
        self.attn_site = attn_site
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype,
                         quant=quant, impl=impl, device=device)
        self.proj = HeadMergeProj(dim, dim, dtype=dtype, quant=quant,
                                  impl=impl, device=device)
        self.proj_drop = Dropout(proj_drop, site, impl)

    def forward(self, x, seed=None, return_probs: bool = False):
        b, n, c = x.shape
        h = self.num_heads
        hd = c // h
        qkv = self.qkv(x).view(b, n, 3, h, hd)
        dropped = self.training and self.attn_drop > 0.0
        probs = None
        if dropped or return_probs:
            if dropped and seed is None:
                raise ValueError("attention dropout with a rate > 0 needs a "
                                 "seed")
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            keep = (philox.keep_mask((b, h, n, n), seed, self.attn_site,
                                     self.attn_drop, device=x.device)
                    if dropped else None)
            out4 = attention_reference(q, k, v, hd ** -0.5, self.attn_drop,
                                       keep, return_probs=return_probs)
            if return_probs:
                out4, probs = out4
        else:
            out4 = fused_qkv_attention(qkv, hd ** -0.5, merge_heads=False,
                                       impl=self.impl)
        out = self.proj_drop(self.proj(out4), seed)
        return (out, probs) if return_probs else out


class Mlp(nn.Module):
    """fc1 → GELU → fc2 (layers.py:205-305).

    Eval: :func:`fused_mlp_inference`, tanh GELU on the bf16 path and erf on
    fp32. Train: :func:`fused_mlp`, erf GELU with the hidden and output
    dropout sites ``site`` and ``site + 1``: the megakernel (D and D′ on the
    card) where the JAX package's row-block rule finds a block, else the
    chain fc1 (cuBLAS) → GELU + dropout at ``site`` (H and H′) → fc2 →
    dropout at ``site + 1`` (F), as the JAX package's ``Mlp`` falls back.
    Both routes draw their masks from the same (seed, site) pairs, so they
    compute the same function with the same masks; which one runs changes
    the result only by where bf16 rounds (``ops/mlp.py::fused_mlp``).

    Quantised (``quant`` 'int8' or 'qat'), it takes the chain and never
    kernels B, D or D′, as the JAX ``Mlp`` does (its ``not self.quant``
    gate, layers.py:226, and the chain, :282-305): fc1 and fc2 are the
    quantised Dense; between them, in eval, GELU in the compute dtype (tanh
    in bf16, erf in fp32); in training, the erf GELU + dropout of kernel H
    (H′ in the backward) at ``site``, and the output dropout (kernel F) at
    ``site + 1``.
    """

    def __init__(self, dim: int, hidden_dim: int, *, drop: float = 0.0,
                 site: int = 0, dtype=torch.float32, quant=None,
                 impl: str = "auto", device=None):
        super().__init__()
        self.dtype = dtype
        self.quant = quant
        self.impl = impl
        self.drop = drop
        self.sites = (site, site + 1)
        self.fc1 = Dense(dim, hidden_dim, dtype=dtype, quant=quant,
                         impl=impl, device=device)
        self.fc2 = Dense(hidden_dim, dim, dtype=dtype, quant=quant,
                         impl=impl, device=device)

    def _quant_chain(self, x, seed):
        h = self.fc1(x)
        if self.training:
            h = fused_gelu_dropout(h, seed, self.sites[0], self.drop,
                                   self.impl)
        else:
            approx = "tanh" if self.dtype == torch.bfloat16 else "none"
            h = F.gelu(h, approximate=approx)
        y = self.fc2(h)
        if self.training:
            y = fused_dropout(y, seed, self.sites[1], self.drop, self.impl)
        return y

    def forward(self, x, seed=None):
        if self.quant:
            return self._quant_chain(x, seed)
        dt = self.dtype
        args = (x.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt),
                self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        if self.training:
            return fused_mlp(*args, seed, self.sites, self.drop, self.drop,
                             impl=self.impl)
        return fused_mlp_inference(*args, approximate=dt == torch.bfloat16,
                                   impl=self.impl)


class Block(nn.Module):
    """Pre-LN transformer block with stochastic depth (layers.py:459-538).
    Its dropout sites are ``site`` (attention projection), ``site + 1`` and
    ``site + 2`` (the MLP's hidden and output masks), and ``attn_site``
    (attention probabilities, at ``attn_drop`` > 0). With ``moe`` (a
    ``MoEConfig``) the MLP is a mixture of experts, the submodule ``moe``
    in place of ``mlp``, on the same two sites, and stays unquantised under
    ``quant``, as the JAX ``MoEMlp`` does; the attention's GEMMs are
    quantised in every block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, *,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path_rate: float = 0.0,
                 site: int = 0, attn_site: int = 0, dtype=torch.float32,
                 quant=None, impl: str = "auto", moe=None, device=None):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim, dtype=dtype, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              attn_drop=attn_drop, proj_drop=drop, site=site,
                              attn_site=attn_site, dtype=dtype, quant=quant,
                              impl=impl, device=device)
        self.norm2 = LayerNorm(dim, dtype=dtype, device=device)
        if moe is not None:
            self.moe = MoEMlp(moe, dim, int(dim * mlp_ratio), drop=drop,
                              site=site + 1, dtype=dtype, impl=impl,
                              device=device)
        else:
            self.mlp = Mlp(dim, int(dim * mlp_ratio), drop=drop,
                           site=site + 1, dtype=dtype, quant=quant,
                           impl=impl, device=device)

    def forward(self, x, seed=None, generator=None, remat: bool = False,
                return_probs: bool = False):
        """``return_probs``: return ``(x, probs)``, the attention's fp32
        ``[B, H, N, N]`` probabilities beside the output (see
        :class:`Attention`). ``remat``: rematerialise the block in the backward
        (``torch.utils.checkpoint``, the JAX model's ``nn.remat(Block)``):
        only its input is kept, and the backward runs its forward again.
        drop_path's two keep masks are drawn here, before the checkpointed
        part, and handed to it: a checkpoint restores the global RNGs for
        the recompute, not a caller's generator, so a draw inside would
        give the recompute other masks. Dropout needs nothing: its masks
        are a function of (seed, site)."""
        keep = tuple(drop_path_keep(x, self.drop_path_rate, self.training,
                                    generator) for _ in range(2))
        if not remat:
            return self._branches(x, seed, keep, return_probs)
        # the whole block again (no early stop): the recompute launches
        # every kernel of the block once more, a count chip_smoke.py holds
        with set_checkpoint_early_stop(False):
            return checkpoint(self._branches, x, seed, keep, return_probs,
                              use_reentrant=False, preserve_rng_state=False)

    def _branches(self, x, seed, keep, return_probs=False):
        rate = self.drop_path_rate
        attn = self.attn(self.norm1(x), seed, return_probs)
        if return_probs:
            attn, probs = attn
        x = x + apply_drop_path(attn, keep[0], rate)
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        x = x + apply_drop_path(mlp(self.norm2(x), seed), keep[1], rate)
        return (x, probs) if return_probs else x
