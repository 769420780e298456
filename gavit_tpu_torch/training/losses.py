"""Dynamic weighted multi-label loss (counterpart of
``gavit_tpu/training/losses.py``).

A softmax-normalised learnable 3-way combination of weighted BCE-with-logits
(per-class pos_weight), focal loss (γ = 2) and asymmetric loss (γ⁺ = 1,
γ⁻ = 4, probability clamp 1e-8). The three λ are parameters of the
criterion module, trained with the model at ``criterion_lr_scale`` × lr.
Every term is computed in fp32 whatever the logits' dtype.
"""

from __future__ import annotations

import torch
from torch import nn

FOCAL_GAMMA = 2.0
ASL_GAMMA_POS = 1.0
ASL_GAMMA_NEG = 4.0
ASL_CLIP = 1e-8
LAMBDA_NAMES = ("lambda_wbce", "lambda_focal", "lambda_asl")


def _softplus(x):
    """log(1 + exp(x)) exactly (``jax.nn.softplus``, without torch's
    linear cut-off above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def bce_with_logits(x, t, pos_weight=None):
    """Per-element p·t·softplus(-x) + (1-t)·(x + softplus(-x))."""
    sp_neg = _softplus(-x)
    pos = t * sp_neg
    if pos_weight is not None:
        pos = pos * pos_weight.float()
    return pos + (1.0 - t) * (x + sp_neg)


class DynamicWeightedLoss(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        for name in LAMBDA_NAMES:
            self.register_parameter(
                name, nn.Parameter(torch.ones((), device=device)))

    def weights(self):
        """The softmax-normalised (wbce, focal, asl) weights."""
        return torch.softmax(
            torch.stack([getattr(self, n) for n in LAMBDA_NAMES]), dim=0)

    def forward(self, logits, targets, pos_weight=None, *,
                per_example: bool = False):
        """``(total, {'wbce', 'focal', 'asl'})``; the components are
        detached, as the JAX package's ``stop_gradient``. With
        ``per_example`` every value is a ``[B]`` vector (the mean over the
        classes only), whose batch mean is the scalar form."""
        x = logits.float()
        t = targets.float()
        w = self.weights()

        def mean(v):
            return v.mean(-1) if per_example else v.mean()

        wbce = mean(bce_with_logits(x, t, pos_weight))
        bce = bce_with_logits(x, t)
        pt = torch.exp(-bce)
        focal = mean((1.0 - pt) ** FOCAL_GAMMA * bce)
        xs_pos = torch.sigmoid(x)
        xs_neg = 1.0 - xs_pos
        los_pos = t * torch.log(torch.clamp(xs_pos, min=ASL_CLIP)) * (
            (1.0 - xs_pos) ** ASL_GAMMA_POS)
        los_neg = (1.0 - t) * torch.log(torch.clamp(xs_neg, min=ASL_CLIP)) * (
            xs_pos ** ASL_GAMMA_NEG)
        asl = -mean(los_pos + los_neg)
        total = w[0] * wbce + w[1] * focal + w[2] * asl
        return total, {"wbce": wbce.detach(), "focal": focal.detach(),
                       "asl": asl.detach()}
