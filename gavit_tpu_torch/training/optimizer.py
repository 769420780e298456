"""Two-group AdamW with model-only gradient clipping (counterpart of
``gavit_tpu/training/optimizer.py``).

``torch.optim.AdamW`` over the model's parameters at lr and the criterion's
λ at ``criterion_lr_scale`` · lr, each on its own warmup-cosine schedule,
β = (beta1, beta2), ε and decoupled weight decay from the config. With
``weight_decay_all_params`` (the default, as torch AdamW and the reference)
every parameter decays; otherwise biases, LayerNorm scales, graph gates,
the CLS token, the position embeddings, every ``*_bias`` (the MoE expert
banks' ``[E, F]`` biases too) and every parameter with fewer than two
dimensions (the λ included) are exempt, as the JAX package's mask is.
The model's gradients are clipped to ``max_grad_norm`` by their global norm
before the update, as ``optax.clip_by_global_norm`` does; the λ are not.

:func:`make_mae_optimizer` is MAE pretraining's (scripts/pretrain_mae.py:
93-102): one group, weight decay on every parameter (optax's ``adamw``
there has no mask), the gradients clipped to a global norm of 1.0 first.
"""

from __future__ import annotations

import torch
from torch import nn

from gavit_tpu_torch.config import Config
from gavit_tpu_torch.training.schedule import warmup_cosine_schedule

_EXEMPT = ("cls_token", "pos_embed", "gate")


def decays(name: str, p: torch.Tensor) -> bool:
    """The JAX mask's rule for one parameter (weight_decay_all_params off,
    gavit_tpu/training/optimizer.py:37-50): LayerNorm weights and Dense
    biases are 1-D, so ``ndim >= 2`` covers them; the expert banks'
    ``fc1_bias``/``fc2_bias`` are 2-D and exempt by name."""
    leaf = name.rpartition(".")[2]
    return (p.ndim >= 2 and leaf not in _EXEMPT
            and not leaf.endswith("_bias"))


def make_optimizer(cfg: Config, model: nn.Module, criterion: nn.Module,
                   steps_per_epoch: int):
    """``(optimizer, schedules)``: the AdamW over the groups, and per group
    the function step → lr that the train step applies before each update.
    Group 0 (and 1, when decay is masked) holds the model, the last group
    the criterion."""
    tr, op = cfg.training, cfg.optimizer
    total = steps_per_epoch * tr.epochs
    warmup = steps_per_epoch * tr.warmup_epochs
    model_lr = warmup_cosine_schedule(tr.learning_rate, warmup, total)
    crit_lr = warmup_cosine_schedule(
        tr.learning_rate * tr.criterion_lr_scale, warmup, total)
    named = list(model.named_parameters())
    if tr.weight_decay_all_params:
        groups = [{"params": [p for _, p in named],
                   "weight_decay": tr.weight_decay, "role": "model"}]
        crit_wd = tr.weight_decay
    else:
        groups = [
            {"params": [p for n, p in named if decays(n, p)],
             "weight_decay": tr.weight_decay, "role": "model"},
            {"params": [p for n, p in named if not decays(n, p)],
             "weight_decay": 0.0, "role": "model"},
        ]
        crit_wd = 0.0  # the λ are 0-dim
    groups.append({"params": list(criterion.parameters()),
                   "weight_decay": crit_wd, "role": "criterion"})
    for g in groups:
        g["lr"] = 0.0
    opt = torch.optim.AdamW(groups, lr=0.0, betas=(op.beta1, op.beta2),
                            eps=op.eps)
    schedules = [model_lr if g["role"] == "model" else crit_lr
                 for g in groups]
    return opt, schedules


MAE_MAX_GRAD_NORM = 1.0  # optax.clip_by_global_norm(1.0), pretrain_mae.py


def make_mae_optimizer(cfg: Config, model: nn.Module, steps_per_epoch: int):
    """``(optimizer, schedule)`` of MAE pretraining: AdamW over every
    parameter of ``model`` in one group with ``training.weight_decay``, β
    and ε from the config, and the warmup-cosine schedule (warmup
    ``warmup_epochs`` epochs, ``epochs`` epochs in all) that the step sets
    as the lr before each update, read at the count of updates before it,
    as optax reads it. Clip with :func:`clip_by_global_norm` at
    :data:`MAE_MAX_GRAD_NORM` first."""
    tr, op = cfg.training, cfg.optimizer
    schedule = warmup_cosine_schedule(
        tr.learning_rate, steps_per_epoch * tr.warmup_epochs,
        steps_per_epoch * tr.epochs)
    opt = torch.optim.AdamW(list(model.parameters()), lr=0.0,
                            betas=(op.beta1, op.beta2), eps=op.eps,
                            weight_decay=tr.weight_decay)
    return opt, schedule


@torch.no_grad()
def global_norm(params):
    """The global norm of the gradients of ``params`` as a device tensor
    (``optax.global_norm``)."""
    grads = [p.grad for p in params if p.grad is not None]
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float):
    """Scale the gradients of ``params`` by max_norm / ‖g‖ when their
    global norm ‖g‖ is at least max_norm (``optax.clip_by_global_norm``);
    returns ‖g‖ as a device tensor (no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = global_norm(params)
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm
