"""The training step (counterpart of the ``grad_accum_steps == 1`` branch of
``gavit_tpu/training/trainer.py::Trainer._build_train_step``, without
pipeline or QAT).

One :meth:`Trainer.train_step` is: uint8 NHWC images → ``train_preprocess``
on the device (flip + colour jitter, draws from the trainer's generator) →
the forward in the model's compute dtype with dropout (the step's Philox
seed) → ``DynamicWeightedLoss`` in fp32, plus the MoE blocks' weighted
auxiliary loss when ``model.moe`` is enabled
(gavit_tpu/training/trainer.py:317-345; reported as ``moe_aux``) → the
backward → global-norm clipping of the model's gradients → the two-group
AdamW update at the schedule's lr for this step (0 at step 0). The
parameters, the λ and the optimizer state are fp32 on the device.

Checkpointing, validation, early stopping, preemption and gradient
accumulation wait for ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import torch

from gavit_tpu_torch.config import Config
from gavit_tpu_torch.ops import philox
from gavit_tpu_torch.ops.preprocess import train_preprocess
from gavit_tpu_torch.training.losses import DynamicWeightedLoss
from gavit_tpu_torch.training.optimizer import (clip_by_global_norm,
                                                make_optimizer)


class Trainer:
    def __init__(self, config: Config, model: torch.nn.Module, pos_weight,
                 steps_per_epoch: int, device=None):
        """``model``: a built ``VisionTransformer`` with fp32 parameters
        (moved to ``device`` here); ``pos_weight``: the per-class WBCE
        weights ``[num_classes]``."""
        tr = config.training
        if tr.grad_accum_steps != 1 or tr.qat:
            raise NotImplementedError(
                "gradient accumulation and QAT wait for ROADMAP Queue 1 "
                "items 6 and 8")
        self.config = config
        self.device = torch.device(device) if device is not None else \
            next(model.parameters()).device
        self.model = model.to(self.device).train()
        self.criterion = DynamicWeightedLoss(device=self.device)
        self.pos_weight = torch.as_tensor(pos_weight, dtype=torch.float32,
                                          device=self.device)
        self.optimizer, self.schedules = make_optimizer(
            config, self.model, self.criterion, steps_per_epoch)
        self.model_params = [p for g in self.optimizer.param_groups
                             if g["role"] == "model" for p in g["params"]]
        self.moe = config.model.moe.enabled
        self.max_grad_norm = tr.max_grad_norm
        self.use_affine = config.data.augment_affine
        self.seed = tr.seed
        # augmentation and drop_path draws, on the device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tr.seed)
        self.step = 0

    def train_step(self, images, labels) -> dict:
        """One optimizer step. ``images``: uint8 ``[B, S, S, 3]`` (augmented
        and normalised here) or already-normalised floats (used as given);
        ``labels``: ``[B, num_classes]``. Returns device tensors: the loss,
        its components (and ``moe_aux``, which the loss includes, for an MoE
        model), the λ weights, the pre-clip gradient norm and the model lr
        of this step."""
        images = images.to(self.device, non_blocking=True)
        labels = labels.to(self.device, non_blocking=True)
        if images.dtype == torch.uint8:
            x = train_preprocess(images, self.generator, self.use_affine)
        else:
            x = images
        lrs = [s(self.step) for s in self.schedules]
        logits = self.model(x, seed=philox.step_seed(self.seed, self.step),
                            generator=self.generator)
        loss, comps = self.criterion(logits, labels, self.pos_weight)
        if self.moe:
            aux = self.model.moe_aux_loss()
            loss = loss + aux
            comps = {**comps, "moe_aux": aux.detach()}
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = None
        if self.max_grad_norm and self.max_grad_norm > 0:
            grad_norm = clip_by_global_norm(self.model_params,
                                            self.max_grad_norm)
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        out = {"loss": loss.detach(), **comps,
               "loss_weights": self.criterion.weights().detach(),
               "lr": lrs[0]}
        if grad_norm is not None:
            out["grad_norm"] = grad_norm
        return out
