"""The training loop (counterpart of ``gavit_tpu/training/trainer.py``,
without pipeline parallelism or the mesh).

One :meth:`Trainer.train_step` is: uint8 NHWC images → ``train_preprocess``
on the device (flip + colour jitter, draws from the trainer's generator) →
split into ``training.grad_accum_steps`` equal micro-batches, each run
forward in the model's compute dtype with dropout (micro-batch i of step s
takes the Philox seed ``step_seed(seed, s·accum + i)``, so at accum 1 every
mask is the step's own) → ``DynamicWeightedLoss`` in fp32, plus the MoE
blocks' weighted auxiliary loss when ``model.moe`` is enabled (reported as
``moe_aux``) → the backward, the gradients of the model and the λ summed
over the micro-batches in fp32 and divided by their count → global-norm
clipping of the model's gradients → one two-group AdamW update at the
schedule's lr for this step (0 at step 0). The loss and its components are
the micro-batch means. The parameters, the λ and the optimizer state are
fp32 on the device.

Around it, as the JAX Trainer: :meth:`train_epoch` (the loader's seeded
epoch order, ``data.prefetch`` batches in flight on the device
(``data/loader.py::device_iterator``), the time each step waited on the
loader; the step metrics read back to the host once every
``training.steps_per_call`` steps, the counterpart of the JAX package's
multi-step dispatch; the train metric battery over the epoch's
predictions), :meth:`validate` (:meth:`predict`'s eval forward, per-example losses
averaged over every row), :meth:`save_checkpoint` /
:meth:`restore_checkpoint` (``utils/checkpoint.py``: parameters, λ, AdamW
state, schedule step, generator state, epoch, best AUC and epoch, patience
counter; a mid-epoch save is marked incomplete and, with the loader's
position (snapshot once per consumed batch, ``data/loader.py``) saved
with it, resumes its epoch on the next unseen batch), and
:meth:`train` (``eval_freq``, ``save_freq``, best-AUC checkpoints, early
stopping after ``early_stopping_patience`` epochs without a better AUC,
SIGTERM → a mid-epoch save and a clean return). ``min_delta`` is read and,
as in the JAX Trainer, not applied: any higher AUC is better.

QAT (``training.qat``): the Trainer switches the model it is given to
QAT (``set_quant('qat')``, as the JAX Trainer clones it), so its quantised
GEMMs are fake-quantised (``models/layers.py::Dense``) against static activation scales calibrated
once, at construction, on the first 8 images of the train set through the
validation preprocessing on the initial weights (:meth:`_calibrate_qat`,
the JAX Trainer's, trainer.py:695-720). The scales are frozen for the run,
held by the model's sites (so ``train_step``, ``validate`` and ``predict``
run under them), saved in each checkpoint's state (``quant``, flagged
``has_quant`` in ``meta.json``) and adopted on restore, so a resumed run
and the int8 serving export (``serving.py::export_quant``) see the run's
noise model.

``training.precision: fp32`` on a card pins TF32 off (process-wide) and
runs through the kernels' fp32 bodies: A and A′ up to 416 tokens, K and
K′ up to 708, L and L′ past it, C, and the MLP's GEMM chain with H, H′ and
F (D/D′ are bf16 only, as the JAX package finds no fp32 row block at ViT
widths).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from gavit_tpu_torch.config import Config
from gavit_tpu_torch.data.dataset import DISEASE_NAMES
from gavit_tpu_torch.data.loader import device_iterator
from gavit_tpu_torch.ops import philox
from gavit_tpu_torch.ops.preprocess import train_preprocess, val_preprocess
from gavit_tpu_torch.training.losses import DynamicWeightedLoss
from gavit_tpu_torch.training.optimizer import (clip_by_global_norm,
                                                global_norm, make_optimizer)
from gavit_tpu_torch.utils import checkpoint as ckpt_lib
from gavit_tpu_torch.utils.convert import load_quant_state
from gavit_tpu_torch.utils.metrics import MetricCalculator
from gavit_tpu_torch.utils.preemption import PreemptionHandler

logger = logging.getLogger(__name__)


class _Preempted(Exception):
    pass


class Trainer:
    def __init__(self, config: Config, model: torch.nn.Module, pos_weight,
                 steps_per_epoch: int, device=None, *, train_loader=None,
                 val_loader=None, wandb_run=None, dataset=None):
        """``model``: a built ``VisionTransformer`` with fp32 parameters
        (moved to ``device`` here); ``pos_weight``: the per-class WBCE
        weights ``[num_classes]``. The loaders (``data/loader.py``) are
        needed by the epoch loop only; ``wandb_run``: a ``log`` sink.
        ``dataset``: the train set QAT calibrates on where no
        ``train_loader`` is given."""
        tr = config.training
        self.config = config
        self.device = torch.device(device) if device is not None else \
            next(model.parameters()).device
        self.model = model.to(self.device).train()
        if (self.device.type == "cuda"
                and getattr(model, "dtype", None) == torch.float32):
            # fp32 training in IEEE fp32: TF32 off in every cuBLAS GEMM
            # (and cuDNN), as the JAX package's HIGHEST precision
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.criterion = DynamicWeightedLoss(device=self.device)
        self.pos_weight = torch.as_tensor(pos_weight, dtype=torch.float32,
                                          device=self.device)
        self.optimizer, self.schedules = make_optimizer(
            config, self.model, self.criterion, steps_per_epoch)
        self.model_params = [p for g in self.optimizer.param_groups
                             if g["role"] == "model" for p in g["params"]]
        self.moe = config.model.moe.enabled
        self.max_grad_norm = tr.max_grad_norm
        self.log_grad_norm = tr.log_grad_norm
        self.accum = max(1, tr.grad_accum_steps)
        self.use_affine = config.data.augment_affine
        self.seed = tr.seed
        # augmentation and drop_path draws, on the device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tr.seed)
        self.step = 0

        self.train_loader = train_loader
        self.val_loader = val_loader
        self.wandb = wandb_run
        names = (train_loader.dataset.disease_names if train_loader is not None
                 else DISEASE_NAMES[:config.model.num_classes])
        self.disease_names = list(names)
        self.metric_calculator = MetricCalculator(self.disease_names)
        self.current_epoch = self.start_epoch = 0
        self.best_val_auc = 0.0
        self.best_epoch = 0
        self.patience_counter = 0
        self.early_stop_patience = tr.early_stopping_patience
        self.min_delta = tr.min_delta
        self.train_metrics_history: list[dict] = []
        self.val_metrics_history: list[dict] = []
        self._preemption: PreemptionHandler | None = None
        # the train loader's position after the last trained batch
        self._loader_state: bytes | None = None
        # QAT: the frozen activation scales, {site path: {'act_scale': t}}
        self.quant: dict = {}
        if tr.qat:
            self.model.set_quant("qat")
            ds = train_loader.dataset if train_loader is not None else dataset
            if ds is None:
                raise ValueError("training.qat calibrates on the train set: "
                                 "give a train_loader or a dataset")
            self.quant = self._calibrate_qat(ds)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def train_step(self, images, labels) -> dict:
        """One optimizer step. ``images``: uint8 ``[B, S, S, 3]`` (augmented
        and normalised here) or already-normalised floats (used as given);
        ``labels``: ``[B, num_classes]``. Returns device tensors: the loss,
        its components (and ``moe_aux``, which the loss includes, for an MoE
        model), the λ weights, the pre-clip gradient norm of the averaged
        model gradients (with clipping or ``training.log_grad_norm``) and
        the model lr of this step."""
        return self._step(images, labels)[0]

    def _step(self, images, labels):
        """:meth:`train_step`'s metrics and the batch's sigmoid
        probabilities ``[B, num_classes]`` (fp32, on the device)."""
        images = images.to(self.device, non_blocking=True)
        labels = labels.to(self.device, non_blocking=True)
        if images.dtype == torch.uint8:
            x = train_preprocess(images, self.generator, self.use_affine)
        else:
            x = images
        b = x.shape[0]
        if b % self.accum:
            raise ValueError(f"batch size {b} not divisible by "
                             f"grad_accum_steps={self.accum}")
        mb = b // self.accum
        lrs = [s(self.step) for s in self.schedules]
        self.optimizer.zero_grad(set_to_none=True)
        losses, parts, logits_all = [], [], []
        for i in range(self.accum):
            rows = slice(i * mb, (i + 1) * mb)
            logits = self.model(
                x[rows], seed=philox.step_seed(self.seed,
                                               self.step * self.accum + i),
                generator=self.generator)
            loss, comps = self.criterion(logits, labels[rows],
                                         self.pos_weight)
            if self.moe:
                aux = self.model.moe_aux_loss()
                loss = loss + aux
                comps = {**comps, "moe_aux": aux.detach()}
            loss.backward()
            losses.append(loss.detach())
            parts.append(comps)
            logits_all.append(logits.detach())
        if self.accum == 1:
            loss, comps, logits = losses[0], parts[0], logits_all[0]
        else:
            with torch.no_grad():
                for group in self.optimizer.param_groups:
                    for p in group["params"]:
                        if p.grad is not None:
                            p.grad.div_(self.accum)
            loss = torch.stack(losses).mean()
            comps = {k: torch.stack([c[k] for c in parts]).mean()
                     for k in parts[0]}
            logits = torch.cat(logits_all)
        grad_norm = None
        if self.max_grad_norm and self.max_grad_norm > 0:
            grad_norm = clip_by_global_norm(self.model_params,
                                            self.max_grad_norm)
        elif self.log_grad_norm:
            grad_norm = global_norm(self.model_params)
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        out = {"loss": loss, **comps,
               "loss_weights": self.criterion.weights().detach(),
               "lr": lrs[0]}
        if grad_norm is not None:
            out["grad_norm"] = grad_norm
        return out, torch.sigmoid(logits.float())

    # ------------------------------------------------------------------
    # epoch loops
    # ------------------------------------------------------------------

    def _log(self, data: dict):
        if self.wandb is not None:
            self.wandb.log(data)

    def _read_back(self, pending: list, host: list, first: int) -> None:
        """The step metrics of ``pending`` (steps ``first``, ``first`` + 1,
        ... of the epoch) to the host in one transfer; logs every
        ``log_every``-th step."""
        keys = [k for k, v in pending[0].items()
                if torch.is_tensor(v) and v.ndim == 0]
        vals = torch.stack([torch.stack([m[k].float() for k in keys])
                            for m in pending]).tolist()
        log_every = max(1, self.config.training.log_every)
        for i, (m, row) in enumerate(zip(pending, vals)):
            rec = dict(zip(keys, row))
            host.append(rec)
            if (first + i) % log_every == 0:
                logger.info(f"Epoch {self.current_epoch + 1} step "
                            f"{first + i}: loss {rec['loss']:.4f}, lr "
                            f"{m['lr']:.2e}")
                self._log({"train/batch_loss": rec["loss"],
                           "train/learning_rate": m["lr"]})
        pending.clear()

    def train_epoch(self) -> dict:
        """One pass over the train loader; the metric battery over its
        predictions, the mean loss and components, images/s and the mean
        time a step waited on the loader (``loader_wait_ms``)."""
        k = max(1, self.config.training.steps_per_call)
        preds, targets, pending, host = [], [], [], []
        n_images = 0
        wait = 0.0
        t0 = time.perf_counter()
        self.train_loader.set_epoch(self.current_epoch)
        state_fn = getattr(self.train_loader, "get_state", None)
        batches = device_iterator(self.train_loader, self.device,
                                  self.config.data.prefetch, state_fn)
        done = 0
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t_wait
            if batch is None:
                break
            images, labels, loader_state = batch
            metrics, probs = self._step(images, labels)
            # every batch up to this one is trained: the resume point
            self._loader_state = loader_state
            preds.append(probs)
            targets.append(labels)
            n_images += images.shape[0]
            pending.append(metrics)
            if len(pending) == k:
                self._read_back(pending, host, done + 1 - k)
            done += 1
            if self._preemption is not None and self._preemption.preempted:
                raise _Preempted()
        if not done:  # resumed at the end of its epoch: nothing left
            return {"loss": float("nan"), "mean_auc": float("nan"),
                    "images_per_sec": 0.0, "loader_wait_ms": 0.0}
        if pending:
            self._read_back(pending, host, done - len(pending))
        predictions = torch.cat(preds).cpu().numpy()
        elapsed = time.perf_counter() - t0
        metrics = self.metric_calculator.calculate_metrics(
            torch.cat(targets).cpu().numpy(), predictions)
        for key in ("loss", "wbce", "focal", "asl"):
            name = "loss_total" if key == "loss" else f"loss_{key}"
            metrics[name] = float(np.mean([m[key] for m in host]))
        metrics["loss"] = metrics["loss_total"]
        if host and "moe_aux" in host[0]:
            metrics["loss_moe_aux"] = float(np.mean([m["moe_aux"]
                                                     for m in host]))
        metrics["images_per_sec"] = n_images / max(elapsed, 1e-9)
        metrics["loader_wait_ms"] = wait / done * 1e3
        return metrics

    @torch.no_grad()
    def predict(self, loader):
        """The eval forward over ``loader``: ``(probabilities [N, C] fp32
        on the device, targets [N, C] on the host, per-example losses [N]
        on the device)`` over every row, a ragged last batch too."""
        preds, targets, losses = [], [], []
        self.model.eval()
        try:
            for x, labels, _ in device_iterator(loader, self.device,
                                                self.config.data.prefetch):
                if x.dtype == torch.uint8:
                    x = val_preprocess(x)
                logits = self.model(x)
                loss_vec, _ = self.criterion(logits, labels, self.pos_weight,
                                             per_example=True)
                preds.append(torch.sigmoid(logits.float()))
                targets.append(labels)
                losses.append(loss_vec)
        finally:
            self.model.train()
        return (torch.cat(preds), torch.cat(targets).cpu().numpy(),
                torch.cat(losses))

    def validate(self) -> dict:
        """The metric battery over the val loader's :meth:`predict`, and
        the mean per-example loss."""
        probs, targets, losses = self.predict(self.val_loader)
        metrics = self.metric_calculator.calculate_metrics(
            targets, probs.cpu().numpy())
        metrics["loss"] = float(np.mean(losses.cpu().numpy()))
        return metrics

    # ------------------------------------------------------------------
    # QAT and checkpointing
    # ------------------------------------------------------------------

    def _calibrate_qat(self, dataset, n: int = 8) -> dict:
        """Static activation scales from the first ``n`` samples of the
        train set (not the loader: drawing from it would move its
        position) on the current weights, set on the model."""
        from gavit_tpu_torch.serving import calibrate_act_scales

        imgs = np.stack([np.asarray(dataset[i][0])
                         for i in range(min(n, len(dataset)))])
        sample = val_preprocess(torch.from_numpy(imgs).to(torch.uint8)
                                .to(self.device))
        quant = calibrate_act_scales(self.model, sample)
        load_quant_state(self.model, quant)
        logger.info(f"QAT: calibrated {len(quant)} static activation scales")
        return quant

    def _state_tree(self) -> dict:
        tree = {"step": self.step,
                "model": self.model.state_dict(),
                "criterion": self.criterion.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}
        if self.quant:
            # the run's noise model: resume and the int8 export read it
            tree["quant"] = self.quant
        return tree

    def save_checkpoint(self, metrics: dict, is_best: bool = False,
                        epoch_completed: bool = True):
        """``epoch_completed=False`` marks a mid-epoch (preemption) save:
        resume continues the in-progress epoch from the saved loader
        position (without one, from its start) instead of skipping it."""
        save_dir = self.config.paths.save_dir
        meta = {
            "epoch": self.current_epoch,
            "next_epoch": self.current_epoch + (1 if epoch_completed else 0),
            "epoch_completed": epoch_completed,
            "best_val_auc": float(self.best_val_auc),
            "best_epoch": int(self.best_epoch),
            "patience_counter": int(self.patience_counter),
            "metrics": {k: float(v) for k, v in metrics.items()
                        if isinstance(v, (int, float, np.floating))},
            "config": self.config.to_dict(),
        }
        # a mid-epoch save resumes on the next unseen batch
        loader_state = None if epoch_completed else self._loader_state
        name = ckpt_lib.checkpoint_name(self.current_epoch, metrics["mean_auc"])
        ckpt_lib.save(os.path.join(save_dir, name), self._state_tree(), meta,
                      also=(os.path.join(save_dir, "best_model"),)
                      if is_best else (), loader_state=loader_state)
        if is_best:
            logger.info(f"Saved new best model with AUC: "
                        f"{metrics['mean_auc']:.4f}")

    def restore_checkpoint(self, path: str):
        """Full resume: parameters, λ, optimizer, schedule step, generator,
        epoch, best AUC, best epoch and patience; a mid-epoch save's loader
        position into the train loader."""
        # read to the host: load_state_dict copies onto the parameters'
        # device, and AdamW keeps its step counts on the host
        state, meta = ckpt_lib.restore(path, map_location="cpu")
        self.model.load_state_dict(state["model"])
        self.criterion.load_state_dict(state["criterion"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])
        if state.get("quant") and self.quant:
            # QAT resume: the checkpoint's scales, not this run's fresh
            # calibration
            self.quant = {path: {k: v.to(self.device) for k, v in node.items()}
                          for path, node in state["quant"].items()}
            load_quant_state(self.model, self.quant)
        self.step = int(state["step"])
        self.current_epoch = int(meta.get("next_epoch",
                                          int(meta.get("epoch", 0)) + 1))
        self.start_epoch = self.current_epoch
        self.best_val_auc = float(meta.get("best_val_auc", 0.0))
        self.best_epoch = int(meta.get("best_epoch", 0))
        self.patience_counter = int(meta.get("patience_counter", 0))
        if meta.get("loader_state") and hasattr(self.train_loader,
                                                "set_state"):
            # set_epoch is idempotent: train_epoch's own call keeps it
            self.train_loader.set_epoch(self.current_epoch)
            self.train_loader.set_state(meta["loader_state"])
            logger.info("Restored the mid-epoch loader position")
        logger.info(f"Resumed from {path} at epoch {self.current_epoch}")

    # ------------------------------------------------------------------
    # outer loop
    # ------------------------------------------------------------------

    def train(self) -> dict:
        logger.info("Starting training...")
        tr = self.config.training
        if self._preemption is None:  # tests may inject a pre-armed handler
            self._preemption = PreemptionHandler().install()
        try:
            for epoch in range(self.start_epoch, tr.epochs):
                self.current_epoch = epoch
                train_metrics = self.train_epoch()
                self.train_metrics_history.append(train_metrics)

                run_val = (epoch + 1) % max(1, tr.eval_freq) == 0
                val_metrics = self.validate() if run_val else None
                if val_metrics is not None:
                    self.val_metrics_history.append(val_metrics)

                lr = float(self.schedules[0](self.step - 1))
                epoch_log = {
                    "epoch": epoch,
                    "train/loss": train_metrics["loss"],
                    "train/mean_auc": train_metrics["mean_auc"],
                    "train/images_per_sec": train_metrics["images_per_sec"],
                    "learning_rate": lr,
                }
                if "loss_moe_aux" in train_metrics:
                    epoch_log["train/loss_moe_aux"] = (
                        train_metrics["loss_moe_aux"])
                if val_metrics is not None:
                    epoch_log["val/loss"] = val_metrics["loss"]
                    epoch_log["val/mean_auc"] = val_metrics["mean_auc"]
                self._log(epoch_log)
                for disease in self.disease_names:
                    key = f"{disease}_auc"
                    if key in train_metrics:
                        d_log = {f"train/auc_{disease}": train_metrics[key]}
                        if val_metrics is not None and key in val_metrics:
                            d_log[f"val/auc_{disease}"] = val_metrics[key]
                        self._log(d_log)

                w = self.criterion.weights().tolist()
                val_str = (f"Val Loss: {val_metrics['loss']:.4f}, "
                           f"Val AUC: {val_metrics['mean_auc']:.4f}, "
                           if val_metrics is not None else "")
                logger.info(
                    f"Epoch {epoch + 1}/{tr.epochs} - "
                    f"Train Loss: {train_metrics['loss']:.4f}, "
                    f"Train AUC: {train_metrics['mean_auc']:.4f}, {val_str}"
                    f"{train_metrics['images_per_sec']:.0f} img/s, "
                    f"loss weights (wbce/focal/asl): "
                    f"{w[0]:.3f}/{w[1]:.3f}/{w[2]:.3f}")

                if val_metrics is not None:
                    if val_metrics["mean_auc"] > self.best_val_auc:
                        self.best_val_auc = val_metrics["mean_auc"]
                        self.best_epoch = epoch
                        self.patience_counter = 0
                        self.save_checkpoint(val_metrics, is_best=True)
                    else:
                        self.patience_counter += 1
                elif (epoch + 1) % max(1, tr.save_freq) == 0:
                    self.save_checkpoint(train_metrics, is_best=False)

                if self.patience_counter >= self.early_stop_patience:
                    logger.info("Early stopping triggered")
                    break

                if self._preemption.preempted:
                    raise _Preempted()
        except _Preempted:
            logger.warning("Preempted — saving resume checkpoint and exiting")
            last_metrics = (self.val_metrics_history[-1]
                            if self.val_metrics_history else {"mean_auc": 0.0})
            self.save_checkpoint(last_metrics, is_best=False,
                                 epoch_completed=False)
        except Exception as e:
            logger.error(f"Training failed with error: {e}")
            raise
        finally:
            self._preemption.uninstall()
            self._preemption = None
            logger.info("Training completed!")

        last_train = (self.train_metrics_history[-1]
                      if self.train_metrics_history else {})
        last_val = (self.val_metrics_history[-1]
                    if self.val_metrics_history else {})
        return {
            "best_val_auc": float(self.best_val_auc),
            "final_train_loss": float(last_train.get("loss", float("nan"))),
            "final_train_auc": float(last_train.get("mean_auc", float("nan"))),
            "final_val_loss": float(last_val.get("loss", float("nan"))),
            "final_val_auc": float(last_val.get("mean_auc", float("nan"))),
        }
