"""Inference / serving layer (counterpart of ``gavit_tpu/serving.py``).

``Predictor``: weights made from a seed or carried over from the JAX
parameter tree, resident on the device (cast once to the compute dtype,
LayerNorm kept fp32), uint8 NHWC in, per-disease sigmoid probabilities out,
with batch-size buckets (a request pads up to the nearest bucket, larger
ones run in top-bucket chunks) and a latency window reporting p50/p95/p99.

int8 PTQ, ToMe, the mesh, the MicroBatcher and export wait for the serving
slice of ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque

import numpy as np
import torch

from gavit_tpu_torch.config import Config
from gavit_tpu_torch.data.dataset import DISEASE_NAMES
from gavit_tpu_torch.models.layers import LayerNorm
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.ops.preprocess import val_preprocess
from gavit_tpu_torch.utils.convert import load_flax_params

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 8, 32, 128)

# latency samples kept for the percentile window
_STATS_WINDOW = 4096


def validate_images(images_u8, image_size: int) -> np.ndarray:
    """uint8 ``[S,S,3]`` or ``[N,S,S,3]`` → validated ``[N,S,S,3]``."""
    images_u8 = np.asarray(images_u8, np.uint8)
    if images_u8.ndim == 3:
        images_u8 = images_u8[None]
    if images_u8.shape[1:] != (image_size, image_size, 3):
        raise ValueError(
            f"expected images [N, {image_size}, {image_size}, 3] uint8, "
            f"got {images_u8.shape} (resize on host before predicting)"
        )
    return images_u8


def _bucketed_predict(images_u8, buckets, image_size, call) -> np.ndarray:
    """Validate, chunk past the top bucket, pad each chunk up to its bucket,
    run ``call(chunk)``, slice the pads back off."""
    images_u8 = validate_images(images_u8, image_size)
    n, top = images_u8.shape[0], buckets[-1]
    outs = []
    for start in range(0, n, top):
        chunk = images_u8[start : start + top]
        m = chunk.shape[0]
        b = next((bb for bb in buckets if m <= bb), top)
        if m < b:
            chunk = np.concatenate(
                [chunk, np.zeros((b - m,) + chunk.shape[1:], np.uint8)]
            )
        outs.append(np.asarray(call(chunk))[:m])
    return np.concatenate(outs)


# parameters the model reads in fp32 whatever its compute dtype
_FP32_PARAMS = ("adj_logits", "router")


@torch.no_grad()
def _cast_weights_(model: torch.nn.Module, dtype: torch.dtype) -> None:
    """Store every weight in the compute dtype once, instead of casting it
    on every call; the numbers are the same. LayerNorm's stay fp32, and so
    do a learned-static graph's adjacency logits, whose softmax the model
    takes in fp32, and an MoE router, whose logits it takes in fp32 (a bf16
    router would flip expert choices)."""
    for mod in model.modules():
        if isinstance(mod, LayerNorm):
            continue
        for name, p in mod.named_parameters(recurse=False):
            if name not in _FP32_PARAMS:
                p.data = p.data.to(dtype)


class Predictor:
    def __init__(
        self,
        config: Config,
        weights=None,
        *,
        precision: str = "fp32",
        device="cuda",
        seed: int = 0,
        buckets: tuple = DEFAULT_BUCKETS,
        impl: str = "auto",
    ):
        """``weights``: None (random weights from ``seed``), a Flax parameter
        tree of numpy arrays, or the path of an ``.npz`` of '/'-joined Flax
        paths. ``impl``: ``'auto'`` (Hopper kernels on CUDA) or
        ``'reference'`` (plain PyTorch everywhere)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Predictor(device={device!r}) needs a CUDA device and this "
                "PyTorch sees none")
        model_cfg = dataclasses.replace(config.model, drop_rate=0.0)
        model = build_model(model_cfg, precision=precision, impl=impl)
        if weights is None:
            init_params(model, torch.Generator().manual_seed(seed))
        else:
            load_flax_params(model, weights)
        _cast_weights_(model, model.dtype)
        self.model = model.to(self.device).eval()
        self.image_size = config.data.image_size
        self.buckets = tuple(sorted(set(buckets)))
        self.disease_names = DISEASE_NAMES[: model_cfg.num_classes]
        self._latencies_ms: deque = deque(maxlen=_STATS_WINDOW)
        self._latency_count = 0
        self._stats_lock = threading.Lock()

    @torch.inference_mode()
    def _predict(self, images_u8: np.ndarray) -> np.ndarray:
        x = torch.tensor(images_u8, device=self.device)
        logits = self.model(val_preprocess(x))
        return torch.sigmoid(logits.float()).cpu().numpy()

    def warmup(self):
        """Run every bucket once (builds the kernels on first use)."""
        s = self.image_size
        for b in self.buckets:
            self._predict(np.zeros((b, s, s, 3), np.uint8))
        logger.info(f"Predictor warm for buckets {self.buckets}")

    def predict_proba(self, images_u8: np.ndarray) -> np.ndarray:
        """uint8 ``[N, S, S, 3]`` → probabilities ``[N, num_classes]``."""
        t0 = time.perf_counter()
        probs = _bucketed_predict(images_u8, self.buckets, self.image_size,
                                  self._predict)
        ms = (time.perf_counter() - t0) * 1000
        with self._stats_lock:
            self._latencies_ms.append(ms)
            self._latency_count += 1
        return probs

    def labels_from_probs(self, probs, threshold: float = 0.5):
        """Disease-name lists per image from probabilities in hand."""
        return [
            [self.disease_names[i] for i in np.nonzero(row > threshold)[0]]
            for row in np.asarray(probs)
        ]

    def latency_stats(self) -> dict:
        with self._stats_lock:
            if not self._latencies_ms:
                return {}
            arr = np.asarray(self._latencies_ms)
            count = self._latency_count
        return {
            "count": int(count),
            "window": int(arr.size),
            "p50_ms": float(np.percentile(arr, 50)),
            "p95_ms": float(np.percentile(arr, 95)),
            "p99_ms": float(np.percentile(arr, 99)),
            "mean_ms": float(arr.mean()),
        }
