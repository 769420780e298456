"""Inference / serving layer (counterpart of ``gavit_tpu/serving.py``).

``Predictor``: weights made from a seed, carried over from the JAX
parameter tree, or restored from the port's own checkpoint directory
(``utils/checkpoint.py``), resident on the device (cast once to the
compute dtype, LayerNorm kept fp32), uint8 NHWC in, per-disease sigmoid
probabilities out, with batch-size buckets (a request pads up to the
nearest bucket, larger ones run in top-bucket chunks) and a latency window
reporting p50/p95/p99. ``precision='int8'`` serves static PTQ: int8 GEMMs
(``ops/quant.py``) against activation scales calibrated on sample images
(:meth:`Predictor.calibrate`, or noise at warm-up) or, for a QAT
checkpoint, the scales it trained under (:func:`export_quant`).
``tome_r`` merges tokens after every block (``models/tome.py``) and
composes with int8.

``MicroBatcher``: coalesces concurrent requests into one bucketed call
within ``max_wait_ms``, up to ``max_batch`` rows, and sheds load past
``max_queue_rows`` pending rows with :class:`QueueFull`.

One CUDA graph per bucket and ``torch.export`` of the serve path wait for
ROADMAP Queue 1 item 7; the mesh for item 13.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from gavit_tpu_torch.config import Config
from gavit_tpu_torch.data.dataset import DISEASE_NAMES
from gavit_tpu_torch.models.layers import Dense, LayerNorm
from gavit_tpu_torch.models.tome import check_tome, tome_forward
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.ops.preprocess import val_preprocess
from gavit_tpu_torch.ops.quant import quantize_rowwise
from gavit_tpu_torch.utils.convert import (load_flax_params,
                                           load_quant_state, quant_sites)

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (1, 8, 32, 128)

# latency and batch-size samples kept for the percentile windows
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
    takes in fp32, an MoE router, whose logits it takes in fp32 (a bf16
    router would flip expert choices), and a quantised Dense's weight and
    bias: calibration and the QAT export quantise the fp32 weights, as the
    JAX package's do, and the bias is cast at use."""
    for mod in model.modules():
        if isinstance(mod, LayerNorm) or (isinstance(mod, Dense)
                                          and mod.quant):
            continue
        for name, p in mod.named_parameters(recurse=False):
            if name not in _FP32_PARAMS:
                p.data = p.data.to(dtype)


# ---------------------------------------------------------------------------
# int8 calibration and export
# ---------------------------------------------------------------------------


def _site_quant(mod: Dense, act_scale) -> dict:
    """A site's static state: the act scale and its weight quantised per
    output channel (fp32 weights; ``w_scale`` as ``[1, N]``)."""
    w_q, scale = quantize_rowwise(mod.weight.detach().float(), axis=-1)
    return {"act_scale": act_scale, "w_q": w_q,
            "w_scale": scale.reshape(1, -1)}


@torch.no_grad()
def calibrate_int8(model, sample_x, *, n_batches: int = 1) -> dict:
    """The static-PTQ quant state (serving.py:109): per-tensor activation
    scales ``max(absmax, 1e-8) / 127`` observed on sample batches, and the
    weights quantised once per output channel.

    ``model``: a quantised ``VisionTransformer`` ('int8' or 'qat'); its
    state is cleared first, so the batches run the calibration pass (int8:
    dynamic PTQ; QAT: the unquantised GEMMs), in eval mode. ``sample_x``:
    normalised images ``[N, H, W, C]`` or a list of such batches. Returns
    ``{path: {act_scale, w_q, w_scale}}`` for :func:`load_quant_state`; the
    model is left without a state."""
    batches = sample_x if isinstance(sample_x, (list, tuple)) else [sample_x]
    sites = quant_sites(model)
    load_quant_state(model, {})
    for mod in sites.values():
        mod.act_absmax = None
    training = model.training
    model.eval()
    try:
        for x in batches[:n_batches] if n_batches else batches:
            model(x)
    finally:
        model.train(training)
    out = {}
    for path, mod in sites.items():
        if mod.act_absmax is not None:
            scale = torch.clamp(mod.act_absmax, min=1e-8) / 127.0
            out[path] = _site_quant(mod, scale)
            mod.act_absmax = None
    return out


def calibrate_act_scales(model, sample_x, *, n_batches: int = 1) -> dict:
    """The activation-scale half of :func:`calibrate_int8`, for QAT
    (serving.py:147): the weights keep training, so only ``act_scale`` is
    kept and the live weight is fake-quantised per call."""
    full = calibrate_int8(model, sample_x, n_batches=n_batches)
    return {path: {"act_scale": node["act_scale"]}
            for path, node in full.items()}


@torch.no_grad()
def export_quant(model, act_scales: dict) -> dict:
    """The serving quant state of a (QAT-)trained model (serving.py:169):
    its final weights quantised per output channel, paired with the act
    scales it trained against (``{path: {'act_scale': ...}}``, checkpointed
    by the QAT trainer)."""
    sites = quant_sites(model)
    return {path: _site_quant(sites[path], torch.as_tensor(
        node["act_scale"], dtype=torch.float32,
        device=sites[path].weight.device))
        for path, node in act_scales.items()}


class Predictor:
    def __init__(
        self,
        config: Config,
        weights=None,
        *,
        checkpoint_path: str | None = None,
        precision: str = "fp32",
        device="cuda",
        seed: int = 0,
        buckets: tuple = DEFAULT_BUCKETS,
        impl: str = "auto",
        tome_r: int = 0,
    ):
        """``weights``: None (random weights from ``seed``), a Flax parameter
        tree of numpy arrays, or the path of an ``.npz`` of '/'-joined Flax
        paths. ``checkpoint_path``: a checkpoint directory of the port's
        trainer (``utils/checkpoint.py``) whose model weights are served;
        where it holds QAT scales, ``precision='int8'`` serves under them
        (final weights quantised per output channel, no recalibration).
        ``precision``: 'fp32', 'bf16' or 'int8' (static PTQ; calibrated by
        :meth:`calibrate`, or on noise at :meth:`warmup`). ``impl``:
        ``'auto'`` (Hopper kernels and cuBLASLt's int8 GEMM on CUDA) or
        ``'reference'`` (plain PyTorch everywhere). ``tome_r``: tokens
        merged after every block (``models/tome.py``)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Predictor(device={device!r}) needs a CUDA device and this "
                "PyTorch sees none")
        if weights is not None and checkpoint_path:
            raise ValueError("give weights or checkpoint_path, not both")
        model_cfg = dataclasses.replace(config.model, drop_rate=0.0)
        self._tome_r = int(tome_r)
        if self._tome_r:
            check_tome(model_cfg)
        model = build_model(model_cfg, precision=precision, impl=impl)
        qat_scales = None
        if checkpoint_path:
            from gavit_tpu_torch.utils import checkpoint as ckpt_lib

            state, _ = ckpt_lib.restore(checkpoint_path, map_location="cpu")
            model.load_state_dict(state["model"])
            qat_scales = state.get("quant") or None
        elif weights is None:
            init_params(model, torch.Generator().manual_seed(seed))
        else:
            load_flax_params(model, weights)
        _cast_weights_(model, model.dtype)
        self.model = model.to(self.device).eval()
        self.image_size = config.data.image_size
        self.buckets = tuple(sorted(set(buckets)))
        self.disease_names = DISEASE_NAMES[: model_cfg.num_classes]
        self._is_int8 = precision == "int8"
        self._has_qat_scales = qat_scales is not None
        self._static = False
        if self._is_int8 and qat_scales is not None:
            # the noise model QAT trained through: no sample calibration
            load_quant_state(self.model, export_quant(self.model,
                                                      qat_scales))
            self._static = True
            logger.info("int8 predictor using QAT-trained scales")
        self._latencies_ms: deque = deque(maxlen=_STATS_WINDOW)
        self._latency_count = 0
        self._stats_lock = threading.Lock()

    @property
    def calibrated(self) -> bool:
        """True once an int8 predictor serves static scales."""
        return self._static

    @torch.inference_mode()
    def _predict(self, images_u8: np.ndarray) -> np.ndarray:
        if self._is_int8 and self._tome_r and not self._static:
            raise RuntimeError(
                "int8 + tome_r serves static scales only: call calibrate() "
                "or warmup() before predicting (the merged trunk has no "
                "dynamic-PTQ calibration pass)")
        x = val_preprocess(torch.tensor(images_u8, device=self.device))
        if self._tome_r:
            logits = tome_forward(self.model, x, self._tome_r)
        else:
            logits = self.model(x)
        return torch.sigmoid(logits.float()).cpu().numpy()

    def calibrate(self, images_u8: np.ndarray, *, force: bool = False):
        """Static PTQ calibration of an int8 predictor: activation ranges
        observed on ``images_u8`` (uint8 ``[N, S, S, 3]``), the weights
        quantised once, the serve path switched to static scales. A QAT
        checkpoint's trained scales are kept unless ``force``: fresh sample
        scales would reopen the train/serve skew QAT closes."""
        if not self._is_int8:
            return
        if self._has_qat_scales and not force:
            logger.warning(
                "calibrate() skipped: predictor holds QAT-trained scales "
                "(pass force=True to discard them for PTQ scales)")
            return
        x = val_preprocess(torch.tensor(np.asarray(images_u8, np.uint8),
                                        device=self.device))
        self.use_quant_state(calibrate_int8(self.model, x))
        logger.info("int8 predictor calibrated (static scales)")

    def use_quant_state(self, state: dict):
        """Serve int8 under a given static state (``{path: {act_scale,
        w_q, w_scale}}``, as :func:`calibrate_int8` returns or
        ``utils/convert.py::quant_state`` reads from another predictor)."""
        if not self._is_int8:
            raise ValueError("use_quant_state serves precision='int8' only")
        load_quant_state(self.model, state)
        self._static = True

    def warmup(self):
        """Run every bucket once (builds the kernels on first use). An int8
        predictor without scales first calibrates on 8 noise images from
        ``np.random.default_rng(0)``, as the JAX Predictor does; call
        :meth:`calibrate` with real images first for real scales."""
        s = self.image_size
        if self._is_int8 and not self._static:
            rng = np.random.default_rng(0)
            self.calibrate(rng.integers(0, 256, (8, s, s, 3), np.uint8))
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


# ---------------------------------------------------------------------------
# micro-batching
# ---------------------------------------------------------------------------


class QueueFull(RuntimeError):
    """The micro-batcher's pending-row bound is exceeded; the HTTP layer
    answers 503 with Retry-After, so an overloaded replica sheds load at
    admission instead of holding a handler thread per queued request."""


class MicroBatcher:
    """Cross-request micro-batching (serving.py:581-784).

    A worker thread drains a queue: a flush fires when the rows gathered
    reach ``max_batch`` (default: the predictor's top bucket) or the oldest
    request has waited ``max_wait_ms`` (0 still coalesces what arrived
    while the device was busy). ``submit`` blocks the calling thread until
    its rows come back; a flush's failure reaches exactly that flush's
    waiters. Admission: with ``max_queue_rows`` (default 8 full flushes;
    0 disables) a request that would take the pending rows (queued and in
    flight) past the bound raises :class:`QueueFull`, unless nothing is
    pending (an oversized request is admitted alone and chunked by the
    predictor). ``close`` stops admitting and flushes every accepted
    request.
    """

    def __init__(self, predictor, *, max_wait_ms: float = 2.0,
                 max_batch: int | None = None,
                 max_queue_rows: int | None = None):
        self.predictor = predictor
        self.max_wait = max_wait_ms / 1000.0
        self.max_batch = max_batch or predictor.buckets[-1]
        self.max_queue_rows = (max_queue_rows if max_queue_rows is not None
                               else 8 * self.max_batch)
        self._pending_rows = 0
        self._rejected = 0
        self.image_size = predictor.image_size
        self._q: queue.Queue = queue.Queue()
        self._batch_sizes: deque = deque(maxlen=_STATS_WINDOW)
        self._total_flushes = 0
        self._total_rows = 0
        self._stats_lock = threading.Lock()
        self._closed = False
        self._close_join_s = 5.0  # bounded first join in close()
        # orders submit's closed-check and enqueue against close(): every
        # accepted request is queued ahead of the closing sentinel
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._worker.start()

    # each queue item: (images [n, S, S, 3], event, result-slot list)

    def submit(self, images_u8: np.ndarray) -> np.ndarray:
        # validated here, so a malformed request fails only its caller
        images_u8 = validate_images(images_u8, self.image_size)
        done = threading.Event()
        slot: list = [None]
        n = images_u8.shape[0]
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if self.max_queue_rows and self._pending_rows > 0 and \
                    self._pending_rows + n > self.max_queue_rows:
                self._rejected += 1
                raise QueueFull(
                    f"{self._pending_rows} rows pending (bound "
                    f"{self.max_queue_rows}); retry later")
            self._pending_rows += n
            self._q.put((images_u8, done, slot))
        done.wait()
        if isinstance(slot[0], Exception):
            raise slot[0]
        return slot[0]

    def _run(self):
        # until the None sentinel: close() queues it behind every accepted
        # submit, so each accepted request is flushed exactly once
        while True:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                return
            batch = [first]
            rows = first[0].shape[0]
            done = False
            deadline = time.monotonic() + self.max_wait
            while rows < self.max_batch:
                try:
                    item = self._q.get(
                        timeout=max(deadline - time.monotonic(), 0.0))
                except queue.Empty:
                    break
                if item is None:
                    done = True
                    break
                batch.append(item)
                rows += item[0].shape[0]
            self._flush(batch)
            if done:
                return

    def _flush(self, batch):
        rows = sum(b[0].shape[0] for b in batch)
        with self._stats_lock:
            self._batch_sizes.append(rows)
            self._total_flushes += 1
            self._total_rows += rows
        try:
            try:
                probs = self.predictor.predict_proba(
                    np.concatenate([b[0] for b in batch]))
            except Exception as e:  # to this flush's waiters only
                for _, done, slot in batch:
                    slot[0] = e
                    done.set()
                return
            off = 0
            for imgs, done, slot in batch:
                n = imgs.shape[0]
                slot[0] = probs[off : off + n]
                off += n
                done.set()
        finally:
            # pending = queued + in flight: released once the call is over
            with self._submit_lock:
                self._pending_rows -= rows

    def stats(self) -> dict:
        with self._submit_lock:
            pending, rejected = self._pending_rows, self._rejected
        with self._stats_lock:
            if not self._batch_sizes:
                return {"flushes": 0, "pending_rows": int(pending),
                        "rejected": int(rejected)}
            arr = np.asarray(self._batch_sizes)
            flushes, rows = self._total_flushes, self._total_rows
        return {
            "flushes": int(flushes),
            "rows": int(rows),
            "mean_batch": float(arr.mean()),
            "max_batch": int(arr.max()),
            "coalesced_frac": float((arr > 1).mean()),
            "pending_rows": int(pending),
            "rejected": int(rejected),
        }

    def close(self):
        with self._submit_lock:
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=self._close_join_s)
        if self._worker.is_alive():
            # a slow in-flight flush: the worker reaches the sentinel
            self._worker.join()
        # the worker is gone: whatever is still queued can never be flushed
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                imgs, done, slot = item
                slot[0] = RuntimeError("MicroBatcher closed before flush")
                done.set()
                with self._submit_lock:
                    self._pending_rows -= imgs.shape[0]
