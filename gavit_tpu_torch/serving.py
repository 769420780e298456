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

On a CUDA device the Predictor serves each bucket from one captured CUDA
graph, the counterpart of the JAX Predictor's per-bucket ``jit``: the
whole serve path (uint8 → ``val_preprocess`` → model or ``tome_forward``
→ fp32 sigmoid) is captured once and replayed per request, so a request
pays a copy in, one graph launch and a copy out. The kernels' launch
counters count where their wrappers run: in each bucket's eager run and
its capture, never in a replay.

``export_serving`` writes the same serve path as one ``torch.export``
program per bucket (``predict_b{b}.pt2``) with the weights outside the
programs in one ``weights.pt`` and a ``manifest.json``;
:class:`ExportedPredictor` serves such an artifact without the model code,
on CUDA from one captured graph a bucket as well.

``MicroBatcher``: coalesces concurrent requests into one bucketed call
within ``max_wait_ms``, up to ``max_batch`` rows, and sheds load past
``max_queue_rows`` pending rows with :class:`QueueFull`.

Serving over several cards waits for ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import threading
import time
from collections import deque
from typing import NamedTuple

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
EXPORT_FORMAT = "gavit_tpu_torch.serving_export.v1"
# what is left to ROADMAP Queue 1 item 15, quoted where it refuses
_ITEM_15 = ("ROADMAP Queue 1 item 15 (static-shape grouping, cross-device "
            "export)")

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


class _ServePath(torch.nn.Module):
    """uint8 NHWC ``[B, S, S, 3]`` → fp32 probabilities ``[B, classes]``:
    ``val_preprocess`` → the model (``tome_forward`` with ``tome_r``) →
    ``sigmoid(logits.float())``. The one function that the eager path runs,
    a CUDA graph captures and ``torch.export`` traces."""

    def __init__(self, model: torch.nn.Module, tome_r: int = 0):
        super().__init__()
        self.model = model
        self.tome_r = tome_r

    def forward(self, images_u8):
        x = val_preprocess(images_u8)
        if self.tome_r:
            logits = tome_forward(self.model, x, self.tome_r)
        else:
            logits = self.model(x)
        return torch.sigmoid(logits.float())


class _Captured(NamedTuple):
    """One bucket's CUDA graph: its static uint8 input and fp32 output."""

    graph: "torch.cuda.CUDAGraph"
    images: torch.Tensor
    probs: torch.Tensor


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


class _Served:
    """What both predictors share: the bucketed ``predict_proba``, the
    latency window and the label lists, and the serve path ``_run`` (uint8
    ``[b, S, S, 3]`` on the device → fp32 probabilities) launched op by op
    (:meth:`_predict_eager`) or, on CUDA, replayed from one CUDA graph a
    bucket, captured at ``warmup`` or at the bucket's first call (one eager
    run first, which builds the kernels and sets their attributes). All
    buckets share one memory pool; a lock serialises capture and replay,
    since the static buffers are shared. A capture that fails raises:
    nothing falls back to the eager path."""

    def __init__(self, image_size: int, buckets, disease_names, device):
        self.image_size = image_size
        self.buckets = tuple(sorted(set(buckets)))
        self.disease_names = list(disease_names)
        self.device = device
        self._latencies_ms: deque = deque(maxlen=_STATS_WINDOW)
        self._latency_count = 0
        self._stats_lock = threading.Lock()
        self._graphs: dict = {}  # bucket -> _Captured
        self._pool = None
        self._graph_lock = threading.Lock()

    def _run(self, images: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _captures(self, b: int) -> bool:
        """Whether bucket ``b`` is served from a CUDA graph."""
        return self.device.type == "cuda"

    def _check_servable(self):
        pass

    @torch.inference_mode()
    def _predict_eager(self, images_u8: np.ndarray) -> np.ndarray:
        """The serve path launched op by op: the CPU's path, and on CUDA
        the buckets that are not captured (and the checks' yardstick)."""
        self._check_servable()
        return self._run(torch.tensor(images_u8, device=self.device)
                         ).cpu().numpy()

    def _predict_proba_eager(self, images_u8) -> np.ndarray:
        """:meth:`predict_proba` on the eager path, bucketed alike and
        outside the latency window: what the checks hold a replay to."""
        return _bucketed_predict(images_u8, self.buckets, self.image_size,
                                 self._predict_eager)

    @torch.inference_mode()
    def _capture(self, b: int) -> _Captured:
        """Bucket ``b``'s graph (call under ``_graph_lock``): one eager run,
        then the capture into the shared pool."""
        s = self.image_size
        images = torch.zeros((b, s, s, 3), dtype=torch.uint8,
                             device=self.device)
        self._run(images)
        torch.cuda.synchronize(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            probs = self._run(images)
        captured = _Captured(graph, images, probs)
        self._graphs[b] = captured
        return captured

    def _predict(self, images_u8: np.ndarray) -> np.ndarray:
        b = images_u8.shape[0]
        self._check_servable()
        if not self._captures(b):
            return self._predict_eager(images_u8)
        chunk = torch.from_numpy(np.ascontiguousarray(images_u8))
        # the static buffers are inference tensors (made under the capture's
        # inference mode): written and read in it
        with self._graph_lock, torch.inference_mode():
            captured = self._graphs.get(b) or self._capture(b)
            captured.images.copy_(chunk)
            captured.graph.replay()
            return captured.probs.cpu().numpy()

    def _drop_graphs(self):
        """Forget every captured graph (new static state: the next call
        captures again)."""
        with self._graph_lock:
            self._graphs.clear()
            self._pool = None

    def _warm_buckets(self):
        """Every bucket once: captured where it is, else run eagerly."""
        s = self.image_size
        for b in self.buckets:
            if self._captures(b):
                with self._graph_lock:
                    if b not in self._graphs:
                        self._capture(b)
            else:
                self._predict_eager(np.zeros((b, s, s, 3), np.uint8))

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

    def predict_labels(self, images_u8, threshold: float = 0.5):
        """Disease-name lists per image at ``threshold`` (serving.py:382):
        :meth:`predict_proba`, then :meth:`labels_from_probs`."""
        return self.labels_from_probs(self.predict_proba(images_u8),
                                      threshold)

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


class Predictor(_Served):
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
        merged after every block (``models/tome.py``).

        On CUDA each bucket is served from a CUDA graph (:class:`_Served`).
        The only buckets served eagerly: int8 before it has static scales
        (the dynamic-PTQ calibration pass is never captured), and the
        MoE buckets whose route reads the host
        (``VisionTransformer.reads_host``)."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
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
        self.model = model.to(device).eval()
        self._serve = _ServePath(self.model, self._tome_r)
        super().__init__(config.data.image_size, buckets,
                         DISEASE_NAMES[: model_cfg.num_classes], device)
        self._is_int8 = precision == "int8"
        self._has_qat_scales = qat_scales is not None
        self._static = False
        if self._is_int8 and qat_scales is not None:
            # the noise model QAT trained through: no sample calibration
            load_quant_state(self.model, export_quant(self.model,
                                                      qat_scales))
            self._static = True
            logger.info("int8 predictor using QAT-trained scales")
        self._eager_logged: set = set()

    @property
    def calibrated(self) -> bool:
        """True once an int8 predictor serves static scales."""
        return self._static

    def _check_servable(self):
        if self._is_int8 and self._tome_r and not self._static:
            raise RuntimeError(
                "int8 + tome_r serves static scales only: call calibrate() "
                "or warmup() before predicting (the merged trunk has no "
                "dynamic-PTQ calibration pass)")

    def _run(self, images):
        return self._serve(images)

    def _captures(self, b: int) -> bool:
        """Whether bucket ``b`` is served from a CUDA graph; an eager bucket
        is logged once with its reason."""
        if self.device.type != "cuda" or (self._is_int8 and not self._static):
            return False
        reason = self.model.reads_host(b)
        if reason is None:
            return True
        if b not in self._eager_logged:
            self._eager_logged.add(b)
            logger.info(f"bucket {b} runs eagerly: {reason} ({_ITEM_15})")
        return False

    def calibrate(self, images_u8: np.ndarray, *, force: bool = False):
        """Static PTQ calibration of an int8 predictor: activation ranges
        observed on ``images_u8`` (uint8 ``[N, S, S, 3]``), the weights
        quantised once, the serve path switched to static scales. A QAT
        checkpoint's trained scales are kept unless ``force``: fresh sample
        scales would reopen the train/serve skew QAT closes. The
        calibration pass runs eagerly; captured graphs are dropped."""
        if not self._is_int8:
            return
        if self._has_qat_scales and not force:
            logger.warning(
                "calibrate() skipped: predictor holds QAT-trained scales "
                "(pass force=True to discard them for PTQ scales)")
            return
        self._drop_graphs()
        x = val_preprocess(torch.tensor(np.asarray(images_u8, np.uint8),
                                        device=self.device))
        self.use_quant_state(calibrate_int8(self.model, x))
        logger.info("int8 predictor calibrated (static scales)")

    def use_quant_state(self, state: dict):
        """Serve int8 under a given static state (``{path: {act_scale,
        w_q, w_scale}}``, as :func:`calibrate_int8` returns or
        ``utils/convert.py::quant_state`` reads from another predictor).
        Captured graphs read the old state's tensors: they are dropped."""
        if not self._is_int8:
            raise ValueError("use_quant_state serves precision='int8' only")
        self._drop_graphs()
        load_quant_state(self.model, state)
        self._static = True

    def warmup(self):
        """Run every bucket once (builds the kernels on first use) and, on
        CUDA, capture its graph. An int8 predictor without scales first
        calibrates on 8 noise images from ``np.random.default_rng(0)``, as
        the JAX Predictor does; call :meth:`calibrate` with real images
        first for real scales."""
        s = self.image_size
        if self._is_int8 and not self._static:
            rng = np.random.default_rng(0)
            self.calibrate(rng.integers(0, 256, (8, s, s, 3), np.uint8))
        self._warm_buckets()
        logger.info(f"Predictor warm for buckets {self.buckets}"
                    + (f" ({len(self._graphs)} CUDA graphs)"
                       if self._graphs else ""))


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


class _FlatServe(torch.nn.Module):
    """The serve path as a function of its flat weights: ``forward(weights,
    images_u8)`` runs ``serve`` with ``weights`` (in ``names``' order) in
    place of its parameters and buffers (``torch.func.functional_call``).
    ``serve`` is held outside the module's registry, so an exported
    program carries none of its tensors."""

    def __init__(self, serve: torch.nn.Module, names: list):
        super().__init__()
        object.__setattr__(self, "_serve", serve)
        self._names = list(names)

    def forward(self, weights, images_u8):
        return torch.func.functional_call(
            self._serve, dict(zip(self._names, weights)), (images_u8,))


def _live_state(serve: torch.nn.Module) -> dict:
    """The parameters and set buffers the serve path reads, by name. A
    static-int8 site reads ``w_q``, ``w_scale`` and ``act_scale``: its fp32
    ``weight`` is dead and left out (serving.py:439-463)."""
    dead = {f"{name}.weight" for name, mod in serve.named_modules()
            if isinstance(mod, Dense) and mod.quant == "int8"
            and mod.w_q is not None}
    state = {n: p for n, p in serve.named_parameters() if n not in dead}
    state.update((n, b) for n, b in serve.named_buffers() if b is not None)
    return state


@torch.no_grad()
def _export_program(serve: torch.nn.Module, state: dict, batch: int,
                   image_size: int):
    """One bucket's ``torch.export`` program of ``serve`` over the flat
    weights ``state`` (name → tensor, as :func:`_live_state` gives them)
    and a uint8 ``[batch, S, S, 3]`` batch on the weights' device. On a
    CUDA device the kernels are the custom ops of ``gavit_tpu_torch.ops``;
    on the CPU their plain versions. The tracing runs the ops' fake
    implementations and launches nothing. Raises if the program holds a
    tensor of its own."""
    names = list(state)
    weights = [state[n].detach() for n in names]
    images = weights[0].new_zeros((batch, image_size, image_size, 3),
                                  dtype=torch.uint8)
    program = torch.export.export(_FlatServe(serve, names), (weights, images))
    if program.state_dict:
        raise RuntimeError(f"the exported program holds weights of its own: "
                           f"{sorted(program.state_dict)[:5]}")
    # the example inputs would store a copy of every weight in each program
    program.example_inputs = None
    return program


def export_serving(config: Config, out_dir: str, *,
                   checkpoint_path: str | None = None, weights=None,
                   precision: str = "bf16", buckets: tuple = DEFAULT_BUCKETS,
                   tome_r: int = 0, device="cuda", seed: int = 0,
                   calibration_images=None) -> dict:
    """Write a serving artifact (serving.py:394): one ``torch.export``
    program a bucket (``predict_b{b}.pt2``, ``torch.export.save``), the
    weights outside the programs in one ``weights.pt`` (their names in
    ``manifest.json``), and the manifest. The program is the whole serve
    path (uint8 → ``val_preprocess`` → model → sigmoid), the one a
    :class:`Predictor` runs, as a function of the flat weights and the
    batch (``torch.func.functional_call``).

    What loading needs differs from the JAX artifact, which needs only the
    jax runtime: a program exported on CUDA calls the kernels' custom ops,
    so :class:`ExportedPredictor` imports their registrations
    (``gavit_tpu_torch.ops``) and no model code. A CPU program holds the
    plain versions and needs torch alone. An artifact serves on the device
    type it was exported on (the JAX ``platforms`` cross-lowering is left
    to ROADMAP Queue 1 item 15).

    ``precision='int8'`` exports the static-PTQ program with the fp32
    weight of every quantised site left out; it needs
    ``calibration_images`` (uint8 ``[N, S, S, 3]``) unless the checkpoint
    carries QAT-trained scales, and raises otherwise (noise scales would
    ship in a deployment artifact). A MoE bucket whose route reads the
    host (a grouped-engine bucket on the CPU) raises, naming item 15.
    Returns the manifest."""
    pred = Predictor(config, weights, checkpoint_path=checkpoint_path,
                     precision=precision, device=device, seed=seed,
                     buckets=buckets, tome_r=tome_r)
    for b in pred.buckets:
        reason = pred.model.reads_host(b)
        if reason is not None:
            raise ValueError(f"bucket {b} cannot be exported: {reason} "
                             f"({_ITEM_15})")
    if precision == "int8" and not pred.calibrated:
        if calibration_images is None:
            raise ValueError(
                "int8 export needs calibration_images (or a QAT checkpoint "
                "whose trained scales ride along)")
        pred.calibrate(np.asarray(calibration_images, np.uint8))
    os.makedirs(out_dir, exist_ok=True)
    state = _live_state(pred._serve)
    s = pred.image_size
    for b in pred.buckets:
        torch.export.save(_export_program(pred._serve, state, b, s),
                          os.path.join(out_dir, f"predict_b{b}.pt2"))
    names = list(state)
    torch.save({str(i): state[n].detach().cpu() for i, n in enumerate(names)},
               os.path.join(out_dir, "weights.pt"))
    manifest = {
        "format": EXPORT_FORMAT,
        "model": config.model.name,
        "image_size": s,
        "num_classes": config.model.num_classes,
        "disease_names": list(pred.disease_names),
        "buckets": list(pred.buckets),
        "precision": precision,
        "tome_r": int(tome_r),
        "device": pred.device.type,
        "torch_version": torch.__version__,
        # the flat weights' structure: their names in argument order
        "treedef": names,
        "n_weights": len(names),
        "leaf_dtypes": [str(state[n].dtype) for n in names],
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ExportedPredictor(_Served):
    """Serve from an :func:`export_serving` artifact without the model
    code (serving.py:511): the per-bucket programs and the weights, behind
    :class:`Predictor`'s ``predict_proba`` contract (pad to the bucket,
    chunk past the top one), ``warmup``, ``latency_stats``,
    ``labels_from_probs`` and ``predict_labels``. The programs take the
    flat weights (``weights.pt``'s keys in order) and the uint8 batch. On
    CUDA each bucket's program is served from one captured CUDA graph, as
    the :class:`Predictor` serves its own (:class:`_Served`).

    ``device``: where to serve (default the artifact's device type). An
    artifact serves on the device type it was exported on; any other is
    refused (ROADMAP Queue 1 item 15)."""

    def __init__(self, artifact_dir: str, device=None):
        with open(os.path.join(artifact_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != EXPORT_FORMAT:
            raise ValueError(f"{artifact_dir}: format "
                             f"{self.manifest.get('format')!r}, not "
                             f"{EXPORT_FORMAT!r}")
        exported_on = self.manifest["device"]
        device = torch.device(device if device is not None else exported_on)
        if device.type != exported_on:
            raise ValueError(
                f"the artifact was exported on {exported_on} and serves "
                f"there only, not on {device.type}: export it again "
                f"on that device ({_ITEM_15})")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("this artifact serves on CUDA and this "
                               "PyTorch sees no CUDA device")
        # a CUDA program calls the kernels' custom ops: register them
        import gavit_tpu_torch.ops  # noqa: F401

        super().__init__(self.manifest["image_size"],
                         self.manifest["buckets"],
                         self.manifest["disease_names"], device)
        saved = torch.load(os.path.join(artifact_dir, "weights.pt"),
                           map_location=device, weights_only=True)
        self._weights = [saved[str(i)]
                         for i in range(self.manifest["n_weights"])]
        self._fns = {b: torch.export.load(os.path.join(
            artifact_dir, f"predict_b{b}.pt2")).module()
            for b in self.buckets}

    def _run(self, images):
        return self._fns[images.shape[0]](self._weights, images)

    def warmup(self):
        """Run every bucket's program once (the kernels build on their
        first call) and, on CUDA, capture its graph."""
        self._warm_buckets()
        logger.info(f"ExportedPredictor warm for buckets {self.buckets}"
                    + (f" ({len(self._graphs)} CUDA graphs)"
                       if self._graphs else ""))


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
