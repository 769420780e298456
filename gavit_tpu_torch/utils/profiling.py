"""Tracing and profiling (counterpart of ``gavit_tpu/utils/profiling.py``).

* :func:`trace` — ``torch.profiler`` around a block (the CPU and, where
  there is one, the card), written as a Chrome trace into ``logdir``
  (Perfetto and ``chrome://tracing`` read it).
* :func:`sync` — wait for the device work behind a result.
* :class:`ThroughputMeter` — sustained images/s with the first steps left
  out, and per device.
* :func:`step_timer` — the host time of a block, synchronised on a result.
* :func:`nan_guard` — raise at the first op that makes a NaN or an
  infinity, as ``jax_debug_nans`` does.
* :func:`percentile_latency` — the latency distribution of a call (ms),
  each call synchronised.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where
    available) and write ``<logdir>/trace.json``; yields the profiler, whose
    ``key_averages()`` sum the time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"Profiler trace written to {path}")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(x=None) -> None:
    """Wait until the work behind ``x`` (a tensor or a tree of them; every
    CUDA device's work when it holds no tensor) is done."""
    devices = {t.device for t in _tensors(x)}
    if not devices and torch.cuda.is_available():
        devices = {torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())}
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class ThroughputMeter:
    """Sustained throughput with warmup exclusion: the clock starts at the
    ``warmup_steps``-th step, and images count from the step after it."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self._count = 0
        self._images = 0
        self._start = None

    def step(self, batch_size: int):
        self._count += 1
        if self._count == self.warmup_steps:
            self._start = time.perf_counter()
            self._images = 0
        elif self._count > self.warmup_steps:
            self._images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self._start is None or self._images == 0:
            return 0.0
        return self._images / (time.perf_counter() - self._start)

    def images_per_sec_per_device(self) -> float:
        """:attr:`images_per_sec` over the CUDA devices (1 on the CPU)."""
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        return self.images_per_sec / max(1, n)


@contextlib.contextmanager
def step_timer(name: str, result=None):
    """Log the host time of the block in ms, after waiting for the device
    work behind ``result`` (a tensor or tree; every device's without
    one)."""
    t0 = time.perf_counter()
    yield
    sync(result)
    logger.info(f"{name}: {(time.perf_counter() - t0) * 1000:.1f} ms")


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if (t.is_floating_point() or t.is_complex()) and \
                    not torch.isfinite(t).all():
                raise FloatingPointError(
                    f"non-finite value in the output of {func}")
        return out


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Within the block, raise ``FloatingPointError`` at the first op whose
    output holds a NaN or an infinity (``jax_debug_nans``; autograd's
    backward ops too). Each check reads the value back: a debugging mode,
    slow on a card."""
    if not enable:
        yield
        return
    with _NanCheck():
        yield


def percentile_latency(fn, args, n_iters: int = 50,
                       percentiles=(50, 95, 99)) -> dict:
    """``{'p50': ms, ...}`` of ``fn(*args)`` over ``n_iters`` calls after
    one warm call, each call's result synchronised on its device."""
    sync(fn(*args))
    times = []
    for _ in range(n_iters):
        t0 = time.perf_counter()
        sync(fn(*args))
        times.append((time.perf_counter() - t0) * 1000)
    return {f"p{p}": float(np.percentile(times, p)) for p in percentiles}
