"""Memory-free dropout (counterpart of ``fused_dropout`` in
``gavit_tpu/ops/dropout.py``).

* :func:`dropout_reference` — the plain PyTorch version: the Philox mask of
  ``ops/philox.py``, ``y = x * scale`` with the scale rounded to x's dtype
  first (``dropout.py:40-41``), 0 where dropped.
* :func:`fused_dropout` — an autograd op. On a CUDA tensor it launches
  kernel F (``csrc/dropout.cu``), which replaces the TPU kernel
  ``_dropout_kernel``; the backward is the same kernel on the gradient with
  the same (seed, site), so the mask is never stored.

A rate of 0 (or ``seed=None`` in a model's eval mode) is the identity and
launches nothing.
"""

from __future__ import annotations

import torch

from gavit_tpu_torch.ops import _build, philox

# launches of kernel F since the last reset (chip_smoke.py reads it)
KERNEL_LAUNCHES = 0


def dropout_reference(x, seed: int, site: int, rate: float):
    keep = philox.keep_mask(x.shape, seed, site, rate, device=x.device)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def dropout_kernel(x, seed: int, site: int, rate: float):
    """Kernel F on a contiguous CUDA tensor (bf16 or fp32)."""
    global KERNEL_LAUNCHES
    _build.require_cuda(x)
    code = _build.dtype_code(x.dtype)
    y = torch.empty_like(x)
    if not x.numel():
        return y
    k0, k1 = philox.split_seed(seed)
    lib = _build.library()
    _build.check(lib.gavit_dropout(
        x.data_ptr(), y.data_ptr(), x.numel(), k0, k1, site & 0xFFFFFFFF,
        philox.threshold(rate), 1.0 / (1.0 - rate), code,
        _build.stream(x.device)), "dropout kernel")
    with _build.count_lock:
        KERNEL_LAUNCHES += 1
    return y


def _run(x, seed, site, rate, impl):
    if impl == "reference" or x.device.type == "cpu":
        return dropout_reference(x, seed, site, rate)
    return dropout_kernel(x.contiguous(), seed, site, rate)


class _FusedDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, site, rate, impl):
        ctx.args = (seed, site, rate, impl)
        return _run(x, seed, site, rate, impl)

    @staticmethod
    def backward(ctx, g):
        # dropout is linear in x: dx = dropout(g) with the same mask
        return _run(g, *ctx.args), None, None, None, None


def fused_dropout(x, seed: int | None, site: int, rate: float,
                  impl: str = "auto"):
    """Dropout of ``x`` at ``rate`` with the mask of (``seed``, ``site``).

    ``impl='auto'`` launches kernel F for a CUDA tensor and takes
    :func:`dropout_reference` for a CPU tensor; ``'reference'`` always takes
    the plain version.
    """
    _build.check_impl(impl)
    if rate == 0.0:
        return x
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if seed is None:
        raise ValueError("dropout with a rate > 0 needs a seed")
    return _FusedDropout.apply(x, int(seed), int(site), float(rate), impl)
