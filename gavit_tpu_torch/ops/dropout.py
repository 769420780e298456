"""Memory-free dropout, alone and after the exact GELU (counterpart of
``fused_dropout`` and ``fused_gelu_dropout`` in ``gavit_tpu/ops/dropout.py``).

* :func:`dropout_reference` — the plain PyTorch version of dropout: the
  Philox mask of ``ops/philox.py``, ``y = x * scale`` with the scale rounded
  to x's dtype first (``dropout.py:40-41``), 0 where dropped.
* :func:`fused_dropout` — an autograd op. On a CUDA tensor it launches
  kernel F (``csrc/dropout.cu``), which replaces the TPU kernel
  ``_dropout_kernel``; the backward is the same kernel on the gradient with
  the same (seed, site), so the mask is never stored. A rate of 0 is the
  identity and launches nothing.
* :func:`dropout_add_reference` — the plain version of ``r + dropout(y)``:
  :func:`dropout_reference` of y, then the residual add in y's dtype.
* :func:`fused_dropout_add` — an autograd op. On a CUDA tensor it launches
  kernel G (``csrc/dropout.cu``), which replaces the TPU kernel
  ``_dropout_add_kernel``: F's mask and scale and the add in one pass, the
  bits of ``r + fused_dropout(y)``. The backward is F on the gradient for
  y and the gradient itself for r.
* :func:`gelu_dropout_reference` / :func:`gelu_dropout_bwd_reference` — the
  plain versions of GELU + dropout and its backward: the A&S erf GELU of
  :func:`gelu_and_grad`, the mask of ``(seed, site)``, the scale
  ``1/(1-rate)`` in fp32 (the TPU kernels' ``_gelu_dropout_kernel`` and
  ``_gelu_dropout_bwd_kernel`` multiply in fp32 and round once).
* :func:`fused_gelu_dropout` — an autograd op over them. On a CUDA tensor
  the forward launches kernel H and the backward kernel H′
  (``csrc/dropout.cu``), which replace ``_gelu_dropout_kernel`` and
  ``_gelu_dropout_bwd_kernel``; only x is saved, the mask is regenerated.
  At rate 0 they are GELU and GELU′ alone.
"""

from __future__ import annotations

import torch

from gavit_tpu_torch.ops import _build, philox

# launches since the last reset (chip_smoke.py reads them): kernel F,
# kernel G, and kernels H and H′
KERNEL_LAUNCHES = 0
ADD_LAUNCHES = 0
GELU_LAUNCHES = 0
GELU_BWD_LAUNCHES = 0

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327


# the op codes of csrc/dropout.cu's gavit_elementwise_step
_STEP_OPS = {"F": 0, "H": 1, "H′": 2, "G": 3}


def walk_step(kernel: str, dtype, n: int) -> int:
    """Elements one step of the grid covers when kernel ``kernel`` (F, H, H′
    or G) runs over ``n`` elements of ``dtype`` on the card: F, H and H′
    walk a persistent grid in steps of this many, G takes the whole tensor
    in one (the card tests size ragged tails past it)."""
    return _build.library().gavit_elementwise_step(
        _STEP_OPS[kernel], _build.dtype_code(dtype), n)


def dropout_reference(x, seed: int, site: int, rate: float):
    keep = philox.keep_mask(x.shape, seed, site, rate, device=x.device)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def site_args(seed: int | None, site: int, rate: float) -> tuple:
    """What every launcher of a masked kernel (F, H, H′, D, D′) takes for a
    dropout site: ``(k0, k1, site, threshold, scale)``, the step seed as the
    Philox key (0 for None), the site as a uint32, keep = bits >= threshold,
    scale = 1/(1-rate). At rate 0 the threshold is 0 and the scale 1: every
    element is kept."""
    k0, k1 = philox.split_seed(seed or 0)
    return (k0, k1, int(site) & 0xFFFFFFFF, philox.threshold(rate),
            1.0 / (1.0 - rate))


def dropout_kernel(x, seed: int, site: int, rate: float):
    """Kernel F on a contiguous CUDA tensor (bf16 or fp32)."""
    global KERNEL_LAUNCHES
    _build.require_cuda(x)
    code = _build.dtype_code(x.dtype)
    y = torch.empty_like(x)
    if not x.numel():
        return y
    lib = _build.library()
    _build.check(lib.gavit_dropout(
        x.data_ptr(), y.data_ptr(), x.numel(), *site_args(seed, site, rate),
        code, _build.stream(x.device)), "dropout kernel")
    with _build.count_lock:
        KERNEL_LAUNCHES += 1
    return y


def _run(x, seed, site, rate, impl):
    if impl == "reference" or x.device.type == "cpu":
        return dropout_reference(x, seed, site, rate)
    return dropout_kernel(_build.aligned(x), seed, site, rate)


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


# ---------------------------------------------------------------------------
# dropout + residual add
# ---------------------------------------------------------------------------


def dropout_add_reference(y, r, seed: int, site: int, rate: float):
    """``r + dropout(y)`` in y's dtype, the mask of (``seed``, ``site``)."""
    return r + dropout_reference(y, seed, site, rate)


def dropout_add_kernel(y, r, seed: int, site: int, rate: float):
    """Kernel G on contiguous CUDA tensors y and r of one shape and dtype
    (bf16 or fp32) → ``r + dropout(y)``."""
    global ADD_LAUNCHES
    _build.require_cuda(y, r)
    code = _build.dtype_code(y.dtype)
    out = torch.empty_like(y)
    if not y.numel():
        return out
    lib = _build.library()
    _build.check(lib.gavit_dropout_add(
        y.data_ptr(), r.data_ptr(), out.data_ptr(), y.numel(),
        *site_args(seed, site, rate), code, _build.stream(y.device)),
        "dropout add kernel")
    with _build.count_lock:
        ADD_LAUNCHES += 1
    return out


class _FusedDropoutAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, r, seed, site, rate):
        ctx.args = (seed, site, rate)
        if y.device.type == "cpu":
            return dropout_add_reference(y, r, seed, site, rate)
        return dropout_add_kernel(_build.aligned(y), _build.aligned(r), seed,
                                  site, rate)

    @staticmethod
    def backward(ctx, g):
        # d_y = dropout(g) with the forward's mask (kernel F), d_r = g
        return _run(g, *ctx.args, "auto"), g, None, None, None


def fused_dropout_add(y, residual, seed: int | None, site: int, rate: float):
    """``residual + dropout(y)`` at ``rate`` with the mask of (``seed``,
    ``site``), the counterpart of the JAX package's ``fused_dropout_add``.
    y and residual must have one shape and dtype. At rate 0 it is the plain
    sum and launches nothing.

    CUDA tensors launch kernel G (F in the backward); CPU tensors take
    :func:`dropout_add_reference`.
    """
    if y.shape != residual.shape or y.dtype != residual.dtype:
        raise ValueError(f"y {tuple(y.shape)} {y.dtype} and residual "
                         f"{tuple(residual.shape)} {residual.dtype} differ")
    if rate == 0.0:
        return residual + y
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if seed is None:
        raise ValueError("dropout with a rate > 0 needs a seed")
    return _FusedDropoutAdd.apply(y, residual, int(seed), int(site),
                                  float(rate))


# ---------------------------------------------------------------------------
# GELU + dropout
# ---------------------------------------------------------------------------


def gelu_and_grad(x):
    """(GELU(x), GELU'(x)) in fp32 from one exp: the JAX kernels'
    ``_gelu_and_grad_f32`` (erf by the Abramowitz–Stegun polynomial, max
    abs error 1.5e-7). Kernels D, D′, H and H′ run the same rounded
    operations in the same order (csrc/common.cuh), so on the card they
    give the same bits."""
    z = x * _INV_SQRT2
    s = torch.where(z < 0, -1.0, 1.0)
    az = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * az)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    e = torch.exp(-az * az)
    cdf = 0.5 * (1.0 + s * (1.0 - poly * e))
    return x * cdf, cdf + x * (e * _INV_SQRT2PI)


def gelu_dropout_reference(x, seed: int, site: int, rate: float):
    """keep ? GELU(x)·(1/(1-rate)) : 0, in fp32, rounded to x's dtype."""
    g, _ = gelu_and_grad(x.float())
    if rate > 0.0:
        keep = philox.keep_mask(x.shape, seed, site, rate, device=x.device)
        g = torch.where(keep, g * (1.0 / (1.0 - rate)), 0.0)
    return g.to(x.dtype)


def gelu_dropout_bwd_reference(x, g, seed: int, site: int, rate: float):
    """keep ? (GELU'(x)·g)·(1/(1-rate)) : 0, in fp32, rounded to x's
    dtype."""
    _, dg = gelu_and_grad(x.float())
    dx = dg * g.float()
    if rate > 0.0:
        keep = philox.keep_mask(x.shape, seed, site, rate, device=x.device)
        dx = torch.where(keep, dx * (1.0 / (1.0 - rate)), 0.0)
    return dx.to(x.dtype)


def gelu_dropout_kernel(x, seed, site: int, rate: float):
    """Kernel H on a contiguous CUDA tensor (bf16 or fp32)."""
    global GELU_LAUNCHES
    _build.require_cuda(x)
    code = _build.dtype_code(x.dtype)
    y = torch.empty_like(x)
    if not x.numel():
        return y
    lib = _build.library()
    _build.check(lib.gavit_gelu_dropout(
        x.data_ptr(), y.data_ptr(), x.numel(), *site_args(seed, site, rate),
        code, _build.stream(x.device)), "GELU dropout kernel")
    with _build.count_lock:
        GELU_LAUNCHES += 1
    return y


def gelu_dropout_bwd_kernel(x, g, seed, site: int, rate: float):
    """Kernel H′ on contiguous CUDA tensors x and g of one shape and dtype
    → dx."""
    global GELU_BWD_LAUNCHES
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"gradient {tuple(g.shape)} {g.dtype} does not match "
                         f"x {tuple(x.shape)} {x.dtype}")
    _build.require_cuda(x, g)
    code = _build.dtype_code(x.dtype)
    dx = torch.empty_like(x)
    if not x.numel():
        return dx
    lib = _build.library()
    _build.check(lib.gavit_gelu_dropout_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), x.numel(),
        *site_args(seed, site, rate), code, _build.stream(x.device)),
        "GELU dropout backward kernel")
    with _build.count_lock:
        GELU_BWD_LAUNCHES += 1
    return dx


class _FusedGeluDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seed, site, rate, impl):
        x = _build.aligned(x)
        ctx.save_for_backward(x)
        ctx.args = (seed, site, rate, impl)
        if impl == "reference" or x.device.type == "cpu":
            return gelu_dropout_reference(x, seed, site, rate)
        return gelu_dropout_kernel(x, seed, site, rate)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        seed, site, rate, impl = ctx.args
        g = _build.aligned(g.to(x.dtype))
        if impl == "reference" or x.device.type == "cpu":
            dx = gelu_dropout_bwd_reference(x, g, seed, site, rate)
        else:
            dx = gelu_dropout_bwd_kernel(x, g, seed, site, rate)
        return dx, None, None, None, None


def fused_gelu_dropout(x, seed: int | None, site: int, rate: float,
                       impl: str = "auto"):
    """dropout(GELU(x)) with the exact (A&S erf) GELU and the mask of
    (``seed``, ``site``); ``seed`` may be None at rate 0.

    ``impl='auto'`` launches kernel H (H′ in the backward) for a CUDA
    tensor and takes the plain versions for a CPU tensor; ``'reference'``
    always takes the plain versions.
    """
    _build.check_impl(impl)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and seed is None:
        raise ValueError("dropout with a rate > 0 needs a seed")
    return _FusedGeluDropout.apply(x, 0 if seed is None else int(seed),
                                   int(site), float(rate), impl)
