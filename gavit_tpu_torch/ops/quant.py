"""int8 quantisation for serving and training (counterpart of
``gavit_tpu/ops/quant.py``).

* :func:`quantize_rowwise` — int8 with absmax scales along an axis;
  :func:`quantize_activation_static` — int8 against a calibrated per-tensor
  scale.
* :func:`static_int8_matmul` — static PTQ: the activation quantised against
  its calibrated scale, the weight quantised once offline (per output
  channel), the product accumulated in int32, rescaled in fp32;
  :func:`int8_matmul` — dynamic PTQ, both scales taken per call.
* :func:`fake_quant_act` / :func:`fake_quant_weight` — QAT's
  quantise-dequantise of each operand, as autograd functions: the
  activation's straight-through gradient is zero outside ±127·scale, the
  weight's is the identity (absmax scaling never clips).
* :func:`int8_mm` — the int8 GEMM ``xq · w_qᵀ`` → int32. The JAX package
  leaves it to XLA's ``dot_general`` with an int32 result (no Pallas
  kernel), so on a CUDA tensor it is cuBLASLt through ``torch._int_mm``.
  That call refuses M ≤ 16 and K or N that are not multiples of 8, so the
  wrapper pads with zero rows and columns and slices the result: the sum is
  integer, so the padding changes nothing. Where ``torch._int_mm`` is
  missing or refuses a shape it raises; nothing falls back to a float
  GEMM. The plain version (CPU tensors, ``impl='reference'``) accumulates
  in float64, exact for these sums (|q| ≤ 127, K·127² < 2⁵³).

The fp32 steps follow the JAX package's order (a true division by the
scale, round half to even, the clip; ``acc.float() * (act_scale *
w_scale)``), so on the same inputs the int32 sums and the outputs are
bit-equal between the packages and between the card and the plain
version.

Weights use ``nn.Linear``'s ``[out, in]`` layout, so a weight's
per-output-channel scale (the JAX kernel's per-column one) is taken over
its last axis, ``w_q`` is ``[N, K]`` (the JAX ``w_q`` transposed) and
``w_scale`` is ``[1, N]`` as in the JAX package.
"""

from __future__ import annotations

import torch

from gavit_tpu_torch.ops import _build

# int8 GEMM calls since the last reset (chip_smoke.py reads it)
INT8_MM_LAUNCHES = 0

# torch._int_mm on CUDA takes M > 16 and K, N multiples of 8
_MIN_ROWS = 17
_ALIGN = 8


def quantize_rowwise(x, axis: int = -1):
    """``(q int8, scale fp32)``: absmax scales along ``axis`` (kept as a
    size-1 dim), ``q = clip(round(x / scale), -127, 127)``."""
    x = x.float()
    absmax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_activation_static(x, act_scale):
    """int8 against a calibrated per-tensor scale: one division, round and
    clip pass (no absmax reduction)."""
    return torch.clamp(torch.round(x.float() / act_scale), -127,
                       127).to(torch.int8)


def _pad_to(n: int, align: int, least: int = 1) -> int:
    return max(least, -(-n // align) * align)


def int8_mm_kernel(xq, w_q):
    """``torch._int_mm`` on CUDA int8 tensors ``xq [M, K]`` and ``w_q [N, K]``
    → int32 ``[M, N]``, zero-padded to the shapes it takes. ``w_q``'s
    transpose is the column-major operand cuBLASLt's int8 path takes in
    every configuration (the "TN" layout)."""
    global INT8_MM_LAUNCHES
    if xq.device.type != "cuda" or w_q.device != xq.device:
        raise ValueError(f"the int8 GEMM takes CUDA tensors, not {xq.device} "
                         f"and {w_q.device}")
    if not hasattr(torch, "_int_mm"):
        raise RuntimeError("this PyTorch has no torch._int_mm: int8 serving "
                           "on the card needs it")
    m, k = xq.shape
    n = w_q.shape[0]
    mp, kp, np_ = _pad_to(m, 1, _MIN_ROWS), _pad_to(k, _ALIGN), \
        _pad_to(n, _ALIGN)
    if (mp, kp) != (m, k):
        xq = torch.nn.functional.pad(xq, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w_q = torch.nn.functional.pad(w_q, (0, kp - k, 0, np_ - n))
    acc = torch._int_mm(xq.contiguous(), w_q.contiguous().t())
    if not torch.compiler.is_compiling():  # a trace launches nothing
        with _build.count_lock:
            INT8_MM_LAUNCHES += 1
    if (mp, np_) != (m, n):
        acc = acc[:m, :n]
    return acc


def int8_mm_reference(xq, w_q):
    """The plain version: exact sums in float64, as int32."""
    return torch.matmul(xq.double(), w_q.double().t()).to(torch.int32)


def int8_mm(xq, w_q, impl: str = "auto"):
    """``xq [..., K]`` int8 · ``w_q [N, K]`` int8 → int32 ``[..., N]``.
    ``impl='auto'`` calls cuBLASLt on a CUDA tensor and the plain version on
    a CPU tensor; ``'reference'`` always the plain version."""
    _build.check_impl(impl)
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"the int8 GEMM takes int8 operands, not {xq.dtype} "
                        f"and {w_q.dtype}")
    shape = xq.shape
    x2 = xq.reshape(-1, shape[-1])
    if impl == "auto" and xq.device.type != "cpu":
        acc = int8_mm_kernel(x2, w_q)
    else:
        acc = int8_mm_reference(x2, w_q)
    return acc.reshape(*shape[:-1], w_q.shape[0])


def static_int8_matmul(x, w_q, w_scale, act_scale, impl: str = "auto"):
    """``x [..., K]`` · pre-quantised ``w_q [N, K]`` → ``[..., N]`` fp32:
    the activation quantised against the calibrated ``act_scale``, the
    int32 sum rescaled by ``act_scale * w_scale`` (``w_scale`` ``[1, N]``)."""
    acc = int8_mm(quantize_activation_static(x, act_scale), w_q, impl)
    return acc.float() * (act_scale * w_scale)


def int8_matmul(x, w, impl: str = "auto"):
    """``x [..., K]`` · ``w [N, K]`` (float) → ``[..., N]`` fp32, per-row
    activation and per-output-channel weight scales taken on the call
    (dynamic PTQ)."""
    xq, sx = quantize_rowwise(x, axis=-1)
    wq, sw = quantize_rowwise(w, axis=-1)
    acc = int8_mm(xq, wq, impl)
    return acc.float() * sx * sw.reshape(1, -1)


class _FakeQuantAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, act_scale):
        xf = x.float()
        ctx.save_for_backward(xf.abs() <= 127.0 * act_scale)
        q = torch.clamp(torch.round(xf / act_scale), -127, 127)
        return (q * act_scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (in_range,) = ctx.saved_tensors
        return torch.where(in_range, g, 0.0).to(g.dtype), None


def fake_quant_act(x, act_scale):
    """Quantise-dequantise ``x`` against a fixed per-tensor scale (QAT): the
    value the int8 serving path reconstructs for the activation operand.
    The gradient is the clipped straight-through estimator: the identity
    inside ``[-127·s, 127·s]``, zero outside."""
    return _FakeQuantAct.apply(x, act_scale)


class _FakeQuantWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        q, scale = quantize_rowwise(w, axis=-1)
        return (q.float() * scale).to(w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant_weight(w):
    """Quantise-dequantise ``w [N, K]`` with per-output-channel absmax scales
    (QAT), as the serving export quantises the final weights; the gradient
    is the identity."""
    return _FakeQuantWeight.apply(w)
