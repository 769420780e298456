"""Inference MLP (counterpart of the serving half of ``gavit_tpu/ops/mlp.py``).

* :func:`_chain_infer` — the plain PyTorch version of
  ``GELU(x·W1+b1)·W2+b2`` with the TPU kernel's rounding: ``h1`` is rounded
  to the compute dtype before the GELU, the GELU output again before fc2.
* :func:`fused_mlp_inference` — the serving entry point. On a CUDA bf16
  tensor it launches kernel B (``csrc/mlp.cu``), which replaces the TPU
  kernel ``_mlp_infer_kernel``.

Weights use ``nn.Linear``'s layout: ``w1 [F, D]``, ``w2 [D, F]``. The
training MLP kernels (``_mlp_fwd_kernel`` / ``_mlp_bwd_kernel``) come with
training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gavit_tpu_torch.ops import _build

# launches of kernel B since the last reset (chip_smoke.py reads it)
KERNEL_LAUNCHES = 0


def _chain_infer(x2, w1, b1, w2, b2, approximate: bool):
    """``[M, D]`` → ``[M, D]`` in x2's dtype, fp32 accumulation."""
    h1 = (torch.matmul(x2.float(), w1.float().t()) + b1.float()).to(x2.dtype)
    g = F.gelu(h1.float(), approximate="tanh" if approximate else "none")
    y = torch.matmul(g.to(x2.dtype).float(), w2.float().t()) + b2.float()
    return y.to(x2.dtype)


def mlp_inference_kernel(x2, w1, b1, w2, b2, approximate: bool):
    """Kernel B on CUDA bf16 tensors: two tensor-core GEMM launches, fc1 with
    a bias + GELU epilogue into a bf16 scratch ``h``, fc2 with a bias
    epilogue."""
    global KERNEL_LAUNCHES
    m, d = x2.shape
    f = w1.shape[0]
    if (w1.shape != (f, d) or b1.shape != (f,) or w2.shape != (d, f)
            or b2.shape != (d,)):
        raise ValueError(f"MLP shapes x {tuple(x2.shape)} w1 "
                         f"{tuple(w1.shape)} b1 {tuple(b1.shape)} w2 "
                         f"{tuple(w2.shape)} b2 {tuple(b2.shape)}")
    if d % 8 or f % 8:
        raise ValueError(f"kernel B takes widths divisible by 8, got {d}, {f}")
    for t in (x2, w1, b1, w2, b2):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"kernel B takes bfloat16 tensors, not {t.dtype}")
    _build.require_cuda(x2, w1, b1, w2, b2)
    h = torch.empty((m, f), dtype=x2.dtype, device=x2.device)
    y = torch.empty((m, d), dtype=x2.dtype, device=x2.device)
    lib = _build.library()
    _build.check(lib.gavit_mlp_infer(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), h.data_ptr(), y.data_ptr(), m, d, f, int(approximate),
        _build.stream(x2.device)), "MLP kernel")
    with _build.count_lock:
        KERNEL_LAUNCHES += 1
    return y


def fused_mlp_inference(x, w1, b1, w2, b2, approximate: bool = True,
                        impl: str = "auto"):
    """``GELU(x·W1+b1)·W2+b2`` over the last dim of ``x``; tanh GELU when
    ``approximate`` (the bf16 serving form), erf otherwise.

    Dispatch by device and dtype, never by failure:

    * CPU tensors, and ``impl='reference'``, take :func:`_chain_infer`.
    * CUDA bf16 launches kernel B for every M, masking the ragged edge. The
      TPU's rule that the row block divide M (``pick_block``,
      gavit_tpu/ops/mlp.py:93-121) serves the training backward's bias sum
      and does not carry over.
    * CUDA fp32 takes :func:`_chain_infer`: at ViT widths the JAX package
      makes the same choice, because fp32 weights exceed its VMEM budget and
      ``pick_block`` returns None (gavit_tpu/ops/mlp.py:111-115), so the fp32
      parity path is the GEMM chain there too.
    """
    _build.check_impl(impl)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if (impl == "auto" and x.device.type != "cpu"
            and x.dtype == torch.bfloat16):
        y = mlp_inference_kernel(x2, w1, b1, w2, b2, approximate)
    else:
        y = _chain_infer(x2, w1, b1, w2, b2, approximate)
    return y.reshape(shape)
