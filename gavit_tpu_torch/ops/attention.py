"""Multi-head self-attention (counterpart of ``gavit_tpu/ops/attention.py``).

* :func:`attention_reference` — the plain PyTorch version: materialises the
  ``[B, H, N, N]`` scores, fp32 softmax, ``p`` rounded to the value dtype
  before ``p·v``. CPU tensors take it, and ``chip_smoke.py`` holds the
  kernel to it on the card.
* :func:`fused_qkv_attention` — the serving path: the qkv GEMM's raw
  ``[B, N, 3·H·d]`` rows in, ``[B, H, N, d]`` out. On a CUDA tensor it
  launches kernel A (``csrc/attention.cu``), which replaces the TPU kernel
  ``_fwd_kernel_v4``; it raises for anything that kernel does not take.

Forward only: the backward kernel (``_bwd_kernel_v4``) comes with training.
"""

from __future__ import annotations

import torch

from gavit_tpu_torch.ops import _build

# launches of kernel A since the last reset (chip_smoke.py reads it)
KERNEL_LAUNCHES = 0


def attention_reference(q, k, v, scale: float):
    """softmax(q kᵀ · scale) v for q, k, v ``[B, H, N, d]``.

    Products are taken in fp32 from the inputs' values (a bf16 product is
    exact in fp32), as ``preferred_element_type=float32`` does in JAX.
    """
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _split_heads(qkv3, heads: int):
    b, n, f = qkv3.shape
    d = f // (3 * heads)
    qkv5 = qkv3.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    return qkv5[0], qkv5[1], qkv5[2]


def qkv_attention_kernel(qkv3, scale: float, heads: int):
    """Kernel A on a CUDA tensor ``[B, N, 3·H·d]`` → ``[B, H, N, d]`` (a view
    of ``[B, N, H, d]`` memory)."""
    global KERNEL_LAUNCHES
    b, n, f = qkv3.shape
    d = f // (3 * heads)
    if 3 * heads * d != f or d != 64:
        raise ValueError(f"kernel A takes head_dim 64, got rows of {f} "
                         f"for {heads} heads")
    _build.require_cuda(qkv3)
    code = _build.dtype_code(qkv3.dtype)
    lib = _build.library()
    if not lib.gavit_attention_fits(n, code):
        raise ValueError(f"N={n} does not fit kernel A's shared memory "
                         "(long sequences wait for the blockwise kernel)")
    # written as [B, N, H, d]: the [B, H, N, d] view below merges heads for
    # the output projection without a copy
    out = torch.empty((b, n, heads, d), dtype=qkv3.dtype, device=qkv3.device)
    _build.check(lib.gavit_attention_fwd(
        qkv3.data_ptr(), out.data_ptr(), b, n, heads, d, float(scale), code,
        _build.stream(qkv3.device)), "attention kernel")
    with _build.count_lock:
        KERNEL_LAUNCHES += 1
    return out.transpose(1, 2)


def fused_qkv_attention(qkv, scale: float, merge_heads: bool = True,
                        impl: str = "auto"):
    """MHSA on the packed projection ``[B, N, 3, H, d]`` (a free view of the
    qkv GEMM's rows) → ``[B, N, H, d]``, or ``[B, H, N, d]`` with
    ``merge_heads=False`` for an output projection that contracts (h, d).

    ``impl='auto'`` launches kernel A for a CUDA tensor and takes
    :func:`attention_reference` for a CPU tensor; ``'reference'`` always
    takes the plain version.
    """
    _build.check_impl(impl)
    b, n, three, h, d = qkv.shape
    qkv3 = qkv.reshape(b, n, three * h * d)
    if impl == "reference" or qkv.device.type == "cpu":
        out = attention_reference(*_split_heads(qkv3, h), scale)
    else:
        out = qkv_attention_kernel(qkv3, scale, h)
    if merge_heads:
        return out.transpose(1, 2)
    return out
