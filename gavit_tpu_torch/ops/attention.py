"""Multi-head self-attention (counterpart of ``gavit_tpu/ops/attention.py``).

* :func:`attention_reference` — the plain PyTorch version: materialises the
  ``[B, H, N, N]`` scores, fp32 softmax, ``p`` rounded to the value dtype
  before ``p·v``. CPU tensors take it, and ``chip_smoke.py`` holds the
  kernel to it on the card.
* :func:`attention_backward_reference` — the plain version of the TPU
  backward ``_bwd_kernel_v4``: P recomputed, delta = rowsum(dP∘P), dq, dk,
  dv packed back into the ``[B, N, 3·H·d]`` rows.
* :func:`fused_qkv_attention` — the qkv GEMM's raw ``[B, N, 3·H·d]`` rows
  in, ``[B, H, N, d]`` out, differentiable. On a CUDA tensor it launches
  kernel A (``csrc/attention.cu``, replaces ``_fwd_kernel_v4``) and, in the
  backward, kernel A′ (``csrc/attention_bwd.cu``, replaces
  ``_bwd_kernel_v4``); it raises for anything those kernels do not take.
"""

from __future__ import annotations

import torch

from gavit_tpu_torch.ops import _build

# launches since the last reset (chip_smoke.py reads them): kernel A and
# the backward kernel A′
KERNEL_LAUNCHES = 0
BWD_KERNEL_LAUNCHES = 0


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


def attention_backward_reference(qkv3, dout, scale: float, heads: int):
    """The VJP of :func:`attention_reference` on the packed rows:
    ``qkv3 [B, N, 3·H·d]`` and ``dout [B, H, N, d]`` → ``dqkv3`` like qkv3.

    As the TPU kernel: p in fp32, dv = bf16(p)ᵀ·do, dp = do·vᵀ,
    delta = rowsum(dp∘p), ds = (p∘(dp − delta)·scale) rounded to the input
    dtype, dq = ds·k, dk = dsᵀ·q, fp32 products from the inputs' values.
    """
    dt = qkv3.dtype
    b, n, f = qkv3.shape
    q, k, v = (t.float() for t in _split_heads(qkv3, heads))
    do = dout.float()
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    # [3, B, H, N, d] → [B, N, 3, H, d] → rows
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(b, n, f).to(dt)


def qkv_attention_bwd_kernel(qkv3, dout, scale: float, heads: int):
    """Kernel A′ on CUDA tensors: ``qkv3 [B, N, 3·H·d]`` bf16 (contiguous)
    and ``dout [B, H, N, d]``, read through its strides (its last dim
    contiguous, rows 16-byte aligned; otherwise it is copied first) →
    ``dqkv3`` like qkv3."""
    global BWD_KERNEL_LAUNCHES
    b, n, f = qkv3.shape
    d = f // (3 * heads)
    if 3 * heads * d != f or d != 64:
        raise ValueError(f"kernel A′ takes head_dim 64, got rows of {f} "
                         f"for {heads} heads")
    if dout.shape != (b, heads, n, d) or dout.dtype != qkv3.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"match qkv {tuple(qkv3.shape)} {qkv3.dtype}")
    _build.require_cuda(qkv3)
    code = _build.dtype_code(qkv3.dtype)
    lib = _build.library()
    if not lib.gavit_attention_bwd_fits(n, code):
        raise NotImplementedError(
            f"kernel A′ takes bf16 with N <= 224, got {qkv3.dtype} N={n}: "
            "fp32 and longer sequences wait for ROADMAP Queue 2 item 10 "
            "(the blockwise kernels L/L′)")
    sb, sh, sn, sc = dout.stride()
    if (sc != 1 or any(x % 8 for x in (sb, sh, sn))
            or dout.data_ptr() % 16 or dout.device != qkv3.device):
        dout = dout.contiguous()
        sb, sh, sn, sc = dout.stride()
    dqkv = torch.empty_like(qkv3)
    _build.check(lib.gavit_attention_bwd(
        qkv3.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), b, n, heads, d,
        sb, sh, sn, float(scale), code, _build.stream(qkv3.device)),
        "attention backward kernel")
    with _build.count_lock:
        BWD_KERNEL_LAUNCHES += 1
    return dqkv


class _FusedQkvAttention(torch.autograd.Function):
    """[B, N, 3·H·d] rows → [B, H, N, d]; saves only the rows."""

    @staticmethod
    def forward(ctx, qkv3, scale, heads, use_kernel):
        ctx.save_for_backward(qkv3)
        ctx.args = (scale, heads, use_kernel)
        if use_kernel:
            # a [B, H, N, d] view of [B, N, H, d] memory
            return qkv_attention_kernel(qkv3, scale, heads)
        return attention_reference(*_split_heads(qkv3, heads), scale)

    @staticmethod
    def backward(ctx, g):
        (qkv3,) = ctx.saved_tensors
        scale, heads, use_kernel = ctx.args
        if use_kernel:
            return qkv_attention_bwd_kernel(qkv3, g, scale, heads), None, \
                None, None
        return attention_backward_reference(qkv3, g, scale, heads), None, \
            None, None


def fused_qkv_attention(qkv, scale: float, merge_heads: bool = True,
                        impl: str = "auto"):
    """MHSA on the packed projection ``[B, N, 3, H, d]`` (a free view of the
    qkv GEMM's rows) → ``[B, N, H, d]``, or ``[B, H, N, d]`` with
    ``merge_heads=False`` for an output projection that contracts (h, d).

    ``impl='auto'`` launches kernel A (and A′ in the backward) for a CUDA
    tensor and takes the plain versions for a CPU tensor; ``'reference'``
    always takes the plain versions.
    """
    _build.check_impl(impl)
    b, n, three, h, d = qkv.shape
    qkv3 = qkv.reshape(b, n, three * h * d)
    use_kernel = impl == "auto" and qkv.device.type != "cpu"
    if torch.is_grad_enabled() and qkv.requires_grad:
        out = _FusedQkvAttention.apply(qkv3, float(scale), h, use_kernel)
    elif use_kernel:
        out = qkv_attention_kernel(qkv3, scale, h)
    else:
        out = attention_reference(*_split_heads(qkv3, h), scale)
    if merge_heads:
        return out.transpose(1, 2)
    return out
