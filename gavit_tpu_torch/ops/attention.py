"""Multi-head self-attention (counterpart of ``gavit_tpu/ops/attention.py``).

* :func:`attention_reference` — the plain PyTorch version: materialises the
  ``[B, H, N, N]`` scores, fp32 softmax, ``p`` rounded to the value dtype
  before ``p·v``. CPU tensors take it, and ``chip_smoke.py`` holds the
  kernels to it on the card. With a keep mask it also drops attention
  probabilities: the training path of ``model.attn_drop_rate`` > 0, which
  leaves the kernels, as the JAX model leaves its Pallas kernels for XLA.
* :func:`attention_backward_reference` — the plain version of the TPU
  backwards ``_bwd_kernel_v4`` and ``_bwd_kernel_v3``: P recomputed,
  delta = rowsum(dP∘P), dq, dk, dv packed back into the ``[B, N, 3·H·d]``
  rows.
* :func:`fused_qkv_attention` — the qkv GEMM's raw ``[B, N, 3·H·d]`` rows
  in, ``[B, H, N, d]`` out, differentiable. On a CUDA tensor it launches the
  kernels :func:`attention_route` names for the sequence length and dtype:
  kernel A (``csrc/attention.cu``, replaces ``_fwd_kernel_v4``) with A′ in
  the backward (``csrc/attention_bwd.cu``, replaces ``_bwd_kernel_v4``), or
  kernel K with K′ (``csrc/attention_long.cu``, replace ``_fwd_kernel_v3``
  and ``_bwd_kernel_v3``), or the blockwise kernel L with L′
  (``csrc/attention_large.cu``, replace ``_fwd_kernel_v5``,
  ``_dq_kernel_v5`` and ``_dkv_kernel_v5``); it raises for anything those
  kernels do not take.
* :func:`blockwise_attention_reference` and
  :func:`blockwise_attention_backward_reference` — the plain versions of L
  and L′: the forward also returns the fp32 log-sum-exp of each row, which
  the backward reads instead of recomputing the row statistics.
"""

from __future__ import annotations

import torch

from gavit_tpu_torch.ops import _build

# launches since the last reset (chip_smoke.py reads them): kernels A, A′,
# K, K′, L and L′
KERNEL_LAUNCHES = 0
BWD_KERNEL_LAUNCHES = 0
LONG_KERNEL_LAUNCHES = 0
LONG_BWD_KERNEL_LAUNCHES = 0
LARGE_KERNEL_LAUNCHES = 0
LARGE_BWD_KERNEL_LAUNCHES = 0

# the longest rows kernel A takes: its tensor-core body keeps the scores of
# 224 keys in registers (bf16); its fp32 body stages K and V of a head in
# shared memory (attn_smem_bytes(416) = 231,680 of 232,448 bytes)
A_MAX_N = {torch.bfloat16: 224, torch.float32: 416}
# the longest rows kernels K/K′ take. They stream key tiles and would run at
# any N; the bound is the JAX package's own switch from the exact v3 kernels
# to the blockwise v5 ones (``_v3_fits`` at head_dim 64 in bf16: 2·7·N·64·2
# + 5·N²·4 bytes within its 12 MiB budget), so both packages run the exact
# kernels over the same range and the blockwise kernels L/L′ take the rest.
K_MAX_N = 749
# what card attention in fp32 past kernel A's forward waits for (A′, K/K′
# and L/L′ are bf16 only)
_FP32_TODO = "fp32 attention on the card waits for ROADMAP Queue 1 item 10"


def attention_route(n: int, dtype: torch.dtype) -> str:
    """The kernel family that takes rows of ``n`` tokens in ``dtype`` on the
    card: ``'A'`` (A/A′, bf16 up to 224 tokens; fp32 forward up to 416),
    ``'K'`` (K/K′, bf16 past 224 up to :data:`K_MAX_N`) or ``'L'`` (L/L′,
    bf16 past :data:`K_MAX_N`)."""
    if n < 1:
        raise ValueError(f"attention over {n} tokens")
    if n <= A_MAX_N.get(dtype, 0):
        return "A"
    if dtype == torch.bfloat16:
        return "K" if n <= K_MAX_N else "L"
    raise NotImplementedError(
        f"no attention kernel takes {dtype} rows of {n} tokens (fp32 up to "
        f"{A_MAX_N[torch.float32]}, bf16 at any length): {_FP32_TODO}")


def plain_route(n: int) -> str:
    """The family whose plain versions stand in for the kernels on a CPU
    tensor or under ``impl='reference'``: ``'L'`` (blockwise, with the saved
    log-sum-exp) past :data:`K_MAX_N`, as on the card, else ``'A'`` (A and
    K share theirs)."""
    return "L" if n > K_MAX_N else "A"


def attention_reference(q, k, v, scale: float, dropout_rate: float = 0.0,
                        keep=None):
    """softmax(q kᵀ · scale) v for q, k, v ``[B, H, N, d]``.

    Products are taken in fp32 from the inputs' values (a bf16 product is
    exact in fp32), as ``preferred_element_type=float32`` does in JAX. With
    ``keep`` (bool ``[B, H, N, N]``) the fp32 probabilities are dropped where
    it is false and the rest scaled by 1/(1 - ``dropout_rate``), as
    ``gavit_tpu.ops.attention.attention_reference`` drops them
    (attention.py:68-92); the model draws ``keep`` from Philox.
    """
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _split_heads(qkv3, heads: int):
    b, n, f = qkv3.shape
    d = f // (3 * heads)
    qkv5 = qkv3.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    return qkv5[0], qkv5[1], qkv5[2]


def _check_rows(qkv3, heads: int, what: str):
    """(b, n, d) of packed rows a kernel takes: head_dim 64, on the card."""
    b, n, f = qkv3.shape
    d = f // (3 * heads)
    if 3 * heads * d != f or d != 64:
        raise ValueError(f"{what} takes head_dim 64, got rows of {f} "
                         f"for {heads} heads")
    _build.require_cuda(qkv3)
    return b, n, d


def _dout_strides(dout, qkv3, heads: int, what: str = "dout"):
    """dout (or kernel L's o) ``[B, H, N, d]`` read through its strides
    (last dim contiguous, rows 16-byte aligned; otherwise copied first) →
    (dout, sb, sh, sn)."""
    b, n, _ = qkv3.shape
    d = qkv3.shape[2] // (3 * heads)
    if dout.shape != (b, heads, n, d) or dout.dtype != qkv3.dtype:
        raise ValueError(f"{what} {tuple(dout.shape)} {dout.dtype} does not "
                         f"match qkv {tuple(qkv3.shape)} {qkv3.dtype}")
    sb, sh, sn, sc = dout.stride()
    if (sc != 1 or any(x % 8 for x in (sb, sh, sn))
            or dout.data_ptr() % 16 or dout.device != qkv3.device):
        dout = dout.contiguous()
        sb, sh, sn, sc = dout.stride()
    return dout, sb, sh, sn


def qkv_attention_kernel(qkv3, scale: float, heads: int):
    """Kernel A on a CUDA tensor ``[B, N, 3·H·d]`` → ``[B, H, N, d]`` (a view
    of ``[B, N, H, d]`` memory)."""
    global KERNEL_LAUNCHES
    b, n, d = _check_rows(qkv3, heads, "kernel A")
    code = _build.dtype_code(qkv3.dtype)
    lib = _build.library()
    if not lib.gavit_attention_fits(n, code):
        raise ValueError(f"N={n} does not fit kernel A ({qkv3.dtype} up to "
                         f"N={A_MAX_N[qkv3.dtype]}; longer bf16 rows take "
                         "kernel K)")
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

    As the TPU kernels: p in fp32, dv = bf16(p)ᵀ·do, dp = do·vᵀ,
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
    and ``dout [B, H, N, d]``, read through its strides → ``dqkv3`` like
    qkv3."""
    global BWD_KERNEL_LAUNCHES
    b, n, d = _check_rows(qkv3, heads, "kernel A′")
    code = _build.dtype_code(qkv3.dtype)
    lib = _build.library()
    if not lib.gavit_attention_bwd_fits(n, code):
        raise NotImplementedError(
            f"kernel A′ takes bf16 with N <= 224, got {qkv3.dtype} N={n}: "
            f"longer bf16 rows take kernel K′ or L′; {_FP32_TODO}")
    dout, sb, sh, sn = _dout_strides(dout, qkv3, heads)
    dqkv = torch.empty_like(qkv3)
    _build.check(lib.gavit_attention_bwd(
        qkv3.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), b, n, heads, d,
        sb, sh, sn, float(scale), code, _build.stream(qkv3.device)),
        "attention backward kernel")
    with _build.count_lock:
        BWD_KERNEL_LAUNCHES += 1
    return dqkv


def _check_long(qkv3, heads: int, what: str, large: bool = False):
    """K/K′ take bf16 rows up to :data:`K_MAX_N` tokens, L/L′
    (``large``) at any length."""
    b, n, d = _check_rows(qkv3, heads, what)
    if qkv3.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bfloat16 rows, not {qkv3.dtype}")
    if n > K_MAX_N and not large:
        raise ValueError(
            f"{what} takes N <= {K_MAX_N}, got {n}: longer rows take the "
            "blockwise kernels L/L′ (attention_route 'L')")
    return b, n, d


def qkv_attention_long_kernel(qkv3, scale: float, heads: int):
    """Kernel K on a CUDA bf16 tensor ``[B, N, 3·H·d]`` → ``[B, H, N, d]``
    (a view of ``[B, N, H, d]`` memory, as kernel A's)."""
    global LONG_KERNEL_LAUNCHES
    b, n, d = _check_long(qkv3, heads, "kernel K")
    out = torch.empty((b, n, heads, d), dtype=qkv3.dtype, device=qkv3.device)
    lib = _build.library()
    _build.check(lib.gavit_attention_long_fwd(
        qkv3.data_ptr(), out.data_ptr(), b, n, heads, d, float(scale),
        _build.stream(qkv3.device)), "long attention kernel")
    with _build.count_lock:
        LONG_KERNEL_LAUNCHES += 1
    return out.transpose(1, 2)


def qkv_attention_long_bwd_kernel(qkv3, dout, scale: float, heads: int):
    """Kernel K′ on CUDA bf16 tensors, the arguments as
    :func:`qkv_attention_bwd_kernel`'s → ``dqkv3`` like qkv3. Its two
    launches share a ``[3, B, H, N]`` fp32 scratch of row statistics."""
    global LONG_BWD_KERNEL_LAUNCHES
    b, n, d = _check_long(qkv3, heads, "kernel K′")
    dout, sb, sh, sn = _dout_strides(dout, qkv3, heads)
    dqkv = torch.empty_like(qkv3)
    stats = torch.empty((3, b, heads, n), dtype=torch.float32,
                        device=qkv3.device)
    lib = _build.library()
    _build.check(lib.gavit_attention_long_bwd(
        qkv3.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        b, n, heads, d, sb, sh, sn, float(scale),
        _build.stream(qkv3.device)), "long attention backward kernel")
    with _build.count_lock:
        LONG_BWD_KERNEL_LAUNCHES += 1
    return dqkv


def blockwise_attention_reference(qkv3, scale: float, heads: int):
    """The plain version of kernel L: ``qkv3 [B, N, 3·H·d]`` →
    ``(o [B, H, N, d], lse [B, H, N] fp32)``, the rounding points of
    ``_fwd_kernel_v5``: fp32 scores from the inputs' values, the
    unnormalised ``p = exp(s − m)`` (m the row's max) rounded to the value
    dtype before ``p·v``, divided by the fp32 row sum ``l`` of the unrounded
    ``p``; ``lse = m + log l``. The kernel's running max moves from tile to
    tile, so its ``p`` rounds against other maxima: the same function, bf16
    roundings apart."""
    q, k, v = _split_heads(qkv3, heads)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def blockwise_attention_backward_reference(qkv3, o, lse, dout, scale: float,
                                           heads: int):
    """The plain version of kernel L′, the VJP of
    :func:`blockwise_attention_reference` from its saved ``o`` and ``lse``:
    ``p = exp(s − lse)`` in fp32, ``delta = rowsum(do∘o)`` in fp32 (as the
    JAX package's ``_run_bwd_v5_impl``), dv = bf16(p)ᵀ·do, dp = do·vᵀ,
    ds = (p∘(dp − delta)·scale) rounded to the input dtype, dq = ds·k,
    dk = dsᵀ·q, packed into ``dqkv3`` like qkv3."""
    dt = qkv3.dtype
    b, n, f = qkv3.shape
    q, k, v = (t.float() for t in _split_heads(qkv3, heads))
    do = dout.float()
    p = torch.exp(torch.matmul(q, k.transpose(-1, -2)) * scale
                  - lse.unsqueeze(-1))
    delta = (do * o.float()).sum(-1, keepdim=True)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(b, n, f).to(dt)


def qkv_attention_large_kernel(qkv3, scale: float, heads: int):
    """Kernel L on a CUDA bf16 tensor ``[B, N, 3·H·d]`` →
    ``(o [B, H, N, d], lse [B, H, N] fp32)``; o is a view of
    ``[B, N, H, d]`` memory, as kernel A's."""
    global LARGE_KERNEL_LAUNCHES
    b, n, d = _check_long(qkv3, heads, "kernel L", large=True)
    out = torch.empty((b, n, heads, d), dtype=qkv3.dtype, device=qkv3.device)
    lse = torch.empty((b, heads, n), dtype=torch.float32, device=qkv3.device)
    lib = _build.library()
    _build.check(lib.gavit_attention_large_fwd(
        qkv3.data_ptr(), out.data_ptr(), lse.data_ptr(), b, n, heads, d,
        float(scale), _build.stream(qkv3.device)), "blockwise attention kernel")
    with _build.count_lock:
        LARGE_KERNEL_LAUNCHES += 1
    return out.transpose(1, 2), lse


def qkv_attention_large_bwd_kernel(qkv3, o, lse, dout, scale: float,
                                   heads: int):
    """Kernel L′ on CUDA tensors: ``qkv3 [B, N, 3·H·d]`` bf16 (contiguous),
    kernel L's ``o`` and ``lse``, and ``dout [B, H, N, d]``; o and dout are
    read through their strides → ``dqkv3`` like qkv3. Its two launches
    share a ``[B, H, N]`` fp32 scratch of delta = rowsum(do∘o), which the
    query-major launch writes."""
    global LARGE_BWD_KERNEL_LAUNCHES
    b, n, d = _check_long(qkv3, heads, "kernel L′", large=True)
    dout, sb, sh, sn = _dout_strides(dout, qkv3, heads)
    o, ob, oh, on = _dout_strides(o, qkv3, heads, "o")
    if lse.shape != (b, heads, n) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} is not kernel "
                         f"L's [{b}, {heads}, {n}] float32")
    _build.require_cuda(qkv3, lse)
    dqkv = torch.empty_like(qkv3)
    delta = torch.empty_like(lse)
    lib = _build.library()
    _build.check(lib.gavit_attention_large_bwd(
        qkv3.data_ptr(), o.data_ptr(), lse.data_ptr(), dout.data_ptr(),
        dqkv.data_ptr(), delta.data_ptr(), b, n, heads, d, ob, oh, on,
        sb, sh, sn, float(scale), _build.stream(qkv3.device)),
        "blockwise attention backward kernel")
    with _build.count_lock:
        LARGE_BWD_KERNEL_LAUNCHES += 1
    return dqkv


_FORWARD = {"A": qkv_attention_kernel, "K": qkv_attention_long_kernel}
_BACKWARD = {"A": qkv_attention_bwd_kernel, "K": qkv_attention_long_bwd_kernel}


def _forward(qkv3, scale: float, heads: int, route: str, kernel: bool):
    """o (and, for route 'L', lse) through the kernel or its plain
    version."""
    if route == "L":
        return (qkv_attention_large_kernel if kernel
                else blockwise_attention_reference)(qkv3, scale, heads)
    if kernel:
        return _FORWARD[route](qkv3, scale, heads)
    return attention_reference(*_split_heads(qkv3, heads), scale)


class _FusedQkvAttention(torch.autograd.Function):
    """[B, N, 3·H·d] rows → [B, H, N, d]. Routes A and K save only the rows
    (their backwards recompute the row statistics); route L also saves o
    and the fp32 lse, which L′ reads, as ``_fa5_fwd`` saves them.
    ``kernel``: launch the route's kernels, else take their plain
    versions."""

    @staticmethod
    def forward(ctx, qkv3, scale, heads, route, kernel):
        ctx.args = (scale, heads, route, kernel)
        if route != "L":
            ctx.save_for_backward(qkv3)
            return _forward(qkv3, scale, heads, route, kernel)
        out, lse = _forward(qkv3, scale, heads, route, kernel)
        ctx.save_for_backward(qkv3, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        scale, heads, route, kernel = ctx.args
        if route == "L":
            qkv3, out, lse = ctx.saved_tensors
            bwd = (qkv_attention_large_bwd_kernel if kernel
                   else blockwise_attention_backward_reference)
            dqkv = bwd(qkv3, out, lse, g, scale, heads)
        else:
            (qkv3,) = ctx.saved_tensors
            bwd = _BACKWARD[route] if kernel else \
                attention_backward_reference
            dqkv = bwd(qkv3, g, scale, heads)
        return dqkv, None, None, None, None


def fused_qkv_attention(qkv, scale: float, merge_heads: bool = True,
                        impl: str = "auto"):
    """MHSA on the packed projection ``[B, N, 3, H, d]`` (a free view of the
    qkv GEMM's rows) → ``[B, N, H, d]``, or ``[B, H, N, d]`` with
    ``merge_heads=False`` for an output projection that contracts (h, d).

    ``impl='auto'`` launches the kernels of :func:`attention_route` (A/A′,
    K/K′ or L/L′) for a CUDA tensor and takes the plain versions of
    :func:`plain_route` for a CPU tensor; ``'reference'`` always takes the
    plain versions.
    """
    _build.check_impl(impl)
    b, n, three, h, d = qkv.shape
    qkv3 = qkv.reshape(b, n, three * h * d)
    kernel = impl == "auto" and qkv.device.type != "cpu"
    route = attention_route(n, qkv.dtype) if kernel else plain_route(n)
    if torch.is_grad_enabled() and qkv.requires_grad:
        out = _FusedQkvAttention.apply(qkv3, float(scale), h, route, kernel)
    else:
        out = _forward(qkv3, scale, h, route, kernel)
        if route == "L":
            out = out[0]
    if merge_heads:
        return out.transpose(1, 2)
    return out
