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
  kernel A (replaces ``_fwd_kernel_v4``; bf16 in
  ``csrc/attention_fwd_sm90.cu``, fp32 in ``csrc/attention.cu``) with A′
  in the backward (replaces ``_bwd_kernel_v4``; fp32 in
  ``csrc/attention.cu`` too), or kernel K with K′
  (replace ``_fwd_kernel_v3`` and ``_bwd_kernel_v3``), or the blockwise
  kernel L with L′ (replace ``_fwd_kernel_v5``, ``_dq_kernel_v5`` and
  ``_dkv_kernel_v5``); the forwards are ``csrc/attention_fwd_sm90.cu``'s,
  the backwards ``csrc/attention_bwd_sm90.cu``'s (K′ and L′ one kernel
  pair, L′ in its mode that reads L's lse and o; A′ two launches of its
  own for bf16 rows of up to 224 tokens, two CUDA-core launches for fp32
  rows of up to 416); it raises for anything those kernels do not take.
* :func:`blockwise_attention_reference` and
  :func:`blockwise_attention_backward_reference` — the plain versions of L
  and L′: the forward also returns the fp32 log-sum-exp of each row, which
  the backward reads instead of recomputing the row statistics.
* :func:`multi_head_attention`, :func:`attention_pallas` and
  :func:`fused_attention_v2` — MHSA over separate q, k, v ``[B, H, N, d]``,
  differentiable, dispatched as the JAX functions of those names are. On a
  CUDA tensor :func:`attention_pallas` launches kernel I with I′ in the
  backward (replace ``_fwd_kernel``/``_bwd_kernel``, v1) up to the length
  :func:`pallas_route` gives, and L/L′ past it; :func:`fused_attention_v2`
  launches kernel J with J′ (replace ``_fwd_kernel_v2``/``_bwd_kernel_v2``)
  at every length. I and J are the bf16 attention forward of A and K
  (``csrc/attention_fwd_sm90.cu``), I′ and J′ the backward pair
  (``csrc/attention_bwd_sm90.cu``), all reading and writing ``[B, H, N, d]``
  through strides, each entry point with its own launch counts; their plain
  versions are :func:`attention_reference` and
  :func:`attention_bhnd_backward_reference`.
"""

from __future__ import annotations

import torch

from gavit_tpu_torch.ops import _build, philox

# launches since the last reset (chip_smoke.py reads them): kernels A, A′
# (bf16; its fp32 launches apart), K, K′, L and L′
KERNEL_LAUNCHES = 0
BWD_KERNEL_LAUNCHES = 0
BWD_F32_KERNEL_LAUNCHES = 0
LONG_KERNEL_LAUNCHES = 0
LONG_BWD_KERNEL_LAUNCHES = 0
LARGE_KERNEL_LAUNCHES = 0
LARGE_BWD_KERNEL_LAUNCHES = 0
# and kernels I, I′ (attention_pallas) and J, J′ (fused_attention_v2)
V1_KERNEL_LAUNCHES = 0
V1_BWD_KERNEL_LAUNCHES = 0
V2_KERNEL_LAUNCHES = 0
V2_BWD_KERNEL_LAUNCHES = 0

# the longest rows kernel A takes: its bf16 body (the single pass of
# csrc/attention_fwd_sm90.cu) keeps the scores of 224 keys in registers;
# its fp32 body stages K and V of a head in shared memory
# (attn_smem_bytes(416) = 231,680 of 232,448 bytes)
A_MAX_N = {torch.bfloat16: 224, torch.float32: 416}
# the longest rows kernels K/K′ take. They stream key tiles and would run at
# any N; the bound is the JAX package's own switch from the exact v3 kernels
# to the blockwise v5 ones (``_v3_fits`` at head_dim 64 in bf16: 2·7·N·64·2
# + 5·N²·4 bytes within its 12 MiB budget), so both packages run the exact
# kernels over the same range and the blockwise kernels L/L′ take the rest.
K_MAX_N = 749
# what card attention in fp32 past kernels A/A′ waits for (they take fp32
# rows up to A_MAX_N; K/K′ and L/L′ are bf16 only: the kernels of
# csrc/attention_bwd_sm90.cu take bf16 at head_dim 64)
_FP32_TODO = ("fp32 attention on the card waits for ROADMAP Queue 2 item "
              "10.7 (Queue 1 item 10)")
# attention_pallas's switch from v1 to the blockwise v5, copied from the JAX
# package (attention.py:53-58, :1083-1086, its 12 MiB VMEM budget): tokens
# padded to a multiple of 128 lanes, and the exact backward's estimate at
# one head per program within the budget
_LANE = 128
_VMEM_BUDGET = 12 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _v3_fits(n: int, d: int, itemsize: int) -> bool:
    return 2 * 7 * n * d * itemsize + 5 * n * n * 4 <= _VMEM_BUDGET


def pallas_route(n: int, d: int, dtype: torch.dtype) -> str:
    """The family :func:`attention_pallas` takes for ``n`` tokens of head_dim
    ``d`` in ``dtype``: ``'I'`` (I/I′) where the JAX package runs its v1
    kernels, ``'L'`` (L/L′) where it runs v5 — N up to 640 and from 641 at
    head_dim 64, in bf16 and fp32 alike."""
    if n < 1:
        raise ValueError(f"attention over {n} tokens")
    n_pad = max(_round_up(n, _LANE), _LANE)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return "I" if _v3_fits(n_pad, d, itemsize) else "L"


def attention_route(n: int, dtype: torch.dtype) -> str:
    """The kernel family that takes rows of ``n`` tokens in ``dtype`` on the
    card: ``'A'`` (A/A′, bf16 up to 224 tokens, fp32 up to 416),
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
                        keep=None, return_probs: bool = False):
    """softmax(q kᵀ · scale) v for q, k, v ``[B, H, N, d]``.

    Products are taken in fp32 from the inputs' values (a bf16 product is
    exact in fp32), as ``preferred_element_type=float32`` does in JAX. With
    ``keep`` (bool ``[B, H, N, N]``) the fp32 probabilities are dropped where
    it is false and the rest scaled by 1/(1 - ``dropout_rate``), as
    ``gavit_tpu.ops.attention.attention_reference`` drops them
    (attention.py:68-92); the model draws ``keep`` from Philox.
    ``return_probs``: also return those fp32 ``[B, H, N, N]`` probabilities
    (the interpretability capture; no kernel materialises them).
    """
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    out = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    return (out, p) if return_probs else out


def _split_heads(qkv3, heads: int):
    b, n, f = qkv3.shape
    d = f // (3 * heads)
    qkv5 = qkv3.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    return qkv5[0], qkv5[1], qkv5[2]


def _rows_shape(qkv3, heads: int, what: str):
    """(b, n, d) of packed rows a kernel takes: head_dim 64. Shapes only, so
    it holds under ``torch.export``'s fake tensors too."""
    b, n, f = qkv3.shape
    d = f // (3 * heads)
    if 3 * heads * d != f or d != 64:
        raise ValueError(f"{what} takes head_dim 64, got rows of {f} "
                         f"for {heads} heads")
    return b, n, d


def _check_rows(qkv3, heads: int, what: str):
    """:func:`_rows_shape`, and the rows on the card, contiguous and
    aligned (inside a launch: real tensors only)."""
    b, n, d = _rows_shape(qkv3, heads, what)
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
    dout = _build.aligned(dout, rows=True)
    sb, sh, sn, _ = dout.stride()
    return dout, sb, sh, sn


def qkv_attention_kernel(qkv3, scale: float, heads: int):
    """Kernel A on a CUDA tensor ``[B, N, 3·H·d]`` → ``[B, H, N, d]`` (a view
    of ``[B, N, H, d]`` memory), through the custom op
    ``gavit_tpu_torch::attention_fwd``."""
    _rows_shape(qkv3, heads, "kernel A")
    _build.require_device(qkv3)
    return torch.ops.gavit_tpu_torch.attention_fwd(
        qkv3, float(scale), heads).transpose(1, 2)


@torch.library.custom_op("gavit_tpu_torch::attention_fwd", mutates_args=(),
                         device_types="cuda")
def _attention_fwd_op(qkv3: torch.Tensor, scale: float,
                      heads: int) -> torch.Tensor:
    """Kernel A's launch: ``[B, N, 3·H·d]`` → contiguous ``[B, N, H, d]``."""
    global KERNEL_LAUNCHES
    b, n, d = _check_rows(qkv3, heads, "kernel A")
    code = _build.dtype_code(qkv3.dtype)
    lib = _build.library()
    if not lib.gavit_attention_fits(n, code):
        raise ValueError(f"N={n} does not fit kernel A ({qkv3.dtype} up to "
                         f"N={A_MAX_N[qkv3.dtype]}; longer bf16 rows take "
                         "kernel K)")
    # written as [B, N, H, d]: the [B, H, N, d] view the wrapper takes
    # merges heads for the output projection without a copy
    out = torch.empty((b, n, heads, d), dtype=qkv3.dtype, device=qkv3.device)
    _build.check(lib.gavit_attention_fwd(
        qkv3.data_ptr(), out.data_ptr(), b, n, heads, d, float(scale), code,
        _build.stream(qkv3.device)), "attention kernel")
    with _build.count_lock:
        KERNEL_LAUNCHES += 1
    return out


def _fwd_fake(qkv3, scale, heads):
    """The forwards' output under ``torch.export``: contiguous
    ``[B, N, H, d]`` in the rows' dtype, as the launches allocate it."""
    b, n, f = qkv3.shape
    return qkv3.new_empty((b, n, heads, f // (3 * heads)))


_attention_fwd_op.register_fake(_fwd_fake)


def attention_bhnd_backward_reference(q, k, v, dout, scale: float):
    """The VJP of :func:`attention_reference` for q, k, v and ``dout``
    ``[B, H, N, d]`` → ``(dq, dk, dv)`` in q's dtype, as the TPU backward
    kernels compute it: p in fp32, dv = bf16(p)ᵀ·do, dp = do·vᵀ,
    delta = rowsum(dp∘p), ds = (p∘(dp − delta)·scale) rounded to the input
    dtype, dq = ds·k, dk = dsᵀ·q, fp32 products from the inputs' values."""
    dt = q.dtype
    q, k, v, do = (t.float() for t in (q, k, v, dout))
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    delta = (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def attention_backward_reference(qkv3, dout, scale: float, heads: int):
    """:func:`attention_bhnd_backward_reference` on the packed rows:
    ``qkv3 [B, N, 3·H·d]`` and ``dout [B, H, N, d]`` → ``dqkv3`` like
    qkv3."""
    b, n, f = qkv3.shape
    grads = attention_bhnd_backward_reference(*_split_heads(qkv3, heads),
                                              dout, scale)
    # [3, B, H, N, d] → [B, N, 3, H, d] → rows
    dqkv = torch.stack(grads).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(b, n, f)


def qkv_attention_bwd_kernel(qkv3, dout, scale: float, heads: int):
    """Kernel A′ on CUDA tensors: ``qkv3 [B, N, 3·H·d]`` (contiguous), bf16
    with N up to ``A_MAX_N[bf16]`` or fp32 up to ``A_MAX_N[fp32]``, and
    ``dout [B, H, N, d]`` of its dtype, read through its strides →
    ``dqkv3`` like qkv3. Its two launches (query-major over the whole row
    of keys, key-major with the head's Q and dO resident) share a
    ``[3, B, H, N]`` fp32 scratch of row statistics: bf16 on
    ``csrc/attention_bwd_sm90.cu``'s wgmma launches, fp32 on
    ``csrc/attention.cu``'s CUDA-core ones (fp32 FMAs only). The refusal
    comes before the device check, so a CPU tensor of a shape A′ does not
    take raises the same error."""
    global BWD_KERNEL_LAUNCHES, BWD_F32_KERNEL_LAUNCHES
    n = qkv3.shape[1]
    if n > A_MAX_N.get(qkv3.dtype, 0):
        raise NotImplementedError(
            f"kernel A′ takes bf16 with N <= {A_MAX_N[torch.bfloat16]} and "
            f"fp32 with N <= {A_MAX_N[torch.float32]}, got {qkv3.dtype} "
            f"N={n}: longer bf16 rows take kernel K′ or L′; {_FP32_TODO}")
    b, n, d = _check_rows(qkv3, heads, "kernel A′")
    dout, sb, sh, sn = _dout_strides(dout, qkv3, heads)
    dqkv = torch.empty_like(qkv3)
    stats = torch.empty((3, b, heads, n), dtype=torch.float32,
                        device=qkv3.device)
    lib = _build.library()
    launch = (lib.gavit_attention_bwd if qkv3.dtype == torch.bfloat16
              else lib.gavit_attention_bwd_f32)
    _build.check(launch(
        qkv3.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
        b, n, heads, d, sb, sh, sn, float(scale),
        _build.stream(qkv3.device)), "attention backward kernel")
    with _build.count_lock:
        if qkv3.dtype == torch.bfloat16:
            BWD_KERNEL_LAUNCHES += 1
        else:
            BWD_F32_KERNEL_LAUNCHES += 1
    return dqkv


def _long_shape(qkv3, heads: int, what: str, large: bool = False):
    """K/K′ take bf16 rows up to :data:`K_MAX_N` tokens, L/L′
    (``large``) at any length. Shapes and dtype only."""
    b, n, d = _rows_shape(qkv3, heads, what)
    if qkv3.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bfloat16 rows, not {qkv3.dtype}")
    if n > K_MAX_N and not large:
        raise ValueError(
            f"{what} takes N <= {K_MAX_N}, got {n}: longer rows take the "
            "blockwise kernels L/L′ (attention_route 'L')")
    return b, n, d


def _check_long(qkv3, heads: int, what: str, large: bool = False):
    b, n, d = _long_shape(qkv3, heads, what, large)
    _build.require_cuda(qkv3)
    return b, n, d


def qkv_attention_long_kernel(qkv3, scale: float, heads: int):
    """Kernel K on a CUDA bf16 tensor ``[B, N, 3·H·d]`` → ``[B, H, N, d]``
    (a view of ``[B, N, H, d]`` memory, as kernel A's), through the custom
    op ``gavit_tpu_torch::attention_long_fwd``."""
    _long_shape(qkv3, heads, "kernel K")
    _build.require_device(qkv3)
    return torch.ops.gavit_tpu_torch.attention_long_fwd(
        qkv3, float(scale), heads).transpose(1, 2)


@torch.library.custom_op("gavit_tpu_torch::attention_long_fwd",
                         mutates_args=(), device_types="cuda")
def _attention_long_fwd_op(qkv3: torch.Tensor, scale: float,
                           heads: int) -> torch.Tensor:
    """Kernel K's launch: ``[B, N, 3·H·d]`` → contiguous ``[B, N, H, d]``."""
    global LONG_KERNEL_LAUNCHES
    b, n, d = _check_long(qkv3, heads, "kernel K")
    out = torch.empty((b, n, heads, d), dtype=qkv3.dtype, device=qkv3.device)
    lib = _build.library()
    _build.check(lib.gavit_attention_long_fwd(
        qkv3.data_ptr(), out.data_ptr(), b, n, heads, d, float(scale),
        _build.stream(qkv3.device)), "long attention kernel")
    with _build.count_lock:
        LONG_KERNEL_LAUNCHES += 1
    return out


_attention_long_fwd_op.register_fake(_fwd_fake)


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
    ``[B, N, H, d]`` memory, as kernel A's. Through the custom op
    ``gavit_tpu_torch::attention_large_fwd``."""
    _long_shape(qkv3, heads, "kernel L", large=True)
    _build.require_device(qkv3)
    out, lse = torch.ops.gavit_tpu_torch.attention_large_fwd(
        qkv3, float(scale), heads)
    return out.transpose(1, 2), lse


@torch.library.custom_op("gavit_tpu_torch::attention_large_fwd",
                         mutates_args=(), device_types="cuda")
def _attention_large_fwd_op(qkv3: torch.Tensor, scale: float, heads: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel L's launch → (contiguous ``[B, N, H, d]``, ``[B, H, N]``
    fp32)."""
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
    return out, lse


@_attention_large_fwd_op.register_fake
def _(qkv3, scale, heads):
    b, n, _ = qkv3.shape
    return (_fwd_fake(qkv3, scale, heads),
            qkv3.new_empty((b, heads, n), dtype=torch.float32))


def qkv_attention_large_bwd_kernel(qkv3, o, lse, dout, scale: float,
                                   heads: int):
    """Kernel L′ on CUDA tensors: ``qkv3 [B, N, 3·H·d]`` bf16 (contiguous),
    kernel L's ``o`` and ``lse``, and ``dout [B, H, N, d]``; o and dout are
    read through their strides → ``dqkv3`` like qkv3. Its two launches
    (the backward pair in its lse mode) share a ``[3, B, H, N]`` fp32
    scratch of row statistics: L's lse in base-2 units, the multiplier 1
    and delta = rowsum(do∘o), which the query-major launch writes."""
    global LARGE_BWD_KERNEL_LAUNCHES
    b, n, d = _check_long(qkv3, heads, "kernel L′", large=True)
    dout, sb, sh, sn = _dout_strides(dout, qkv3, heads)
    o, ob, oh, on = _dout_strides(o, qkv3, heads, "o")
    if lse.shape != (b, heads, n) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype} is not kernel "
                         f"L's [{b}, {heads}, {n}] float32")
    _build.require_cuda(qkv3, lse)
    dqkv = torch.empty_like(qkv3)
    stats = torch.empty((3, b, heads, n), dtype=torch.float32,
                        device=qkv3.device)
    lib = _build.library()
    _build.check(lib.gavit_attention_large_bwd(
        qkv3.data_ptr(), o.data_ptr(), lse.data_ptr(), dout.data_ptr(),
        dqkv.data_ptr(), stats.data_ptr(), b, n, heads, d, ob, oh, on,
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


def _qkv_attention(qkv3, scale: float, heads: int, route: str, kernel: bool):
    """``[B, N, 3·H·d]`` rows → o ``[B, H, N, d]`` through ``route``,
    differentiable where the rows need a gradient."""
    if torch.is_grad_enabled() and qkv3.requires_grad:
        return _FusedQkvAttention.apply(qkv3, float(scale), heads, route,
                                        kernel)
    out = _forward(qkv3, scale, heads, route, kernel)
    return out[0] if route == "L" else out


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
    out = _qkv_attention(qkv3, scale, h, route, kernel)
    if merge_heads:
        return out.transpose(1, 2)
    return out


# ---------------------------------------------------------------------------
# separate q, k, v [B, H, N, d]: kernels I/I′ and J/J′
# ---------------------------------------------------------------------------


def _card_kernels(q, k, v, what: str) -> bool:
    """True for CUDA tensors, which take the kernels (bf16 at head_dim 64,
    else NotImplementedError); False for CPU tensors, which take the plain
    versions. q, k and v must agree in shape, dtype and device."""
    if q.dim() != 4 or any(t.shape != q.shape or t.dtype != q.dtype
                           or t.device != q.device for t in (k, v)):
        raise ValueError(f"{what} takes q, k, v of one [B, H, N, d] shape, "
                         f"dtype and device, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.device.type == "cpu":
        return False
    if q.dtype != torch.bfloat16 or q.shape[-1] != 64:
        raise NotImplementedError(
            f"{what} on the card takes bfloat16 at head_dim 64, got "
            f"{q.dtype} at head_dim {q.shape[-1]}: {_FP32_TODO}")
    return True


def _bhnd_forward(q, k, v, scale: float, what: str):
    """The bf16 attention forward (A and K's kernel) on CUDA q, k, v
    ``[B, H, N, 64]`` (read through their strides) → o ``[B, H, N, 64]``."""
    _card_kernels(q, k, v, what)
    if q.device.type != "cuda":
        raise ValueError(f"the Hopper kernels take CUDA tensors, not "
                         f"{q.device}")
    b, h, n, d = q.shape
    q, k, v = (_build.aligned(t, rows=True) for t in (q, k, v))
    o = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    lib = _build.library()
    _build.check(lib.gavit_attention_bhnd_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _build.strides(q, k, v, o), b, n, h, d, float(scale),
        _build.stream(q.device)), what)
    return o


def _bhnd_backward(q, k, v, dout, scale: float, what: str):
    """K′'s two launches on CUDA bf16 ``[B, H, N, 64]`` q, k, v and dout
    (read through their strides) → ``(dq, dk, dv)``; they share a
    ``[3, B, H, N]`` fp32 scratch of row statistics."""
    _card_kernels(q, k, v, what)
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            dout.device != q.device or q.device.type != "cuda":
        raise ValueError(f"{what}: dout {tuple(dout.shape)} {dout.dtype} on "
                         f"{dout.device} does not match CUDA q "
                         f"{tuple(q.shape)} {q.dtype}")
    b, h, n, d = q.shape
    q, k, v, dout = (_build.aligned(t, rows=True) for t in (q, k, v, dout))
    dq, dk, dv = torch.empty((3, b, h, n, d), dtype=q.dtype,
                             device=q.device).unbind(0)
    stats = torch.empty((3, b, h, n), dtype=torch.float32, device=q.device)
    lib = _build.library()
    _build.check(lib.gavit_attention_bhnd_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        _build.strides(q, k, v, dout, dq, dk, dv), b, n, h, d, float(scale),
        _build.stream(q.device)), what)
    return dq, dk, dv


# each entry point's launch counter and error label, forward then backward
_BHND = {"v1": (("V1_KERNEL_LAUNCHES", "kernel I"),
                ("V1_BWD_KERNEL_LAUNCHES", "kernel I′")),
         "v2": (("V2_KERNEL_LAUNCHES", "kernel J"),
                ("V2_BWD_KERNEL_LAUNCHES", "kernel J′"))}


def bhnd_kernel(entry: str, bwd: bool, *args):
    """Kernel I (``entry='v1'``, ``attention_pallas``) or J (``'v2'``,
    ``fused_attention_v2``) on CUDA bf16 ``(q, k, v, scale)`` ``[B, H, N,
    64]`` → o; with ``bwd``, I′ or J′ on ``(q, k, v, dout, scale)`` →
    ``(dq, dk, dv)``. Both entry points launch one kernel pair; each counts
    its own launches."""
    counter, what = _BHND[entry][bwd]
    out = (_bhnd_backward if bwd else _bhnd_forward)(*args, what)
    with _build.count_lock:
        globals()[counter] += 1
    return out


class _BhndAttention(torch.autograd.Function):
    """q, k, v ``[B, H, N, d]`` → o; only the inputs are saved and the
    backward recomputes P, as the JAX package's v1 and v2 VJPs do.
    ``entry``: ``'v1'`` or ``'v2'``, whose kernels run, or None for the
    plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, scale, entry):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, entry)
        if entry is None:
            return attention_reference(q, k, v, scale)
        return bhnd_kernel(entry, False, q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        scale, entry = ctx.args
        if entry is None:
            grads = attention_bhnd_backward_reference(q, k, v, g, scale)
        else:
            grads = bhnd_kernel(entry, True, q, k, v, g, scale)
        return (*grads, None, None)


def attention_pallas(q, k, v, scale: float):
    """Exact MHSA ``[B, H, N, d]`` → ``[B, H, N, d]``, routed as the JAX
    package's ``attention_pallas``: :func:`pallas_route` ``'I'`` launches
    kernels I/I′ on a CUDA tensor; ``'L'`` packs q, k, v into the
    ``[B, N, 3·H·d]`` rows kernel L takes and saves L's o and lse for L′, as
    the JAX package hands that length to ``flash_attention_large``. A CPU
    tensor takes the route's plain versions. On the card fp32 and head_dim
    other than 64 raise."""
    kernel = _card_kernels(q, k, v, "attention_pallas")
    b, h, n, d = q.shape
    if pallas_route(n, d, q.dtype) == "I":
        return _BhndAttention.apply(q, k, v, float(scale),
                                    "v1" if kernel else None)
    qkv3 = torch.stack((q, k, v)).permute(1, 3, 0, 2, 4).reshape(
        b, n, 3 * h * d)
    return _qkv_attention(qkv3, scale, h, "L", kernel)


def fused_attention_v2(q, k, v, scale: float):
    """Exact MHSA ``[B, H, N, d]`` → ``[B, H, N, d]`` through kernels J/J′
    on a CUDA tensor, at every N. The JAX function sizes its head chunks
    for the TPU's VMEM (``_head_chunk``) and has no other route; the
    streaming kernel needs neither. A CPU tensor takes the plain versions;
    on the card fp32 and head_dim other than 64 raise."""
    kernel = _card_kernels(q, k, v, "fused_attention_v2")
    return _BhndAttention.apply(q, k, v, float(scale),
                                "v2" if kernel else None)


def multi_head_attention(q, k, v, scale: float | None = None, *,
                         impl: str = "auto", dropout_rate: float = 0.0,
                         seed: int | None = None, site: int | None = None):
    """Dispatching MHSA over ``[B, H, N, d]``, as the JAX package's
    ``multi_head_attention`` routes (attention.py:1138-1148): attention
    dropout is on with ``dropout_rate`` > 0 and a ``seed``, its keep mask
    the Philox mask of (``seed``, ``site``) over ``[B, H, N, N]``.

    * ``'reference'``, or ``'auto'`` with dropout: :func:`attention_reference`;
    * ``'xla'``: the framework's own attention in tensor ops, the plain
      :func:`attention_reference` (fp32 products in IEEE fp32); the port
      calls no library attention;
    * any other ``impl`` with dropout raises;
    * otherwise :func:`attention_pallas`.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    use_dropout = dropout_rate > 0.0 and seed is not None
    if impl == "reference" or (impl == "auto" and use_dropout):
        if not use_dropout:
            return attention_reference(q, k, v, scale)
        if site is None:
            raise ValueError("attention dropout needs the site of its mask")
        b, h, n, _ = q.shape
        keep = philox.keep_mask((b, h, n, n), seed, site, dropout_rate,
                                device=q.device)
        return attention_reference(q, k, v, scale, dropout_rate, keep)
    if use_dropout:
        raise ValueError(
            f"attention impl {impl!r} does not support attention dropout")
    if impl == "xla":
        return attention_reference(q, k, v, scale)
    return attention_pallas(q, k, v, scale)
