"""megablox's grouped GEMMs over expert-contiguous rows: ``gmm``, which
``gavit_tpu/ops/moe_grouped.py::ragged_matmul`` launches for the unfused MoE
engine on the TPU, and ``tgmm``, the grouped weight gradient that both
grouped engines take.

* :func:`gmm_reference`, :func:`tgmm_reference` — the plain PyTorch
  versions: a loop over the experts, each taking its ``group_sizes[e]``
  consecutive rows in fp32 and rounding once; gmm's rows past the last
  group are zero. They read the group sizes on the host (a sync: plain
  versions only).
* :func:`gmm_kernel` — kernel N-gmm on CUDA bf16 tensors (``csrc/moe.cu``,
  the tensor cores) or fp32 ones (``csrc/moe_f32.cu``, the CUDA cores):
  ``[T, K] × [E, K, N] → [T, N]``, or with ``transpose_rhs``
  ``[T, K] × [E, N, K]ᵀ → [T, N]``, the group sizes read on the device.
* :func:`tgmm_kernel` — kernel tgmm (the same two files): ``[R, K]ᵀ ·
  [R, N]`` per group → ``[E, K, N]`` in the operands' dtype.
* :func:`ragged_matmul` — the differentiable op, megablox's custom VJP
  (jax/experimental/pallas/ops/tpu/megablox/ops.py:63-105): forward
  ``gmm(x, w)``; ``dx = gmm(dy, w, transpose_rhs=True)``; ``dW`` through
  tgmm. The kernels clip the last row tile at T, so the rows go in unpadded
  (megablox pads them to its tile, moe_grouped.py:128-139).

On a CUDA tensor with ``impl='auto'`` the op launches N-gmm and tgmm; on a
CPU tensor, or with ``impl='reference'``, it takes the plain versions.
"""

from __future__ import annotations

import torch

from gavit_tpu_torch.ops import _build

# launches since the last reset (chip_smoke.py reads them): kernel N-gmm,
# in either form, and kernel tgmm (one per GEMM's backward in the unfused
# engine, two per backward of the fused one), bf16 and fp32 apart
KERNEL_LAUNCHES = 0
TGMM_LAUNCHES = 0
F32_KERNEL_LAUNCHES = 0
F32_TGMM_LAUNCHES = 0


def _bounds(group_sizes) -> list[int]:
    return [0] + torch.cumsum(group_sizes.long(), 0).tolist()


def gmm_reference(x, w, group_sizes, transpose_rhs: bool = False):
    """``[T, K] × w[e]`` (``w [E, K, N]``; ``[E, N, K]`` transposed with
    ``transpose_rhs``) over each expert's consecutive rows, fp32 sums
    rounded to x's dtype; rows past the groups are zero."""
    bounds = _bounds(group_sizes)
    n = w.shape[1] if transpose_rhs else w.shape[2]
    out = torch.zeros(x.shape[0], n, dtype=x.dtype, device=x.device)
    for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        hi = min(hi, x.shape[0])
        if lo >= hi:
            continue
        we = w[e].float()
        out[lo:hi] = (x[lo:hi].float() @ (we.t() if transpose_rhs else we)
                      ).to(x.dtype)
    return out


def tgmm_reference(a, b, group_sizes, out_dtype):
    """``[E, K, N]``: for each expert e, ``a[rows of e]ᵀ · b[rows of e]``
    in fp32 over its ``group_sizes[e]`` consecutive rows, rounded to
    ``out_dtype``."""
    bounds = _bounds(group_sizes)
    return torch.stack([
        (a[lo:hi].float().t() @ b[lo:hi].float()).to(out_dtype)
        for lo, hi in zip(bounds[:-1], bounds[1:])])


def check_dtype(what, *tensors):
    """bfloat16 or float32, every operand one dtype: what the MoE kernels
    take (the bf16 bodies on the tensor cores, the fp32 ones on the CUDA
    cores)."""
    dt = tensors[0].dtype
    if dt not in (torch.bfloat16, torch.float32) or any(
            t.dtype != dt for t in tensors):
        raise TypeError(f"{what} takes bfloat16 or float32 tensors of one "
                        f"dtype, not {[str(t.dtype) for t in tensors]}")


def gmm_kernel(x, w, group_sizes, transpose_rhs: bool = False):
    """Kernel N-gmm on CUDA bf16 or fp32 ``x [T, K]`` and ``w`` (one dtype)
    with int32 ``group_sizes [E]`` on the device → ``[T, N]`` in their
    dtype, through the custom op ``gavit_tpu_torch::gmm``."""
    _, kd = x.shape
    e = w.shape[0]
    n, wk = (w.shape[1], w.shape[2]) if transpose_rhs else \
        (w.shape[2], w.shape[1])
    if w.ndim != 3 or wk != kd or kd % 8 or n % 8:
        raise ValueError(f"N-gmm shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} (transpose_rhs {transpose_rhs}): "
                         f"inner dims must match, widths divisible by 8")
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (e,):
        raise ValueError(f"N-gmm takes int32 group sizes [{e}], got "
                         f"{group_sizes.dtype} {tuple(group_sizes.shape)}")
    check_dtype("kernel N-gmm", x, w)
    _build.require_device(x, w, group_sizes)
    return torch.ops.gavit_tpu_torch.gmm(x, w, group_sizes,
                                         bool(transpose_rhs))


def _gmm_cols(w, transpose_rhs: bool) -> int:
    return w.shape[1] if transpose_rhs else w.shape[2]


@torch.library.custom_op("gavit_tpu_torch::gmm", mutates_args=(),
                         device_types="cuda")
def _gmm_op(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
            transpose_rhs: bool) -> torch.Tensor:
    """Kernel N-gmm's launch → ``[T, N]`` (no launch at T = 0): the fp32
    body for fp32 operands, else the bf16 one."""
    global KERNEL_LAUNCHES, F32_KERNEL_LAUNCHES
    t, kd = x.shape
    e, n = w.shape[0], _gmm_cols(w, transpose_rhs)
    check_dtype("kernel N-gmm", x, w)
    _build.require_cuda(x, w, group_sizes)
    out = torch.empty((t, n), dtype=x.dtype, device=x.device)
    if not t:
        return out
    lib = _build.library()
    f32 = x.dtype == torch.float32
    launch = lib.gavit_gmm_f32 if f32 else lib.gavit_gmm
    _build.check(launch(
        x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        t, kd, n, e, int(transpose_rhs), _build.stream(x.device)),
        "grouped GEMM kernel")
    with _build.count_lock:
        if f32:
            F32_KERNEL_LAUNCHES += 1
        else:
            KERNEL_LAUNCHES += 1
    return out


@_gmm_op.register_fake
def _(x, w, group_sizes, transpose_rhs):
    check_dtype("kernel N-gmm", x, w)
    return x.new_empty((x.shape[0], _gmm_cols(w, transpose_rhs)))


def tgmm_kernel(a, b, group_sizes, out_dtype=None):
    """Kernel tgmm on CUDA bf16 or fp32 ``a [R, K]``, ``b [R, N]`` (one
    dtype) and int32 ``group_sizes [E]`` (on the device, summing to R) →
    ``[E, K, N]`` in their dtype; ``out_dtype``, where given, must be that
    dtype."""
    global TGMM_LAUNCHES, F32_TGMM_LAUNCHES
    rows, kd = a.shape
    n = b.shape[1]
    e = group_sizes.shape[0]
    if b.shape[0] != rows or kd % 8 or n % 8:
        raise ValueError(f"tgmm shapes a {tuple(a.shape)} b {tuple(b.shape)}: "
                         f"rows must match, widths divisible by 8")
    if group_sizes.dtype != torch.int32 or group_sizes.ndim != 1:
        raise ValueError("tgmm takes int32 group sizes [E]")
    check_dtype("kernel tgmm", a, b)
    if out_dtype is not None and out_dtype != a.dtype:
        raise TypeError(f"kernel tgmm writes its operands' {a.dtype}, not "
                        f"{out_dtype}")
    _build.require_cuda(a, b, group_sizes)
    c = torch.empty((e, kd, n), dtype=a.dtype, device=a.device)
    lib = _build.library()
    f32 = a.dtype == torch.float32
    launch = lib.gavit_moe_tgmm_f32 if f32 else lib.gavit_moe_tgmm
    _build.check(launch(
        a.data_ptr(), b.data_ptr(), group_sizes.data_ptr(), c.data_ptr(),
        rows, kd, n, e, _build.stream(a.device)), "grouped dW kernel")
    with _build.count_lock:
        if f32:
            F32_TGMM_LAUNCHES += 1
        else:
            TGMM_LAUNCHES += 1
    return c


class _Gmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes, use_kernel):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.use_kernel = use_kernel
        gmm = gmm_kernel if use_kernel else gmm_reference
        return gmm(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, gs = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        gmm, tgmm = ((gmm_kernel, tgmm_kernel) if ctx.use_kernel
                     else (gmm_reference, tgmm_reference))
        return gmm(dy, w, gs, True), tgmm(x, dy, gs, w.dtype), None, None


def ragged_matmul(x, w, group_sizes, *, impl: str = "auto"):
    """``[T, K] × [E, K, N]`` with the first ``group_sizes[e]`` remaining
    rows of ``x`` (expert-contiguous) multiplying ``w[e]``, differentiable
    in x and w. ``group_sizes``: int32 ``[E]`` on x's device, summing to T.
    A CUDA tensor with ``impl='auto'`` launches kernels N-gmm and tgmm; a
    CPU tensor, or ``impl='reference'``, takes the plain versions."""
    _build.check_impl(impl)
    use_kernel = impl == "auto" and x.device.type != "cpu"
    if not (torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        # no gradient recorded (serving, torch.export): the forward alone
        return (gmm_kernel if use_kernel else gmm_reference)(x, w, group_sizes)
    return _Gmm.apply(x, w, group_sizes, use_kernel)
