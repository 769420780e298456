"""The MLP fc1 → GELU → fc2 (counterpart of ``gavit_tpu/ops/mlp.py``).

Serving:

* :func:`_chain_infer` — the plain PyTorch version of
  ``GELU(x·W1+b1)·W2+b2`` with the TPU kernel's rounding: ``h1`` is rounded
  to the compute dtype before the GELU, the GELU output again before fc2.
* :func:`fused_mlp_inference` — the serving entry point. On a CUDA bf16
  tensor it launches kernel B (``csrc/mlp.cu``), which replaces the TPU
  kernel ``_mlp_infer_kernel``.

Training:

* :func:`mlp_train_reference` / :func:`mlp_train_bwd_reference` — the plain
  versions of the TPU kernels ``_mlp_fwd_kernel`` / ``_mlp_bwd_kernel``:
  erf-GELU (the A&S form of ``_gelu_and_grad_f32``), the hidden and output
  dropout masks of ``ops/philox.py``, ``h1`` kept as the residual.
* :func:`mlp_train_chain` — the unfused chain the JAX package's ``Mlp``
  takes when :func:`has_row_block` finds no row block: fc1, GELU + dropout
  (kernels H/H′), fc2, dropout (kernel F).
* :func:`fused_mlp` — the training op, differentiable; :func:`mlp_route`
  picks the megakernel (kernel D forward, D′ backward, ``csrc/mlp.cu``; dx,
  dW1 and dW2 are ``torch.matmul`` over their outputs, as the JAX package
  leaves them to XLA) or the chain.

Self-check:

* :func:`kernel_mask` — the keep masks kernels D and D′ draw for a step
  seed, as 0/1 fp32, for holding them to a plain MLP armed with the same
  masks on the card. On the card it launches kernel E (``csrc/dropout.cu``,
  replaces the TPU's ``kernel_mask``) once a site; its plain version is
  ``philox.keep_mask``.

Weights use ``nn.Linear``'s layout: ``w1 [F, D]``, ``w2 [D, F]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gavit_tpu_torch.ops import _build, philox
from gavit_tpu_torch.ops.dropout import (fused_dropout, fused_gelu_dropout,
                                         gelu_and_grad, site_args)

# launches since the last reset (chip_smoke.py reads them): kernel B, the
# training kernels D (forward) and D′ (backward), and the mask writer E
KERNEL_LAUNCHES = 0
TRAIN_FWD_LAUNCHES = 0
TRAIN_BWD_LAUNCHES = 0
MASK_LAUNCHES = 0


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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _drop_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate)


def _mask(shape, seed, site, rate, device):
    return philox.keep_mask(shape, seed, site, rate, device=device)


def mlp_train_reference(x2, w1, b1, w2, b2, seed, sites, rate: float,
                        out_rate: float):
    """``[M, D]`` → ``(y [M, D], h1 [M, F])`` in x2's dtype: h1 = x·W1ᵀ+b1
    rounded (the residual), then :func:`mlp_train_fc2_reference`."""
    h1 = (torch.matmul(x2.float(), w1.float().t()) + b1.float()).to(x2.dtype)
    return mlp_train_fc2_reference(h1, w2, b2, seed, sites, rate,
                                   out_rate), h1


def mlp_train_fc2_reference(h1, w2, b2, seed, sites, rate: float,
                            out_rate: float):
    """The forward after fc1: g = GELU(h1) in fp32, the hidden mask of site
    ``sites[0]``, g rounded, y = g·W2ᵀ+b2 in fp32, the output mask of
    ``sites[1]``, y rounded to h1's dtype."""
    dt, dev = h1.dtype, h1.device
    g, _ = gelu_and_grad(h1.float())
    if rate > 0.0:
        g = torch.where(_mask(g.shape, seed, sites[0], rate, dev),
                        g * _drop_scale(rate), 0.0)
    y = torch.matmul(g.to(dt).float(), w2.float().t()) + b2.float()
    if out_rate > 0.0:
        y = torch.where(_mask(y.shape, seed, sites[1], out_rate, dev),
                        y * _drop_scale(out_rate), 0.0)
    return y.to(dt)


def mlp_train_bwd_reference(dy2, h1, w2, seed, sites, rate: float,
                            out_rate: float):
    """The VJP pieces of :func:`mlp_train_reference`: ``(dh1, go, db1, db2,
    dye)`` — dye the output-masked dy (x's dtype), dh1 = (dye·W2)·GELU'·mask
    and go = GELU·mask (the dropped activations, for dW2), db1 and db2 the
    fp32 column sums of dh1 (before rounding) and dye."""
    dt, dev = dy2.dtype, dy2.device
    if out_rate > 0.0:
        dye = torch.where(_mask(dy2.shape, seed, sites[1], out_rate, dev),
                          dy2.float() * _drop_scale(out_rate), 0.0).to(dt)
    else:
        dye = dy2
    g, dg = gelu_and_grad(h1.float())
    if rate > 0.0:
        keep = _mask(g.shape, seed, sites[0], rate, dev)
        g = torch.where(keep, g * _drop_scale(rate), 0.0)
        dg = torch.where(keep, dg * _drop_scale(rate), 0.0)
    dh1 = torch.matmul(dye.float(), w2.float()) * dg
    return (dh1.to(dt), g.to(dt), dh1.sum(0), dye.float().sum(0), dye)


def _site_args(seed, sites, rate, out_rate):
    """(k0, k1, site_h, thr_h, scale_h, site_o, thr_o, scale_o) for the
    launchers; a site is off when its threshold is 0 and its scale 1."""
    hidden = site_args(seed, sites[0], rate)
    return (*hidden, *site_args(seed, sites[1], out_rate)[2:])


def _check_train(x2, w1, w2, what):
    m, d = x2.shape
    f = w1.shape[0]
    if w1.shape != (f, d) or w2.shape != (d, f):
        raise ValueError(f"MLP shapes x {tuple(x2.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)}")
    if d % 8 or f % 8:
        raise ValueError(f"{what} takes widths divisible by 8, got {d}, {f}")
    return m, d, f


def mlp_train_kernel(x2, w1, b1, w2, b2, seed, sites, rate: float,
                     out_rate: float):
    """Kernel D on CUDA bf16 tensors → ``(y, h1)``."""
    global TRAIN_FWD_LAUNCHES
    m, d, f = _check_train(x2, w1, w2, "kernel D")
    for t in (x2, w1, b1, w2, b2):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"kernel D takes bfloat16 tensors, not {t.dtype}")
    _build.require_cuda(x2, w1, b1, w2, b2)
    h1 = torch.empty((m, f), dtype=x2.dtype, device=x2.device)
    g = torch.empty_like(h1)
    y = torch.empty((m, d), dtype=x2.dtype, device=x2.device)
    lib = _build.library()
    _build.check(lib.gavit_mlp_train_fwd(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), h1.data_ptr(), g.data_ptr(), y.data_ptr(), m, d, f,
        *_site_args(seed, sites, rate, out_rate), _build.stream(x2.device)),
        "MLP training forward kernel")
    with _build.count_lock:
        TRAIN_FWD_LAUNCHES += 1
    return y, h1


def mlp_train_bwd_kernel(dy2, h1, w2, seed, sites, rate: float,
                         out_rate: float):
    """Kernel D′ on CUDA bf16 tensors → ``(dh1, go, db1, db2, dye)``."""
    global TRAIN_BWD_LAUNCHES
    m, f = h1.shape
    d = dy2.shape[1]
    if dy2.shape != (m, d) or w2.shape != (d, f):
        raise ValueError(f"MLP backward shapes dy {tuple(dy2.shape)} h1 "
                         f"{tuple(h1.shape)} w2 {tuple(w2.shape)}")
    if d % 8 or f % 8:
        raise ValueError(f"kernel D′ takes widths divisible by 8, got {d}, "
                         f"{f}")
    for t in (dy2, h1, w2):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"kernel D′ takes bfloat16 tensors, not {t.dtype}")
    _build.require_cuda(dy2, h1, w2)
    dev = dy2.device
    lib = _build.library()
    dye = torch.empty_like(dy2) if out_rate > 0.0 else dy2
    dh1 = torch.empty_like(h1)
    go = torch.empty_like(h1)
    db1 = torch.empty(f, dtype=torch.float32, device=dev)
    db2 = torch.empty(d, dtype=torch.float32, device=dev)
    part1 = torch.empty((lib.gavit_mlp_bwd_partial_rows(m, 0), f),
                        dtype=torch.float32, device=dev)
    part2 = torch.empty((lib.gavit_mlp_bwd_partial_rows(m, 1), d),
                        dtype=torch.float32, device=dev)
    _build.check(lib.gavit_mlp_train_bwd(
        dy2.data_ptr(), h1.data_ptr(), w2.data_ptr(), dye.data_ptr(),
        dh1.data_ptr(), go.data_ptr(), db1.data_ptr(), db2.data_ptr(),
        part1.data_ptr(), part2.data_ptr(), m, d, f,
        *_site_args(seed, sites, rate, out_rate), _build.stream(dev)),
        "MLP training backward kernel")
    with _build.count_lock:
        TRAIN_BWD_LAUNCHES += 1
    return dh1, go, db1, db2, dye


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, seed, sites, rate, out_rate,
                use_kernel):
        fwd = mlp_train_kernel if use_kernel else mlp_train_reference
        y, h1 = fwd(x2, w1, b1, w2, b2, seed, sites, rate, out_rate)
        ctx.save_for_backward(x2, h1, w1, w2)
        ctx.args = (seed, sites, rate, out_rate, use_kernel)
        ctx.bias_dtypes = (b1.dtype, b2.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        x2, h1, w1, w2 = ctx.saved_tensors
        seed, sites, rate, out_rate, use_kernel = ctx.args
        dy2 = gy.to(x2.dtype).contiguous()
        bwd = mlp_train_bwd_kernel if use_kernel else mlp_train_bwd_reference
        dh1, go, db1, db2, dye = bwd(dy2, h1, w2, seed, sites, rate, out_rate)
        dx = torch.matmul(dh1, w1)       # dh1 · W1, [M, D]
        dw1 = torch.matmul(dh1.t(), x2)  # [F, D]
        dw2 = torch.matmul(dye.t(), go)  # [D, F]
        return (dx, dw1, db1.to(ctx.bias_dtypes[0]), dw2,
                db2.to(ctx.bias_dtypes[1]), None, None, None, None, None)


# The JAX package's row-block rule (pick_block, gavit_tpu/ops/mlp.py:93-121,
# at its default budgets and without its GAVIT_MLP_BM override): the
# megakernel needs a row block that divides M and whose working set fits
# the VMEM budget, 0.8 x 48 MiB for bf16 and 0.8 x 16 MiB otherwise.
_ROW_BLOCKS = (64, 128, 256, 512, 32)
_MIB = 1024 * 1024


def has_row_block(m: int, d: int, f: int, itemsize: int) -> bool:
    """True where ``pick_block(m, d, f, itemsize)`` finds a row block."""
    budget = int(0.8 * (48 if itemsize == 2 else 16) * _MIB)
    fixed = 2 * d * f * itemsize + (f + d) * 4
    per_row = 2 * (2 * d * itemsize + f * itemsize) + 3 * f * 4
    return any(m % bm == 0 and fixed + bm * per_row <= budget
               for bm in _ROW_BLOCKS)


def mlp_route(m: int, d: int, f: int, dtype: torch.dtype) -> str:
    """``'fused'`` (kernels D/D′) for bf16 rows whose count M has a row
    block, as the JAX package's ``Mlp`` takes its megakernel; ``'chain'``
    (fc1, H, fc2, F) for every other shape, fp32 included (D/D′ are bf16
    only; at ViT widths the JAX package's fp32 weights exceed its budget
    too). 384 px at b16 (M = 9232 = 2⁴·577) and 224 px at b16 (M = 3152)
    take the chain, 224 px at b32 and b128 (M = 6304, 25216) the
    megakernel."""
    return "fused" if dtype == torch.bfloat16 and has_row_block(
        m, d, f, 2) else "chain"


def mlp_train_chain(x, w1, b1, w2, b2, seed, sites, rate: float,
                    out_rate: float, impl: str = "auto"):
    """fc1 → GELU + dropout at ``sites[0]`` (kernels H/H′) → fc2 → dropout
    at ``sites[1]`` (kernel F), differentiable by autograd; fc1 and fc2 are
    ``F.linear`` in x's dtype (cuBLAS on the card, as the JAX package's
    ``QDense`` is XLA's)."""
    h = fused_gelu_dropout(F.linear(x, w1, b1), seed, sites[0], rate, impl)
    return fused_dropout(F.linear(h, w2, b2), seed, sites[1], out_rate, impl)


def fused_mlp(x, w1, b1, w2, b2, seed, sites, rate: float,
              out_rate: float = 0.0, impl: str = "auto"):
    """out_dropout(dropout(GELU(x·W1ᵀ + b1))·W2ᵀ + b2) over the last dim of
    ``x``, differentiable; erf GELU (training). ``sites`` = (hidden site,
    output site) of the masks, ``seed`` the step seed (None when both rates
    are 0).

    :func:`mlp_route` picks the megakernel or the chain by dtype and row
    count, on every device; the device picks kernels (CUDA) or plain
    versions (CPU, and ``impl='reference'``). Both routes draw the same
    masks from the same (seed, site) pairs and compute the same function:
    in fp32 they agree to summation order. In bf16 they round at other
    places, as the JAX package's two routes do: the chain rounds fc1's
    output and the hidden gradient to bf16 where D/D′ keep fp32, and F
    scales by bf16(1/(1-rate)) where D scales in fp32.
    """
    _build.check_impl(impl)
    if (rate > 0.0 or out_rate > 0.0) and seed is None:
        raise ValueError("MLP dropout with a rate > 0 needs a seed")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if mlp_route(x2.shape[0], shape[-1], w1.shape[0], x.dtype) == "chain":
        y = mlp_train_chain(x2, w1, b1, w2, b2, seed, sites, rate, out_rate,
                            impl)
    else:
        use_kernel = impl == "auto" and x.device.type != "cpu"
        y = _FusedMlp.apply(x2, w1, b1, w2, b2, seed, tuple(sites),
                            float(rate), float(out_rate), use_kernel)
    return y.reshape(shape)


# ---------------------------------------------------------------------------
# the training kernels' masks, for self-checks
# ---------------------------------------------------------------------------


def keep_mask_kernel(seed, masks, device):
    """Kernel E: for each of ``masks``, one or two ``(shape, site, rate)``,
    the keep mask of (``seed``, ``site``) over a tensor of ``shape`` at
    ``rate``, as 0/1 fp32 on a CUDA ``device``, all written in one launch."""
    global MASK_LAUNCHES
    if not 1 <= len(masks) <= 2:
        raise ValueError(f"kernel E writes one or two masks, not {len(masks)}")
    outs = [torch.empty(shape, dtype=torch.float32, device=device)
            for shape, _, _ in masks]
    if outs[0].device.type != "cuda":
        raise ValueError(f"kernel E writes to a CUDA device, not {device}")
    if not sum(o.numel() for o in outs):
        return outs
    k0, k1, site_a, thr_a, _ = site_args(seed, *masks[0][1:])
    _, _, site_b, thr_b, _ = site_args(seed, *masks[-1][1:])
    ptr_b, n_b = ((outs[1].data_ptr(), outs[1].numel()) if len(outs) == 2
                  else (None, 0))
    lib = _build.library()
    _build.check(lib.gavit_keep_masks(
        outs[0].data_ptr(), outs[0].numel(), ptr_b, n_b, k0, k1, site_a,
        thr_a, site_b, thr_b, _build.stream(outs[0].device)),
        "keep mask kernel")
    with _build.count_lock:
        MASK_LAUNCHES += 1
    return outs


def kernel_mask(seed, sites, m: int, f: int, rate: float, d: int = 0,
                out_rate: float = 0.0, device="cuda"):
    """The keep masks kernels D and D′ apply for the step seed ``seed``:
    ``(hidden [m, f], out [m, d] or None)``, 0/1 fp32, the hidden mask of
    site ``sites[0]`` at ``rate`` and, when ``out_rate`` > 0, the output
    mask of ``sites[1]`` at ``out_rate`` (the counterpart of the JAX
    package's ``kernel_mask``, for on-card self-checks only).

    The TPU version takes the row block ``bm`` of its kernels, because the
    core's generator is seeded per program and consumed chunk by chunk;
    Philox's mask is a pure function of (seed, site, element), whatever
    the launch geometry, so the port has no such argument.

    On a CUDA ``device`` (the default) kernel E writes both masks in one
    launch, as the JAX ``kern`` writes both in one call; on the CPU they are
    ``philox.keep_mask``.
    """
    device = torch.device(device)
    masks = [((m, f), sites[0], rate)]
    if out_rate > 0.0:
        masks.append(((m, d), sites[1], out_rate))
    if device.type == "cpu":
        outs = [_mask(shape, seed, site, r, device).float()
                for shape, site, r in masks]
    else:
        outs = keep_mask_kernel(seed, masks, device)
    return outs[0], (outs[1] if out_rate > 0.0 else None)
