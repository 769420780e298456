"""The dropless grouped MoE MLP on tile-aligned expert rows (counterpart of
``gavit_tpu/ops/moe_fused.py``).

* :func:`group_by_expert_tiled` — the routed (token, choice) pairs grouped
  by expert, each expert's region padded to a multiple of the row tile
  ``tm`` (and to at least one tile), all on the device with no host sync:
  ``cap`` is static (:func:`fused_cap`), the group sizes and the tile →
  expert map stay tensors.
* :func:`moe_fwd_reference`, :func:`moe_bwd_reference` — the plain
  PyTorch versions of the TPU kernels ``_fwd_kernel`` and ``_bwd_kernel``:
  per-expert loops over the tile map, fp32 accumulation, the kernels'
  rounding points (h1 rounded before the GELU, g before fc2, dh1 before
  dx), the masks of ``ops/philox.py`` (the hidden mask is element
  row·F + col of the ``[cap, F]`` buffer at the hidden site, the output
  mask element row·D + col of ``[cap, D]`` at the output site).
* :func:`moe_fwd_kernel`, :func:`moe_bwd_kernel` — kernels M and M′
  (``csrc/moe.cu``) on CUDA bf16 tensors, both over the grouping's
  ``group_sizes`` (:func:`tile_group_sizes` derives them from the tile
  map when not given).
* :func:`fused_grouped_mlp` — the differentiable op: M forward; M′ and two
  calls of kernel tgmm (``ops/gmm.py``: dW1, dW2) backward.
  :func:`combine_rows_padded` gathers the pairs' rows back, its backward a
  masked inverse gather, so pad rows get exactly zero gradient (their rows
  hold token 0, finite, never read).
* :func:`grouped_moe_mlp_fused` — grouping → dispatch → op → combine → the
  fp32 gate-weighted sum over the k choices.
* :func:`use_fused` — the gate between this engine and the unfused one
  (``ops/moe_grouped.py::grouped_moe_mlp``), read from the environment.

Weights keep the Flax layout: ``w1 [E, D, F]``, ``b1 [E, F]``,
``w2 [E, F, D]``, ``b2 [E, D]``.
"""

from __future__ import annotations

import os

import torch

from gavit_tpu_torch.ops import _build, gmm, philox
from gavit_tpu_torch.ops.dropout import gelu_and_grad, site_args
from gavit_tpu_torch.ops.moe_grouped import dispatch_rows, resolve_matmul_impl

# launches since the last reset (chip_smoke.py reads them): kernels M
# (forward) and M′ (backward); tgmm counts in ops/gmm.py
KERNEL_LAUNCHES = 0
BWD_KERNEL_LAUNCHES = 0


def _round_up(n: int, t: int) -> int:
    return -(-n // t) * t


def fused_cap(t: int, e: int, tm: int) -> int:
    """Static row capacity of the tiled buffer: every expert padded to a
    tile boundary (≥ 1 tile each) fits in round_up(T) + E·tm rows."""
    return _round_up(t, tm) + e * tm


def fused_tm(t: int, e: int = 8) -> int:
    """Row tile for ``t`` routed pairs over ``e`` experts: 256 at ViT-B's
    b64 and b128 (T = 25216, 50432), smaller where E·tm pad rows would
    exceed ~T/8, 8 below 2048 pairs (moe_fused.py:572-586)."""
    if t < 2048:
        return 8
    for tm in (256, 128, 64, 32, 16):
        if e * tm * 8 <= t:
            return tm
    return 8


def use_fused() -> bool:
    """The fused engine's gate (moe_fused.py:589-603), with the JAX
    package's switches: off with ``GAVIT_MOE_FUSED=0``, or when
    ``GAVIT_MOE_MATMUL`` takes the grouped GEMM away from megablox
    (``ragged_dot``); the grouped engine is then the unfused one. The JAX
    gate also asks for a TPU, the only place its kernels run; the port's
    plain versions stand in for its kernels on the CPU, so this gate does
    not look at the device (``models/moe.py::resolve_moe_impl``'s crossover
    does)."""
    if os.environ.get("GAVIT_MOE_FUSED", "1") == "0":
        return False
    return resolve_matmul_impl("auto") == "megablox"


def group_by_expert_tiled(gate_idx, num_experts: int, tm: int):
    """Expert-contiguous, per-expert tile-aligned destination rows.

    ``gate_idx [..., k]`` (T pairs) → ``(dest [T], src [cap], used [cap]
    bool, tile_group [cap // tm] int32, group_sizes [E] int32)``: the row of
    each pair, the pair of each row (0 for pad rows), the rows holding a
    pair, each tile's expert (tiles past the last expert's region book to
    it: they hold pad rows only), and the padded rows per expert with the
    tail booked to the last (summing to cap), the tgmm grouping.
    """
    flat = gate_idx.reshape(-1).long()
    t, e, dev = flat.numel(), num_experts, flat.device
    cap = fused_cap(t, e, tm)
    # [E, T]: the scan runs along the innermost dim (along dim 0 of a [T, E]
    # one-hot it is ~400x slower on the card); pos = earlier pairs of the
    # same expert
    onehot = (torch.arange(e, device=dev)[:, None] == flat[None, :]).int()
    csum = torch.cumsum(onehot, 1, dtype=torch.int32)
    pos = csum.gather(0, flat[None, :])[0].long() - 1
    sizes = csum[:, -1].long()
    padded = torch.clamp(-(-sizes // tm) * tm, min=tm)
    bounds = torch.cumsum(padded, 0)
    dest = (bounds - padded)[flat] + pos
    src = torch.zeros(cap, dtype=torch.long, device=dev).index_put_(
        (dest,), torch.arange(t, device=dev))
    used = torch.zeros(cap, dtype=torch.bool, device=dev).index_put_(
        (dest,), torch.ones((), dtype=torch.bool, device=dev))
    starts = torch.arange(cap // tm, device=dev) * tm
    tile_group = torch.clamp((starts[:, None] >= bounds[None, :]).sum(1),
                             max=e - 1)
    group_sizes = padded.clone()
    group_sizes[-1] += cap - bounds[-1]
    return (dest, src, used, tile_group.to(torch.int32),
            group_sizes.to(torch.int32))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def gelu_tanh_and_grad(x):
    """tanh-GELU and its derivative from one tanh (the TPU kernel's
    ``_gelu_tanh_and_grad_f32``)."""
    c, a = 0.7978845608028654, 0.044715
    th = torch.tanh(c * (x + a * x * x * x))
    return (0.5 * x * (1.0 + th),
            0.5 * (1.0 + th) + 0.5 * x * (1.0 - th * th) * c
            * (1.0 + 3.0 * a * x * x))


def _act_and_grad(h, approx: bool):
    return gelu_tanh_and_grad(h) if approx else gelu_and_grad(h)


def _expert_rows(tile_group, tm: int, num_experts: int):
    """The buffer rows of each expert (a host sync: plain versions only)."""
    row_e = tile_group.long().repeat_interleave(tm)
    return [torch.nonzero(row_e == ex).squeeze(1)
            for ex in range(num_experts)]


def _masked(v, seed, site, rate):
    if rate == 0.0:
        return v
    keep = philox.keep_mask(v.shape, seed, site, rate, device=v.device)
    return torch.where(keep, v * (1.0 / (1.0 - rate)), 0.0)


def moe_fwd_reference(x_sorted, w1, b1, w2, b2, tile_group, tm: int, seed,
                      sites, rate: float, out_rate: float, approx: bool):
    """``(y [cap, D], h1 [cap, F])`` in x_sorted's dtype: per tile's expert
    e, h1 = x·W1[e]+b1[e] rounded; g = GELU(h1) (tanh when ``approx``, else
    the A&S erf form) with the hidden mask, rounded; y = g·W2[e]+b2[e] with
    the output mask, rounded."""
    dt = x_sorted.dtype
    cap, d = x_sorted.shape
    f = w1.shape[2]
    rows = _expert_rows(tile_group, tm, w1.shape[0])
    h1 = torch.empty(cap, f, dtype=dt, device=x_sorted.device)
    for ex, r in enumerate(rows):
        h1[r] = (x_sorted[r].float() @ w1[ex].float()
                 + b1[ex].float()).to(dt)
    g, _ = _act_and_grad(h1.float(), approx)
    g = _masked(g, seed, sites[0], rate).to(dt)
    y = torch.empty(cap, d, dtype=torch.float32, device=x_sorted.device)
    for ex, r in enumerate(rows):
        y[r] = g[r].float() @ w2[ex].float() + b2[ex].float()
    return _masked(y, seed, sites[1], out_rate).to(dt), h1


def moe_bwd_reference(dy, h1, w1, w2, tile_group, tm: int, seed, sites,
                      rate: float, out_rate: float, approx: bool):
    """The VJP pieces of :func:`moe_fwd_reference`: ``(dx, go, dh1, db1,
    db2, dye)`` — dye the output-masked dy (dy's dtype), dh1 = (dye·W2[e]ᵀ)
    ·GELU'·mask and go = GELU·mask (dy's dtype), dx = dh1·W1[e]ᵀ from the
    rounded dh1, db1 ``[E, F]`` and db2 ``[E, D]`` the fp32 per-expert sums
    of dh1 (before rounding) and dye."""
    dt = dy.dtype
    e = w1.shape[0]
    rows = _expert_rows(tile_group, tm, e)
    dye = _masked(dy.float(), seed, sites[1], out_rate).to(dt) \
        if out_rate > 0.0 else dy
    g, dg = _act_and_grad(h1.float(), approx)
    if rate > 0.0:
        keep = philox.keep_mask(g.shape, seed, sites[0], rate,
                                device=g.device)
        scale = 1.0 / (1.0 - rate)
        g = torch.where(keep, g * scale, 0.0)
        dg = torch.where(keep, dg * scale, 0.0)
    dh = torch.empty_like(g)
    for ex, r in enumerate(rows):
        dh[r] = dye[r].float() @ w2[ex].float().t()
    dh1 = dh * dg
    dh1_r = dh1.to(dt)
    dx = torch.empty(dy.shape, dtype=torch.float32, device=dy.device)
    for ex, r in enumerate(rows):
        dx[r] = dh1_r[r].float() @ w1[ex].float().t()
    db1 = torch.stack([dh1[r].sum(0) for r in rows])
    db2 = torch.stack([dye[r].float().sum(0) for r in rows])
    return dx.to(dt), g.to(dt), dh1_r, db1, db2, dye


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_bf16(what, *tensors):
    for t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} takes bfloat16 tensors, not {t.dtype}")


def _check_map(tile_group, cap: int, tm: int, e: int):
    if tile_group.dtype != torch.int32 or tile_group.shape != (cap // tm,):
        raise ValueError(f"tile_group must be int32 [{cap // tm}], got "
                         f"{tile_group.dtype} {tuple(tile_group.shape)}")
    if tm < 8 or tm & (tm - 1) or cap % tm:
        raise ValueError(f"row tile {tm} must be a power of 2 ≥ 8 dividing "
                         f"cap {cap}")


def _sites(seed, sites, rate, out_rate):
    return (*site_args(seed, sites[0], rate),
            *site_args(seed, sites[1], out_rate)[2:])


def tile_group_sizes(tile_group, num_experts: int, tm: int):
    """The padded rows of each expert, ``[E]`` int32, from the tile → expert
    map (each tile counts ``tm`` rows to its expert): the ``group_sizes``
    of :func:`group_by_expert_tiled`, on the device."""
    experts = torch.arange(num_experts, device=tile_group.device)
    return ((tile_group[None, :] == experts[:, None]).sum(1) * tm).to(
        torch.int32)


def _group_sizes(tile_group, group_sizes, cap: int, tm: int, e: int):
    """The tile map checked, and the grouping's ``group_sizes`` (int32
    ``[E]``, derived from the map when None) as kernels M and M′ take
    them."""
    _check_map(tile_group, cap, tm, e)
    if group_sizes is None:
        group_sizes = tile_group_sizes(tile_group, e, tm)
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (e,):
        raise ValueError(f"group_sizes must be int32 [{e}], got "
                         f"{group_sizes.dtype} {tuple(group_sizes.shape)}")
    return group_sizes


def moe_fwd_kernel(x_sorted, w1, b1, w2, b2, tile_group, tm: int, seed,
                   sites, rate: float, out_rate: float, approx: bool,
                   group_sizes=None):
    """Kernel M on CUDA bf16 tensors → ``(y, h1)``, through the custom op
    ``gavit_tpu_torch::moe_fwd``. ``group_sizes``: the grouping's padded
    rows per expert, as :func:`group_by_expert_tiled` returns them (derived
    from ``tile_group`` when not given)."""
    cap, d = x_sorted.shape
    e, _, f = w1.shape
    if (w1.shape != (e, d, f) or b1.shape != (e, f)
            or w2.shape != (e, f, d) or b2.shape != (e, d)):
        raise ValueError(f"expert shapes x {tuple(x_sorted.shape)} w1 "
                         f"{tuple(w1.shape)} b1 {tuple(b1.shape)} w2 "
                         f"{tuple(w2.shape)} b2 {tuple(b2.shape)}")
    if d % 8 or f % 8:
        raise ValueError(f"kernel M takes widths divisible by 8, got {d}, {f}")
    _check_bf16("kernel M", x_sorted, w1, b1, w2, b2)
    group_sizes = _group_sizes(tile_group, group_sizes, cap, tm, e)
    _build.require_device(x_sorted, w1, b1, w2, b2, tile_group, group_sizes)
    y, h1 = torch.ops.gavit_tpu_torch.moe_fwd(
        x_sorted, w1, b1, w2, b2, group_sizes, int(tm), _int64(seed or 0),
        [int(s) for s in sites], float(rate), float(out_rate), bool(approx))
    return y, h1


def _int64(seed: int) -> int:
    """A 64-bit step seed as the signed int64 an op's schema carries; the
    launch masks it back to 64 bits (``philox.split_seed``)."""
    seed &= (1 << 64) - 1
    return seed - (1 << 64) if seed >> 63 else seed


@torch.library.custom_op("gavit_tpu_torch::moe_fwd", mutates_args=(),
                         device_types="cuda")
def _moe_fwd_op(x_sorted: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor, group_sizes: torch.Tensor,
                tm: int, seed: int, sites: list[int], rate: float,
                out_rate: float, approx: bool
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel M's launch → ``(y [cap, D], h1 [cap, F])``."""
    global KERNEL_LAUNCHES
    cap, d = x_sorted.shape
    e, _, f = w1.shape
    _build.require_cuda(x_sorted, w1, b1, w2, b2, group_sizes)
    h1 = torch.empty((cap, f), dtype=x_sorted.dtype, device=x_sorted.device)
    g = torch.empty_like(h1)
    y = torch.empty_like(x_sorted)
    lib = _build.library()
    _build.check(lib.gavit_moe_fwd(
        x_sorted.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), group_sizes.data_ptr(), h1.data_ptr(), g.data_ptr(),
        y.data_ptr(), cap, d, f, e, tm, int(approx),
        *_sites(seed, sites, rate, out_rate),
        _build.stream(x_sorted.device)), "MoE expert MLP kernel")
    with _build.count_lock:
        KERNEL_LAUNCHES += 1
    return y, h1


@_moe_fwd_op.register_fake
def _(x_sorted, w1, b1, w2, b2, group_sizes, tm, seed, sites, rate,
      out_rate, approx):
    cap, _ = x_sorted.shape
    return (x_sorted.new_empty(x_sorted.shape),
            x_sorted.new_empty((cap, w1.shape[2])))


def moe_bwd_kernel(dy, h1, w1, w2, tile_group, tm: int, seed, sites,
                   rate: float, out_rate: float, approx: bool,
                   group_sizes=None):
    """Kernel M′ on CUDA bf16 tensors → ``(dx, go, dh1, db1, db2, dye)``.
    ``group_sizes`` as :func:`moe_fwd_kernel` takes them."""
    global BWD_KERNEL_LAUNCHES
    cap, f = h1.shape
    e, d, _ = w1.shape
    if (dy.shape != (cap, d) or w1.shape != (e, d, f)
            or w2.shape != (e, f, d)):
        raise ValueError(f"expert backward shapes dy {tuple(dy.shape)} h1 "
                         f"{tuple(h1.shape)} w1 {tuple(w1.shape)} w2 "
                         f"{tuple(w2.shape)}")
    if d % 8 or f % 8:
        raise ValueError(f"kernel M′ takes widths divisible by 8, got {d}, "
                         f"{f}")
    _check_bf16("kernel M′", dy, h1, w1, w2)
    group_sizes = _group_sizes(tile_group, group_sizes, cap, tm, e)
    _build.require_cuda(dy, h1, w1, w2, tile_group, group_sizes)
    dev = dy.device
    lib = _build.library()
    dye = torch.empty_like(dy) if out_rate > 0.0 else dy
    dh1 = torch.empty_like(h1)
    go = torch.empty_like(h1)
    dx = torch.empty_like(dy)
    db1 = torch.empty((e, f), dtype=torch.float32, device=dev)
    db2 = torch.empty((e, d), dtype=torch.float32, device=dev)
    part1 = torch.empty((lib.gavit_moe_bwd_partial_rows(cap, tm, 0), f),
                        dtype=torch.float32, device=dev)
    part2 = torch.empty((lib.gavit_moe_bwd_partial_rows(cap, tm, 1), d),
                        dtype=torch.float32, device=dev)
    _build.check(lib.gavit_moe_bwd(
        dy.data_ptr(), h1.data_ptr(), w1.data_ptr(), w2.data_ptr(),
        group_sizes.data_ptr(), dye.data_ptr(), dh1.data_ptr(), go.data_ptr(),
        dx.data_ptr(), db1.data_ptr(), db2.data_ptr(), part1.data_ptr(),
        part2.data_ptr(), cap, d, f, e, tm, int(approx),
        *_sites(seed, sites, rate, out_rate), _build.stream(dev)),
        "MoE expert MLP backward kernel")
    with _build.count_lock:
        BWD_KERNEL_LAUNCHES += 1
    return dx, go, dh1, db1, db2, dye


# ---------------------------------------------------------------------------
# differentiable op
# ---------------------------------------------------------------------------


class _FusedGroupedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_sorted, w1, b1, w2, b2, tile_group, group_sizes, seed,
                sites, rate, out_rate, approx, tm, use_kernel):
        if use_kernel:
            y, h1 = moe_fwd_kernel(x_sorted, w1, b1, w2, b2, tile_group, tm,
                                   seed, sites, rate, out_rate, approx,
                                   group_sizes)
        else:
            y, h1 = moe_fwd_reference(x_sorted, w1, b1, w2, b2, tile_group,
                                      tm, seed, sites, rate, out_rate, approx)
        ctx.save_for_backward(x_sorted, h1, w1, w2, tile_group, group_sizes)
        ctx.args = (seed, sites, rate, out_rate, approx, tm, use_kernel)
        ctx.bias_dtypes = (b1.dtype, b2.dtype)
        return y

    @staticmethod
    def backward(ctx, gy):
        x_sorted, h1, w1, w2, tile_group, group_sizes = ctx.saved_tensors
        seed, sites, rate, out_rate, approx, tm, use_kernel = ctx.args
        dy = gy.to(x_sorted.dtype).contiguous()
        args = (dy, h1, w1, w2, tile_group, tm, seed, sites, rate, out_rate,
                approx)
        dx, go, dh1, db1, db2, dye = (
            moe_bwd_kernel(*args, group_sizes) if use_kernel
            else moe_bwd_reference(*args))
        # dW over each expert's padded rows; pad rows carry zero dh1 and dye
        tgmm = gmm.tgmm_kernel if use_kernel else gmm.tgmm_reference
        dw1 = tgmm(x_sorted, dh1, group_sizes, w1.dtype)
        dw2 = tgmm(go, dye, group_sizes, w2.dtype)
        return (dx, dw1, db1.to(ctx.bias_dtypes[0]), dw2,
                db2.to(ctx.bias_dtypes[1]), None, None, None, None, None,
                None, None, None, None)


def fused_grouped_mlp(x_sorted, w1, b1, w2, b2, tile_group, group_sizes,
                      seed, sites, rate: float, out_rate: float, approx: bool,
                      tm: int, impl: str = "auto"):
    """out_drop(drop(GELU(x_sorted·W1[e] + b1[e]))·W2[e] + b2[e]) over
    tile-aligned expert rows, differentiable. ``sites``: (hidden, output)
    dropout sites; ``seed`` the step seed (None at rate 0). On a CUDA tensor
    with ``impl='auto'`` the forward launches kernel M and the backward M′
    and tgmm twice; a CPU tensor, or ``impl='reference'``, takes the plain
    versions."""
    _build.check_impl(impl)
    if (rate > 0.0 or out_rate > 0.0) and seed is None:
        raise ValueError("MoE dropout with a rate > 0 needs a seed")
    use_kernel = impl == "auto" and x_sorted.device.type != "cpu"
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (x_sorted, w1, b1, w2, b2))):
        # no gradient recorded (serving, torch.export): the forward alone
        args = (x_sorted, w1, b1, w2, b2, tile_group, int(tm), seed or 0,
                tuple(sites), float(rate), float(out_rate), bool(approx))
        if use_kernel:
            return moe_fwd_kernel(*args, group_sizes)[0]
        return moe_fwd_reference(*args)[0]
    return _FusedGroupedMlp.apply(
        x_sorted, w1, b1, w2, b2, tile_group, group_sizes, seed or 0,
        tuple(sites), float(rate), float(out_rate), bool(approx), int(tm),
        use_kernel)


class _CombineRowsPadded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dest, src, used):
        ctx.save_for_backward(src, used)
        return y[dest]

    @staticmethod
    def backward(ctx, g):
        src, used = ctx.saved_tensors
        return (torch.where(used[:, None], g[src], 0.0).to(g.dtype),
                None, None, None)


def combine_rows_padded(y, dest, src, used):
    """``y[dest]``, ``dest`` injective into the larger buffer; the backward
    gathers by the inverse map ``src`` and zeroes the pad rows."""
    return _CombineRowsPadded.apply(y, dest, src, used)


def grouped_moe_mlp_fused(x, gate_vals, gate_idx, w1, b1, w2, b2, seed,
                          sites, *, drop: float = 0.0,
                          approx_gelu: bool = False, impl: str = "auto"):
    """The dropless grouped MoE MLP: ``x [G, S, D]`` (compute dtype),
    ``gate_vals [G, S, k]`` fp32, ``gate_idx [G, S, k]``, the expert banks
    in x's dtype → ``[G, S, D]`` in x's dtype, each token's output the fp32
    gate-weighted sum of its k expert rows. ``drop`` is the rate of both
    masks (0 when deterministic)."""
    g, s, d = x.shape
    e = w1.shape[0]
    k = gate_idx.shape[-1]
    tm = fused_tm(g * s * k, e)
    dest, src, used, tile_group, group_sizes = group_by_expert_tiled(
        gate_idx, e, tm)
    x_sorted = dispatch_rows(x.reshape(g * s, d), src // k, dest, k)
    y = fused_grouped_mlp(x_sorted, w1, b1, w2, b2, tile_group, group_sizes,
                          seed, sites, drop, drop, approx_gelu, tm, impl)
    y_tok = combine_rows_padded(y, dest, src, used).reshape(g, s, k, d)
    out = (gate_vals[..., None] * y_tok.float()).sum(dim=2)
    return out.to(x.dtype)
