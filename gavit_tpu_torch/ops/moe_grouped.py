"""The dropless grouped MoE engine on expert-contiguous rows (counterpart of
``gavit_tpu/ops/moe_grouped.py``), and the token → expert-sorted-rows
gather both grouped engines use.

:func:`dispatch_rows` is ``x_flat[src_tok]``: row r of the sorted buffer is
token ``src_tok[r]`` (pad rows read token 0). Autograd's transpose of that
gather would be a scatter-add into the tokens; the grouping also carries
the inverse map ``dest`` (the buffer row of each (token, choice) pair), so
the backward is a gather by ``dest`` and a k-way sum instead, as the JAX
package's custom VJP is. Pad rows receive no gradient: no pair points at
them. :func:`combine_rows` is the way back, ``y[dest]``, its backward a
gather by ``src``.

:func:`grouped_moe_mlp` is the unfused engine (moe_grouped.py:354-417),
which runs where the fused kernels are switched off
(``ops/moe_fused.py::use_fused``): the pairs grouped by expert with no
padding (:func:`group_by_expert`), the two expert GEMMs as ragged grouped
GEMMs (``ops/gmm.py``: kernel N-gmm on the card), the biases as a
``[T, E] × [E, F]`` GEMM of the rows' expert one-hot (:func:`range_onehot`,
whose transpose is the bias gradient), the exact GELU (tanh on the
deterministic bf16 path), and dropout at the MLP's two sites through
``ops/dropout.py::fused_dropout`` (kernel F), whose masks are a function of
(step seed, site), so a recompute draws them again. The JAX engine draws
its masks with ``jax.random.bernoulli``: the two agree at rate 0 only.

The port runs one device, so of ``sharded_grouped_moe`` it takes the
single-device branch (moe_grouped.py:440-442): a direct call of a grouped
engine, which ``models/moe.py`` makes. Expert parallelism
(``grouped_moe_mlp_ep``) waits for ROADMAP Queue 1 items 11 and 13.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from gavit_tpu_torch.ops.dropout import fused_dropout
from gavit_tpu_torch.ops.gmm import ragged_matmul


class _DispatchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_flat, src_tok, dest, k):
        ctx.save_for_backward(dest)
        ctx.k = k
        return x_flat[src_tok]

    @staticmethod
    def backward(ctx, g):
        (dest,) = ctx.saved_tensors
        n_tok = dest.shape[0] // ctx.k
        dx = g[dest].reshape(n_tok, ctx.k, -1).sum(dim=1)
        return dx, None, None, None


def dispatch_rows(x_flat, src_tok, dest, k: int):
    """``x_flat [tokens, D]`` → ``[cap, D]`` rows ``x_flat[src_tok]``;
    ``dest [tokens·k]`` is the inverse map (every pair is kept: the engine
    is dropless)."""
    return _DispatchRows.apply(x_flat, src_tok, dest, k)


class _CombineRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, dest, src):
        ctx.save_for_backward(src)
        return y[dest]

    @staticmethod
    def backward(ctx, g):
        (src,) = ctx.saved_tensors
        return g[src], None, None


def combine_rows(y, dest, src):
    """``y[dest]`` for a permutation ``dest`` of the buffer rows; the
    backward gathers by the inverse ``src`` instead of scattering
    (moe_grouped.py:189, ``masked=False``)."""
    return _CombineRows.apply(y, dest, src)


def group_by_expert(gate_idx, num_experts: int):
    """Expert-contiguous rows for every (token, choice) pair, no padding
    (moe_grouped.py:230): ``gate_idx [..., k]`` → ``(dest, src, sizes)``,
    ``dest`` (gate_idx's shape) the row of each pair, ``src [T]`` the pair
    of each row, ``sizes [E]`` int32 the rows per expert (summing to T).
    Pairs keep their (token, choice) order within an expert; no host
    sync."""
    flat = gate_idx.reshape(-1).long()
    t, dev = flat.numel(), flat.device
    # [E, T]: the scan runs along the innermost dim, as in
    # ops/moe_fused.py::group_by_expert_tiled
    onehot = (torch.arange(num_experts, device=dev)[:, None]
              == flat[None, :]).int()
    csum = torch.cumsum(onehot, 1, dtype=torch.int32)
    pos = csum.gather(0, flat[None, :])[0].long() - 1
    sizes = csum[:, -1].contiguous()  # a column of csum: strided
    offsets = torch.cumsum(sizes, 0) - sizes
    dest = offsets.long()[flat] + pos
    src = torch.zeros(t, dtype=torch.long, device=dev).index_put_(
        (dest,), torch.arange(t, device=dev))
    return dest.reshape(gate_idx.shape), src, sizes.to(torch.int32)


def range_onehot(bounds, sizes, t: int, dtype):
    """``[T, E]`` one-hot of each buffer row's expert from the group ranges
    (moe_grouped.py:215): row r is expert e's iff ``bounds[e] - sizes[e] <=
    r < bounds[e]``. ``onehot @ b`` adds the per-expert biases, and its
    transpose ``onehotᵀ · g`` is the bias gradient."""
    r = torch.arange(t, device=bounds.device)[:, None]
    return ((r >= (bounds - sizes)[None, :])
            & (r < bounds[None, :])).to(dtype)


def resolve_matmul_impl(impl: str = "auto") -> str:
    """The JAX package's grouped-GEMM switch (moe_grouped.py:104-114):
    ``'megablox'`` or ``'ragged_dot'`` (XLA's primitive on the TPU, no
    Pallas kernel); 'auto' → 'megablox'. ``GAVIT_MOE_MATMUL`` overrides, as
    in the JAX package. In the port it only gates the fused engine
    (``ops/moe_fused.py::use_fused``): the unfused engine takes kernel
    N-gmm under either name."""
    impl = os.environ.get("GAVIT_MOE_MATMUL") or impl
    if impl == "auto":
        return "megablox"
    if impl not in ("megablox", "ragged_dot"):
        raise ValueError(f"unknown grouped-MoE matmul impl {impl!r}")
    return impl


def grouped_moe_mlp(x, gate_vals, gate_idx, w1, b1, w2, b2, seed, sites, *,
                    drop: float = 0.0, approx_gelu: bool = False,
                    impl: str = "auto"):
    """The unfused dropless MoE MLP: ``x [G, S, D]`` (compute dtype),
    ``gate_vals [G, S, k]`` fp32, ``gate_idx [G, S, k]``, the expert banks
    ``w1 [E, D, F]``, ``b1 [E, F]``, ``w2 [E, F, D]``, ``b2 [E, D]`` in x's
    dtype → ``[G, S, D]`` in x's dtype, each token's output the fp32
    gate-weighted sum of its k expert rows. ``drop``: the rate of the
    hidden and output masks at ``sites`` (0 when deterministic); ``seed``
    the step seed. ``impl='auto'`` launches the kernels on CUDA tensors,
    'reference' takes the plain versions."""
    if drop > 0.0 and seed is None:
        raise ValueError("MoE dropout with a rate > 0 needs a seed")
    g, s, d = x.shape
    e = w1.shape[0]
    k = gate_idx.shape[-1]
    dest, src, sizes = group_by_expert(gate_idx, e)
    dest = dest.reshape(-1)
    x_sorted = dispatch_rows(x.reshape(g * s, d), src // k, dest, k)
    oh = range_onehot(torch.cumsum(sizes, 0), sizes, x_sorted.shape[0],
                      x.dtype)
    h = ragged_matmul(x_sorted, w1, sizes, impl=impl) + oh @ b1
    h = F.gelu(h, approximate="tanh" if approx_gelu else "none")
    h = fused_dropout(h, seed, sites[0], drop, impl=impl)
    y = ragged_matmul(h, w2, sizes, impl=impl) + oh @ b2
    y = fused_dropout(y, seed, sites[1], drop, impl=impl)
    y_tok = combine_rows(y, dest, src).reshape(g, s, k, d)
    out = (gate_vals[..., None] * y_tok.float()).sum(dim=2)
    return out.to(x.dtype)
