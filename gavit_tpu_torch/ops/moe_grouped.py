"""The token → expert-sorted-rows gather of the grouped MoE engine
(counterpart of ``_dispatch_rows`` in ``gavit_tpu/ops/moe_grouped.py``).

:func:`dispatch_rows` is ``x_flat[src_tok]``: row r of the sorted buffer is
token ``src_tok[r]`` (pad rows read token 0). Autograd's transpose of that
gather would be a scatter-add into the tokens; the grouping also carries
the inverse map ``dest`` (the buffer row of each (token, choice) pair), so
the backward is a gather by ``dest`` and a k-way sum instead, as the JAX
package's custom VJP is. Pad rows receive no gradient: no pair points at
them.

The port runs one device, so of ``sharded_grouped_moe`` it takes the
single-device branch (moe_grouped.py:440-442): a direct call of the grouped
engine, which ``models/moe.py`` makes. The unfused ragged engine
(``grouped_moe_mlp`` on ``ragged_matmul``/megablox ``gmm``) and expert
parallelism wait for ROADMAP Queue 1 items 11 and 13.
"""

from __future__ import annotations

import torch


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
