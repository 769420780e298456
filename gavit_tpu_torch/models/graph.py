"""Graph message-passing block (counterpart of ``gavit_tpu/models/graph.py``).

Pre-LN: the similarity is taken over the LayerNorm'd tokens ``h`` and the
messages are ``A·(h W_v)``, projected, dropped out in training
(graph.py:101) and scaled by a scalar gate (zero at init) into the residual
stream. The CLS token bypasses the branch unless ``include_cls``.

Three adjacencies are ported: the dynamic one (knn / threshold / dense,
rebuilt from the tokens in every block, kernel C on the card); the static
one (``dynamic: false``, graph.py:83-93): the first graph block builds the
``[B, n, n]`` fp32 adjacency with :func:`build_adjacency` and aggregates
with :func:`graph_aggregate`, and every later block reuses it, in tensor
ops as the JAX package's XLA path (gradients flow into the first block
through the shared adjacency; selection is not differentiated); and the
learned-static one (graph.py:75-81): a ``[n, n]`` fp32 parameter
``adj_logits`` over the n tokens the block sees, zero at init, turned into
``softmax(adj_logits / temperature)`` in fp32 and applied as
:func:`graph_aggregate` does (adjacency cast to the values' dtype, fp32
accumulation), which the JAX package computes as an einsum outside any
Pallas kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from gavit_tpu_torch.config import GraphConfig
from gavit_tpu_torch.models.layers import Dense, Dropout, LayerNorm
from gavit_tpu_torch.ops.graph_ops import (build_adjacency,
                                           fused_graph_aggregate,
                                           graph_aggregate)


class GraphBlock(nn.Module):
    def __init__(self, dim: int, cfg: GraphConfig, *,
                 num_patches: int | None = None, drop: float = 0.0,
                 site: int = 0, dtype=torch.float32, quant=None,
                 impl: str = "auto", device=None):
        """``num_patches``: the model's patch tokens, which size the
        learned-static ``adj_logits`` (one more with ``include_cls``).
        ``quant``: the ``value`` and ``proj`` GEMMs quantised, as the JAX
        block's (graph.py:70, :98)."""
        super().__init__()
        learned = cfg.adjacency == "learned_static"
        self.adj_logits = None
        if learned:
            if num_patches is None:
                raise ValueError("a learned_static graph needs num_patches")
            n = num_patches + int(cfg.include_cls)
            self.adj_logits = nn.Parameter(torch.zeros(n, n, device=device))
        self.cfg = cfg
        self.impl = impl
        self.norm = LayerNorm(dim, dtype=dtype, device=device)
        self.value = Dense(dim, dim, dtype=dtype, quant=quant, impl=impl,
                           device=device)
        self.proj = Dense(dim, dim, dtype=dtype, quant=quant, impl=impl,
                          device=device)
        self.proj_drop = Dropout(drop, site, impl)
        self.gate = nn.Parameter(torch.zeros((), device=device))

    def forward(self, x, seed=None, adj=None):
        """``x [B, N+1, D]`` with CLS at index 0 → ``(tokens of the same
        shape, adjacency)``. ``adj``: a built adjacency to reuse (the static
        graph's later blocks). The adjacency returned is the one this block
        built for reuse (the static graph's first block), else None."""
        g = self.cfg
        t = x if g.include_cls else x[:, 1:]
        h = self.norm(t)
        values = self.value(h)
        adj_out = adj
        if self.adj_logits is not None:
            adj_l = torch.softmax(self.adj_logits.float() / g.temperature, -1)
            msg = graph_aggregate(adj_l, values)
            adj_out = None
        elif adj is not None:
            msg = graph_aggregate(adj, values)
        elif not g.dynamic:
            adj_out = build_adjacency(h, mode=g.adjacency, k=g.k,
                                      threshold=g.threshold,
                                      temperature=g.temperature)
            msg = graph_aggregate(adj_out, values)
        else:
            msg = fused_graph_aggregate(h, values, g.adjacency, g.k,
                                        g.threshold, g.temperature,
                                        impl=self.impl)
        msg = self.proj_drop(self.proj(msg), seed)
        t = t + self.gate.to(t.dtype) * msg
        if g.include_cls:
            return t, adj_out
        return torch.cat([x[:, :1], t], dim=1), adj_out
