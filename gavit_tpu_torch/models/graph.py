"""Graph message-passing block (counterpart of ``gavit_tpu/models/graph.py``).

Pre-LN: the similarity is taken over the LayerNorm'd tokens ``h`` and the
messages are ``A·(h W_v)``, projected, dropped out in training
(graph.py:101) and scaled by a scalar gate (zero at init) into the residual
stream. The CLS token bypasses the branch unless ``include_cls``.

Two adjacencies are ported: the dynamic one (knn / threshold / dense,
rebuilt from the tokens in every block, kernel C on the card) and the
learned-static one (graph.py:75-81): a ``[n, n]`` fp32 parameter
``adj_logits`` over the n tokens the block sees, zero at init, turned into
``softmax(adj_logits / temperature)`` in fp32 and applied as
:func:`graph_aggregate` does (adjacency cast to the values' dtype, fp32
accumulation), which the JAX package computes as an einsum outside any
Pallas kernel. ``dynamic: false`` with a built adjacency raises.
"""

from __future__ import annotations

import torch
from torch import nn

from gavit_tpu_torch.config import GraphConfig
from gavit_tpu_torch.models.layers import Dense, Dropout, LayerNorm
from gavit_tpu_torch.ops.graph_ops import (fused_graph_aggregate,
                                           graph_aggregate)


class GraphBlock(nn.Module):
    def __init__(self, dim: int, cfg: GraphConfig, *,
                 num_patches: int | None = None, drop: float = 0.0,
                 site: int = 0, dtype=torch.float32, impl: str = "auto",
                 device=None):
        """``num_patches``: the model's patch tokens, which size the
        learned-static ``adj_logits`` (one more with ``include_cls``)."""
        super().__init__()
        learned = cfg.adjacency == "learned_static"
        if not (cfg.dynamic or learned):
            raise NotImplementedError(
                "the static graph (`dynamic: false`, one adjacency shared "
                "by the graph blocks) waits for ROADMAP Queue 1 item 2")
        self.adj_logits = None
        if learned:
            if num_patches is None:
                raise ValueError("a learned_static graph needs num_patches")
            n = num_patches + int(cfg.include_cls)
            self.adj_logits = nn.Parameter(torch.zeros(n, n, device=device))
        self.cfg = cfg
        self.impl = impl
        self.norm = LayerNorm(dim, dtype=dtype, device=device)
        self.value = Dense(dim, dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        self.proj_drop = Dropout(drop, site, impl)
        self.gate = nn.Parameter(torch.zeros((), device=device))

    def forward(self, x, seed=None):
        """``x [B, N+1, D]`` with CLS at index 0 → same shape."""
        g = self.cfg
        t = x if g.include_cls else x[:, 1:]
        h = self.norm(t)
        values = self.value(h)
        if self.adj_logits is not None:
            adj = torch.softmax(self.adj_logits.float() / g.temperature, -1)
            msg = graph_aggregate(adj, values)
        else:
            msg = fused_graph_aggregate(h, values, g.adjacency, g.k,
                                        g.threshold, g.temperature,
                                        impl=self.impl)
        msg = self.proj_drop(self.proj(msg), seed)
        t = t + self.gate.to(t.dtype) * msg
        if g.include_cls:
            return t
        return torch.cat([x[:, :1], t], dim=1)
