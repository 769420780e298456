"""Graph message-passing block (counterpart of ``gavit_tpu/models/graph.py``).

Pre-LN: the similarity is taken over the LayerNorm'd tokens ``h`` and the
messages are ``A·(h W_v)``, projected, dropped out in training
(graph.py:101) and scaled by a scalar gate (zero at init) into the residual
stream. The CLS token bypasses the branch unless ``include_cls``. Only the
dynamic adjacency (rebuilt from the tokens in every block) is ported; the
static and learned-static modes raise.
"""

from __future__ import annotations

import torch
from torch import nn

from gavit_tpu_torch.config import GraphConfig
from gavit_tpu_torch.models.layers import Dense, Dropout, LayerNorm
from gavit_tpu_torch.ops.graph_ops import fused_graph_aggregate


class GraphBlock(nn.Module):
    def __init__(self, dim: int, cfg: GraphConfig, *, drop: float = 0.0,
                 site: int = 0, dtype=torch.float32, impl: str = "auto",
                 device=None):
        super().__init__()
        if not cfg.dynamic or cfg.adjacency == "learned_static":
            raise NotImplementedError(
                "only the dynamic knn/threshold/dense graph is ported; "
                "`dynamic: false` and `learned_static` wait for ROADMAP "
                "Queue 1 item 2")
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
        msg = fused_graph_aggregate(h, values, g.adjacency, g.k, g.threshold,
                                    g.temperature, impl=self.impl)
        msg = self.proj_drop(self.proj(msg), seed)
        t = t + self.gate.to(t.dtype) * msg
        if g.include_cls:
            return t
        return torch.cat([x[:, :1], t], dim=1)
