"""Token merging in the port against gavit_tpu's ``models/tome.py`` on the
CPU (tiny model: 32 px, patch 8, embed 32, 2 blocks, 2 heads, a kNN graph
block with k 4 and its gate at 0.5 after the first; one torch thread).

* ``bipartite_merge`` against the JAX one on fp32 tokens with sizes from
  an earlier merge: the same tokens merged into the same places (the
  output's sizes equal) and the merged values within 1e-6.
* ``tome_forward`` at r = 0 bit-equal to the model's own forward; at r = 2
  within 1e-4 of the JAX ``tome_forward`` (fp32 on both sides).
* The refusals: a static or learned-static graph, and MoE blocks.
* int8 + ToMe: the ``Predictor`` refuses to merge before it holds static
  scales; after ``warmup`` (noise calibration) its probabilities are within
  2e-2 (bf16) of the JAX ``tome_forward`` run on the same quant state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gavit_tpu.config import from_dict as jax_from_dict
from gavit_tpu.models.tome import bipartite_merge as jax_merge
from gavit_tpu.models.tome import tome_forward as jax_tome_forward
from gavit_tpu.ops.preprocess import val_preprocess as jax_val_preprocess
from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.tome import bipartite_merge, tome_forward
from gavit_tpu_torch.serving import Predictor
from gavit_tpu_torch.utils.convert import (quant_state, quant_to_flax,
                                           to_flax_tree)
from tests.test_torch_quant import TINY as TINY1
from tests.test_torch_quant import images, tiny_model

# two blocks: tokens merge after each, and the graph block between them
# sees merged tokens
TINY = {"model": {**TINY1["model"], "depth": 2}, "data": TINY1["data"]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("graph,moe", [
    ({"dynamic": False}, False), ({"adjacency": "learned_static"}, False),
    ({}, True)], ids=["static", "learned_static", "moe"])
def test_tome_refusals(graph, moe):
    raw = {"model": {**TINY["model"],
                     "graph": {**TINY["model"]["graph"], **graph},
                     "moe": {"enabled": moe, "num_experts": 2}},
           "data": TINY["data"]}
    model = tiny_model("fp32", raw=raw)
    x = torch.from_numpy(images(1))
    with pytest.raises(ValueError, match="token merging"):
        tome_forward(model, x, 2)
    with pytest.raises(ValueError, match="token merging"):
        Predictor(from_dict(raw), device="cpu", tome_r=2)
    if not graph.get("dynamic", True):  # the JAX package refuses it too
        with pytest.raises(ValueError, match="token merging"):
            jax_tome_forward(jax_from_dict(raw).model, to_flax_tree(model),
                             jnp.asarray(x.numpy()), 2)
