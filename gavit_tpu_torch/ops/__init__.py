"""Ops: plain PyTorch versions and the Hopper kernel wrappers.

Importing the package registers the custom ops (namespace
``gavit_tpu_torch``) through which the serving path's kernels launch: A
(``attention_fwd``), K (``attention_long_fwd``), L
(``attention_large_fwd``), B (``mlp_infer``), C (``graph_fwd``), M's
forward (``moe_fwd``) and N-gmm (``gmm``). A ``torch.export`` program of
the serving path on the card calls them, so loading one needs this import
and no model code (``serving.py::ExportedPredictor``)."""

from gavit_tpu_torch.ops import (attention, gmm, graph_ops,  # noqa: F401
                                 mlp, moe_fused)
