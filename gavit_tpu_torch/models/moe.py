"""Mixture-of-Experts MLP (counterpart of ``gavit_tpu/models/moe.py``).

Selected transformer blocks (``ModelConfig.moe_sites``) replace their MLP
with :class:`MoEMlp`: an fp32 router sends each token to its top-k of E
experts, whose stacked weights keep the Flax layout (``fc1_kernel [E, D,
F]``, ``fc1_bias [E, F]``, ``fc2_kernel [E, F, D]``, ``fc2_bias [E, D]``).
Two engines compute it, resolved per call shape by
:func:`resolve_moe_impl`, as the JAX package's are per traced shape:

* **dense** — static capacity ``C = ceil(k·S·cf/E)`` per image and expert,
  one-hot dispatch and combine einsums (the JAX package leaves these GEMMs
  to XLA; here they are ``torch.einsum``); pairs past an expert's capacity
  are dropped in choice-major order and pass through the residual;
* **grouped** — dropless, in one of two forms, as the JAX package's
  ``use_fused`` gate picks (``ops/moe_fused.py::use_fused``, off with
  ``GAVIT_MOE_FUSED=0`` or ``GAVIT_MOE_MATMUL=ragged_dot``): fused, the
  pairs grouped by expert on tile-aligned rows and the expert MLP through
  kernels M, M′ and tgmm on the card (``ops/moe_fused.py``); or unfused,
  the pairs packed by expert and the two expert GEMMs through the ragged
  grouped GEMM N-gmm (tgmm for dW) with the GELU and kernel F's dropout
  between them (``ops/moe_grouped.py::grouped_moe_mlp``). The plain
  versions stand in for the kernels on the CPU. ``grouped_remat``
  recomputes either in the backward.

The engines differ in which tokens they drop at saturated experts, so one
model gives different answers at batches that resolve to different engines,
as the JAX model does; pin ``model.moe.impl`` for uniformity.

Routing runs in fp32 with no TF32 (a bf16 or TF32 router flips expert
choices); ties go to the lower expert index, as ``jax.lax.top_k`` does (a
zero router, as ``upcycle_params`` makes, ties every expert). The
config-weighted ``load_balance`` and ``router_z`` auxiliary losses of a
training forward are kept on the module (:attr:`MoEMlp.aux_loss`);
``VisionTransformer.moe_aux_loss`` sums them.

:func:`upcycle_params` turns a dense model's weights into an MoE model's
(sparse upcycling, moe.py:344-394), on the weight bridge's Flax-layout
trees (``utils/convert.py``).
"""

from __future__ import annotations

import logging
import math
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from gavit_tpu_torch.config import MoEConfig
from gavit_tpu_torch.ops import _build
from gavit_tpu_torch.ops.dropout import fused_dropout
from gavit_tpu_torch.ops.moe_fused import grouped_moe_mlp_fused, use_fused
from gavit_tpu_torch.ops.moe_grouped import grouped_moe_mlp

logger = logging.getLogger(__name__)

# The JAX package's crossovers (routed pairs per device, moe.py:63-64),
# copied as they are: the dropless grouped engine at or above the
# threshold, the dense engine below. FUSED_MIN_PAIRS applies where the fused
# kernels run (a CUDA tensor with impl 'auto' and the fused gate on),
# GROUPED_MIN_PAIRS elsewhere; GAVIT_MOE_AUTO_PAIRS overrides either, as in
# the JAX package. They were measured on a TPU; the H100's crossover is not
# measured yet.
GROUPED_MIN_PAIRS = 37824
FUSED_MIN_PAIRS = 15760

_logged_choices: set = set()
# serialises the router's switch of the process-wide TF32 flag (the HTTP
# server runs the model from several threads)
_tf32_lock = threading.Lock()


def resolve_moe_impl(impl: str, pairs: int, fused_live: bool) -> str:
    """``model.moe.impl`` for one call: 'dense' and 'grouped' are returned
    as they are; 'auto' takes 'grouped' when ``pairs`` (B·S·k) reaches the
    threshold, else 'dense'. The threshold: ``GAVIT_MOE_AUTO_PAIRS`` when
    set, else FUSED_MIN_PAIRS where the fused kernels run (``fused_live``),
    else GROUPED_MIN_PAIRS (moe.py:68-71, 98-109)."""
    if impl != "auto":
        if impl not in ("dense", "grouped"):
            raise ValueError(f"unknown model.moe.impl {impl!r}")
        return impl
    thresh = int(os.environ.get(
        "GAVIT_MOE_AUTO_PAIRS",
        FUSED_MIN_PAIRS if fused_live else GROUPED_MIN_PAIRS))
    choice = "grouped" if pairs >= thresh else "dense"
    if (pairs, choice) not in _logged_choices:
        _logged_choices.add((pairs, choice))
        logger.info("moe.impl=auto -> %s (%d routed pairs, threshold %d)",
                    choice, pairs, thresh)
    return choice


def expert_capacity(tokens: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Static per-expert buffer size: ceil(k·S·cf / E), clamped to [1, S]."""
    cap = int(math.ceil(k * tokens * capacity_factor / num_experts))
    return max(1, min(cap, tokens))


def router_topk(logits, k: int, *, normalize_gates: bool = True):
    """fp32 softmax-top-k routing and the auxiliary losses.

    ``logits [G, S, E]`` → ``(gate_vals [G, S, k] fp32, gate_idx [G, S, k]
    int64, {'load_balance', 'router_z'})``. Ties go to the lower expert
    index (a stable descending sort). ``load_balance`` = E·mean over images
    of Σ_e (share of first choices)·(mean probability); ``router_z`` = mean
    of logsumexp².
    """
    e = logits.shape[-1]
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    gate_idx = order[..., :k]
    gate_vals = torch.gather(probs, -1, gate_idx)
    if normalize_gates:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    top1 = F.one_hot(gate_idx[..., 0], e).float()
    frac = top1.mean(1)
    mean_prob = probs.mean(1)
    load_balance = e * (frac * mean_prob).sum(-1).mean()
    router_z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return gate_vals, gate_idx, {"load_balance": load_balance,
                                 "router_z": router_z}


def router_dispatch(logits, k: int, capacity: int, *,
                    normalize_gates: bool = True):
    """Top-k assignment with static capacity: ``(combine [G, S, E, C] fp32,
    aux)``, combine[g,s,e,c] token s's gate if it holds expert e's slot c,
    else 0. Choice-major priority (every first choice before any second),
    token order within a choice; pairs past capacity are dropped."""
    g, s, e = logits.shape
    gate_vals, gate_idx, aux = router_topk(logits, k,
                                           normalize_gates=normalize_gates)
    masks = F.one_hot(gate_idx, e).float()                      # [g,s,k,e]
    flat = masks.permute(0, 2, 1, 3).reshape(g, k * s, e)
    pos_flat = torch.cumsum(flat, dim=1) - flat
    pos = pos_flat.reshape(g, k, s, e).permute(0, 2, 1, 3)
    keep = masks * (pos < capacity)
    # dropped pairs land on slot 0 here; their zero gate removes them
    slot = (pos * keep).sum(-1).long()                          # [g,s,k]
    slot_oh = F.one_hot(slot, capacity).float()                 # [g,s,k,c]
    gated = keep * gate_vals[..., None]                         # [g,s,k,e]
    combine = torch.einsum("gske,gskc->gsec", gated, slot_oh)
    return combine, aux


def _fp32_logits(x, router):
    """``x.float() @ router`` at full fp32, TF32 off for that product."""
    x = x.float()
    if not x.is_cuda:
        return x @ router
    with _tf32_lock:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return x @ router
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32


class MoEMlp(nn.Module):
    """Drop-in for ``models.layers.Mlp`` on ``[B, N, D]``: each image's N
    tokens form one routing group. ``sites`` = the (hidden, output) dropout
    sites of the block's MLP. ``impl`` as the model's: 'auto' launches the
    kernels on CUDA tensors, 'reference' takes the plain versions. With
    ``cfg.grouped_remat`` a training forward keeps none of the grouped
    engine's insides and recomputes them in the backward; its masks come
    from (seed, site), so the recompute draws the same ones."""

    def __init__(self, cfg: MoEConfig, dim: int, hidden_dim: int, *,
                 drop: float = 0.0, site: int = 0, dtype=torch.float32,
                 impl: str = "auto", device=None):
        super().__init__()
        if cfg.k > cfg.num_experts:
            raise ValueError(f"model.moe.k={cfg.k} cannot exceed "
                             f"num_experts={cfg.num_experts}")
        _build.check_impl(impl)
        self.cfg = cfg
        self.dtype = dtype
        self.impl = impl
        self.drop = drop
        self.sites = (site, site + 1)
        e = cfg.num_experts
        self.router = nn.Parameter(torch.empty(dim, e, device=device))
        self.fc1_kernel = nn.Parameter(
            torch.empty(e, dim, hidden_dim, device=device))
        self.fc1_bias = nn.Parameter(torch.zeros(e, hidden_dim, device=device))
        self.fc2_kernel = nn.Parameter(
            torch.empty(e, hidden_dim, dim, device=device))
        self.fc2_bias = nn.Parameter(torch.zeros(e, dim, device=device))
        # the config-weighted aux loss of the last training forward
        self.aux_loss = None

    def forward(self, x, seed=None):
        cfg, dt = self.cfg, self.dtype
        g, s, _ = x.shape
        k = cfg.k
        rate = self.drop if self.training else 0.0
        if rate > 0.0 and seed is None:
            raise ValueError("MoE dropout with a rate > 0 needs a seed")
        logits = _fp32_logits(x, self.router)
        # exact erf wherever gradients flow; tanh on the deterministic bf16
        # path, as the dense Mlp
        approx = dt == torch.bfloat16 and not self.training
        w1, b1 = self.fc1_kernel.to(dt), self.fc1_bias.to(dt)
        w2, b2 = self.fc2_kernel.to(dt), self.fc2_bias.to(dt)
        fused = use_fused()
        if self.engine(g, s, x.is_cuda) == "grouped":
            gate_vals, gate_idx, aux = router_topk(
                logits, k, normalize_gates=cfg.normalize_gates)
            engine = grouped_moe_mlp_fused if fused else grouped_moe_mlp
            args = (x.to(dt), gate_vals, gate_idx, w1, b1, w2, b2, seed,
                    self.sites)
            kw = dict(drop=rate, approx_gelu=approx, impl=self.impl)
            if cfg.grouped_remat and self.training and \
                    torch.is_grad_enabled():
                # (moe.py:291-297) the whole engine again in the backward,
                # no early stop: every kernel of it launches once more
                with set_checkpoint_early_stop(False):
                    out = checkpoint(engine, *args, **kw, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                out = engine(*args, **kw)
        else:
            cap = expert_capacity(s, cfg.num_experts, k, cfg.capacity_factor)
            combine, aux = router_dispatch(
                logits, k, cap, normalize_gates=cfg.normalize_gates)
            out = self._dense(x.to(dt), combine, w1, b1, w2, b2, seed, rate,
                              approx)
        self.aux_loss = (cfg.aux_weight * aux["load_balance"]
                         + cfg.router_z_weight * aux["router_z"]
                         if self.training else None)
        return out

    def engine(self, groups: int, tokens: int, cuda: bool) -> str:
        """The engine a forward on ``groups`` images of ``tokens`` tokens
        takes ('grouped' or 'dense'), from shapes alone: the crossover
        counts the fused kernels' threshold where they run."""
        fused_live = use_fused() and cuda and self.impl == "auto"
        return resolve_moe_impl(self.cfg.impl, groups * tokens * self.cfg.k,
                                fused_live)

    def reads_host(self, groups: int, tokens: int, cuda: bool) -> bool:
        """Whether such a forward reads the host: the grouped engine's
        plain versions (a CPU tensor, or ``impl='reference'``) read their
        group sizes there (``ops/gmm.py::_bounds``,
        ``ops/moe_fused.py::_expert_rows``); the kernels M and N-gmm read
        them on the device."""
        plain = not cuda or self.impl != "auto"
        return plain and self.engine(groups, tokens, cuda) == "grouped"

    def _dense(self, x, combine, w1, b1, w2, b2, seed, rate, approx):
        """The static-capacity engine (moe.py:310-335): dispatch by the
        binary one-hot, the expert GEMMs in the compute dtype, the slot
        gates applied in fp32, the combine by the same binary one-hot."""
        dt = x.dtype
        dispatch = (combine > 0).to(dt)                         # [g,s,e,c]
        xd = torch.einsum("gsec,gsd->gecd", dispatch, x)
        h = torch.einsum("gecd,edf->gecf", xd, w1) + b1[None, :, None, :]
        h = F.gelu(h, approximate="tanh" if approx else "none")
        h = fused_dropout(h, seed, self.sites[0], rate, impl=self.impl)
        y = torch.einsum("gecf,efd->gecd", h, w2) + b2[None, :, None, :]
        y = fused_dropout(y, seed, self.sites[1], rate, impl=self.impl)
        slot_gate = combine.sum(1)                              # [g,e,c]
        y = (y.float() * slot_gate[..., None]).to(dt)
        return torch.einsum("gsec,gecd->gsd", dispatch, y)


def upcycle_params(dense_params: dict, moe_params: dict, model_cfg) -> dict:
    """Sparse upcycling (moe.py:344-394): an MoE model's weights from a
    dense model's. Both trees are the weight bridge's nested dicts in the
    Flax layout (``utils/convert.py::to_flax_tree``; ``load_flax_params``
    fills a model from the result). At every MoE site each expert becomes a
    copy of the dense block's ``fc1``/``fc2`` and the router zero (uniform
    routing: every expert tied, experts 0 and 1 chosen); every other leaf
    is copied from the dense tree where the shapes match, else kept from
    ``moe_params``. With normalised gates the upcycled grouped forward is
    the dense forward (dropless: no token dropped at any capacity)."""
    e = model_cfg.moe.num_experts

    def copy_matching(dst: dict, src: dict) -> dict:
        out = {}
        for key, val in dst.items():
            if key in src and isinstance(val, dict):
                out[key] = copy_matching(val, src[key])
            elif key in src and np.shape(val) == np.shape(src[key]):
                out[key] = src[key]
            else:
                out[key] = val
        return out

    out = copy_matching(moe_params, dense_params)
    for i in sorted(set(model_cfg.moe_sites())):
        blk = dict(out[f"blocks_{i}"])
        mlp = dense_params[f"blocks_{i}"]["mlp"]

        def tile(a):
            a = np.asarray(a)
            return np.tile(a[None], (e,) + (1,) * a.ndim)

        blk["moe"] = {
            "router": np.zeros_like(np.asarray(blk["moe"]["router"])),
            "fc1_kernel": tile(mlp["fc1"]["kernel"]),
            "fc1_bias": tile(mlp["fc1"]["bias"]),
            "fc2_kernel": tile(mlp["fc2"]["kernel"]),
            "fc2_bias": tile(mlp["fc2"]["bias"]),
        }
        out[f"blocks_{i}"] = blk
    return out
