"""Graph branch ops (counterpart of ``gavit_tpu/ops/graph_ops.py``).

* :func:`cosine_similarity`, :func:`build_adjacency`, :func:`graph_aggregate`
  — the plain PyTorch version: the ``[B, N, N]`` adjacency is materialised.
* :func:`fused_graph_aggregate` — similarity → kNN / threshold / dense mask →
  row softmax → ``A·V`` in one pass. On a CUDA tensor it launches kernel C
  (``csrc/graph.cu``), which replaces the TPU kernel ``_graph_kernel``.

* :func:`graph_backward` — ``_fga_bwd``'s closed-form VJP over the saved
  fp32 adjacency (softmax and cosine-similarity chain rules), in plain
  tensor ops with fp32 products: the JAX package computes it with einsums,
  not a Pallas kernel. Selection is not differentiated, as there.

kNN selection keeps the JAX package's tie rule on both paths: among equal
similarities the lower index is taken first (``jax.lax.top_k`` is stable;
here a stable descending sort, and k leftmost-max passes in the kernel).
Under autograd the forward keeps the adjacency (kernel C with
``return_adjacency``) and the backward is :func:`graph_backward`.
"""

from __future__ import annotations

import torch

from gavit_tpu_torch.ops import _build

_NEG_INF = -1e30
_EPS = 1e-6
MODES = {"dense": 0, "knn": 1, "threshold": 2}

# launches of kernel C since the last reset (chip_smoke.py reads it)
KERNEL_LAUNCHES = 0


def cosine_similarity(tokens):
    """``[B, N, D]`` → ``[B, N, N]`` fp32: rows normalised in fp32, rounded
    back to the tokens' dtype, multiplied with fp32 accumulation."""
    t32 = tokens.float()
    t32 = t32 * torch.rsqrt((t32 * t32).sum(-1, keepdim=True) + _EPS)
    t = t32.to(tokens.dtype).float()
    return torch.matmul(t, t.transpose(-1, -2))


def build_adjacency(tokens, *, mode: str = "knn", k: int = 8,
                    threshold: float = 0.0, temperature: float = 1.0):
    """Row-stochastic fp32 adjacency ``[B, N, N]`` from ``[B, N, D]``."""
    n = tokens.shape[-2]
    sim = cosine_similarity(tokens)
    eye = torch.eye(n, dtype=torch.bool, device=tokens.device)
    no_self = ~eye
    if mode == "dense":
        mask = no_self.expand(sim.shape)
    elif mode == "knn":
        kk = min(k, n - 1)
        masked = sim.masked_fill(eye, _NEG_INF)
        # stable descending sort: equal similarities keep index order, so the
        # lower index is selected first (jax.lax.top_k's rule)
        idx = torch.sort(masked, dim=-1, descending=True, stable=True)[1]
        mask = torch.zeros_like(sim, dtype=torch.bool)
        mask.scatter_(-1, idx[..., :kk], True)
    elif mode == "threshold":
        mask = (sim > threshold) & no_self
        row_any = mask.any(-1, keepdim=True)
        mask = torch.where(row_any, mask, eye)
    else:
        raise ValueError(f"unknown adjacency mode: {mode!r}")
    logits = torch.where(mask, sim / temperature, _NEG_INF)
    return torch.softmax(logits, dim=-1)


def graph_aggregate(adj, values):
    """``[B, N, N] @ [B, N, D]`` → ``[B, N, D]`` in the values' dtype, with
    the adjacency rounded to that dtype and fp32 accumulation."""
    out = torch.matmul(adj.to(values.dtype).float(), values.float())
    return out.to(values.dtype)


def graph_aggregate_kernel(tokens, values, mode: str, k: int,
                           threshold: float, temperature: float,
                           return_adjacency: bool = False):
    """Kernel C on CUDA tensors. With ``return_adjacency`` it also writes
    the fp32 adjacency and returns ``(out, adj)``."""
    global KERNEL_LAUNCHES
    if mode not in MODES:
        raise ValueError(f"unknown adjacency mode: {mode!r}")
    if tokens.shape != values.shape or tokens.dtype != values.dtype:
        raise ValueError(f"tokens {tuple(tokens.shape)} {tokens.dtype} and "
                         f"values {tuple(values.shape)} {values.dtype} differ")
    b, n, d = tokens.shape
    if mode == "knn" and k < 1:
        raise ValueError(f"knn needs k >= 1, got {k}")
    _build.require_cuda(tokens, values)
    code = _build.dtype_code(tokens.dtype)
    lib = _build.library()
    if n < 2 or not lib.gavit_graph_fits(n):
        raise ValueError(f"N={n} is outside kernel C's range (2 up to its "
                         "shared-memory bound; the row-chunked path waits)")
    out = torch.empty_like(values)
    adj = (torch.empty((b, n, n), dtype=torch.float32, device=tokens.device)
           if return_adjacency else None)
    # the bf16 body keeps the normalised tokens here between its two launches
    scratch = torch.empty_like(tokens) if tokens.dtype == torch.bfloat16 \
        else None
    _build.check(lib.gavit_graph_fwd(
        tokens.data_ptr(), values.data_ptr(), out.data_ptr(),
        adj.data_ptr() if adj is not None else None,
        scratch.data_ptr() if scratch is not None else None, b, n, d, MODES[mode],
        int(k), float(threshold), float(temperature), code,
        _build.stream(tokens.device)), "graph kernel")
    with _build.count_lock:
        KERNEL_LAUNCHES += 1
    return (out, adj) if return_adjacency else out


def graph_backward(tokens, values, adj, g, temperature: float = 1.0):
    """``_fga_bwd`` (gavit_tpu/ops/graph_ops.py:445): the VJP of
    ``graph_aggregate(adj, values)`` with ``adj`` the row softmax of the
    masked cosine similarity of ``tokens``, over the saved fp32 ``adj``.
    Returns ``(d tokens, d values)`` in their dtypes."""
    g32 = g.float()
    # out = A @ v:  dv = Aᵀ g,  dA = g vᵀ
    dv = torch.matmul(adj.transpose(-1, -2), g32)
    da = torch.matmul(g32, values.float().transpose(-1, -2))
    # row softmax: masked entries have A == 0, so their logits get 0
    dlogits = adj * (da - (da * adj).sum(-1, keepdim=True))
    dsim = dlogits / temperature
    # sim = n nᵀ with n = t · rsqrt(Σt² + eps)
    t32 = tokens.float()
    r = torch.rsqrt((t32 * t32).sum(-1, keepdim=True) + _EPS)
    nvec = t32 * r
    dn = torch.matmul(dsim, nvec) + torch.matmul(dsim.transpose(-1, -2), nvec)
    dt = r * dn - t32 * (r ** 3) * (dn * t32).sum(-1, keepdim=True)
    return dt.to(tokens.dtype), dv.to(values.dtype)


class _FusedGraphAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, values, mode, k, threshold, temperature,
                use_kernel):
        if use_kernel:
            out, adj = graph_aggregate_kernel(tokens, values, mode, k,
                                              threshold, temperature,
                                              return_adjacency=True)
        else:
            adj = build_adjacency(tokens, mode=mode, k=k, threshold=threshold,
                                  temperature=temperature)
            out = graph_aggregate(adj, values)
        ctx.save_for_backward(tokens, values, adj)
        ctx.temperature = temperature
        return out

    @staticmethod
    def backward(ctx, g):
        tokens, values, adj = ctx.saved_tensors
        dt, dv = graph_backward(tokens, values, adj, g, ctx.temperature)
        return dt, dv, None, None, None, None, None


def fused_graph_aggregate(tokens, values, mode: str = "knn", k: int = 8,
                          threshold: float = 0.0, temperature: float = 1.0,
                          impl: str = "auto"):
    """``graph_aggregate(build_adjacency(tokens), values)`` without the
    adjacency leaving the chip (it is written once, for the backward, when
    a gradient is needed). ``impl='auto'`` launches kernel C for a CUDA
    tensor and takes the plain version for a CPU tensor; ``'reference'``
    always takes the plain version."""
    _build.check_impl(impl)
    use_kernel = impl == "auto" and tokens.device.type != "cpu"
    if torch.is_grad_enabled() and (tokens.requires_grad
                                    or values.requires_grad):
        return _FusedGraphAggregate.apply(tokens, values, mode, k, threshold,
                                          temperature, use_kernel)
    if not use_kernel:
        adj = build_adjacency(tokens, mode=mode, k=k, threshold=threshold,
                              temperature=temperature)
        return graph_aggregate(adj, values)
    return graph_aggregate_kernel(tokens, values, mode, k, threshold,
                                  temperature)
