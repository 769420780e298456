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
* :func:`graph_aggregate_chunked` — the large-N path (512 px: N = 1024
  patch tokens, 1024 px: 4096): the same function over query-row chunks,
  each ``[B, chunk, N]`` slice recomputed in the backward, so neither pass
  holds ``[B, N, N]``. The JAX package writes it in XLA, not Pallas
  (``graph_aggregate_chunked``, graph_ops.py:327); here it is tensor ops.

kNN selection keeps the JAX package's tie rule on every path: among equal
similarities the lower index is taken first (``jax.lax.top_k`` is stable;
here a stable descending sort, and k leftmost-max passes in the kernel and
in the chunked path). :func:`fused_graph_aggregate` picks the path by size
as the JAX package's does (:func:`needs_chunked`).
Under autograd the forward keeps the adjacency (kernel C with
``return_adjacency``) and the backward is :func:`graph_backward`.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from gavit_tpu_torch.ops import _build

_NEG_INF = -1e30
_EPS = 1e-6
MODES = {"dense": 0, "knn": 1, "threshold": 2}

# launches of kernel C since the last reset (chip_smoke.py reads it)
KERNEL_LAUNCHES = 0

# The JAX package's size switch (gavit_tpu/ops/graph_ops.py:276-281): its
# single-pass kernel holds ~5 [N, N] fp32 buffers and the tokens in a 12 MiB
# VMEM budget; past it the row-chunked path takes over. Kept here as the
# port's own switch, so both packages take the same path at every shape
# (bf16 at ViT-B width: kernel C up to N = 686, chunks from 687). Kernel C
# itself ends at N = 768, so below width ~100 (the switch past 768) the
# N in between raises on the card instead of running.
_KERNEL_VMEM_BUDGET = 12 * 1024 * 1024
# [chunk, N] elements of one chunk's slice at most (graph_ops.py:306-313)
_CHUNK_ELEMS = 600_000


def _kernel_vmem_need(n: int, d: int, itemsize: int) -> int:
    return 5 * n * n * 4 + 3 * n * d * itemsize


def needs_chunked(n: int, d: int, itemsize: int) -> bool:
    """Whether ``N`` tokens of width ``d`` take the row-chunked path."""
    return _kernel_vmem_need(n, d, itemsize) > _KERNEL_VMEM_BUDGET


def _pick_chunk(n: int) -> int:
    """Query rows a chunk takes (graph_ops.py:316-324): the smallest padded
    total, the largest chunk on ties, at most ``_CHUNK_ELEMS`` elements a
    slice (N = 1024 → 512, N = 4096 → 128)."""
    if n <= 64:
        return n
    cands = [c for c in (512, 384, 256, 128)
             if c < n and c * n <= _CHUNK_ELEMS]
    if not cands:
        return max(8, _CHUNK_ELEMS // n // 8 * 8)
    return min(cands, key=lambda c: (-(-n // c) * c, -c))


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
    """Kernel C on CUDA tensors, through the custom op
    ``gavit_tpu_torch::graph_fwd``. With ``return_adjacency`` it also writes
    the fp32 adjacency and returns ``(out, adj)``."""
    if mode not in MODES:
        raise ValueError(f"unknown adjacency mode: {mode!r}")
    if tokens.shape != values.shape or tokens.dtype != values.dtype:
        raise ValueError(f"tokens {tuple(tokens.shape)} {tokens.dtype} and "
                         f"values {tuple(values.shape)} {values.dtype} differ")
    if mode == "knn" and k < 1:
        raise ValueError(f"knn needs k >= 1, got {k}")
    _build.require_device(tokens, values)
    out, adj = torch.ops.gavit_tpu_torch.graph_fwd(
        tokens, values, mode, int(k), float(threshold), float(temperature),
        bool(return_adjacency))
    return (out, adj) if return_adjacency else out


@torch.library.custom_op("gavit_tpu_torch::graph_fwd", mutates_args=(),
                         device_types="cuda")
def _graph_fwd_op(tokens: torch.Tensor, values: torch.Tensor, mode: str,
                  k: int, threshold: float, temperature: float,
                  return_adjacency: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel C's launch → ``(out, adj)``; ``adj`` is the fp32 ``[B, N, N]``
    adjacency with ``return_adjacency``, else an empty fp32 tensor."""
    global KERNEL_LAUNCHES
    b, n, d = tokens.shape
    _build.require_cuda(tokens, values)
    code = _build.dtype_code(tokens.dtype)
    lib = _build.library()
    if n < 2 or not lib.gavit_graph_fits(n):
        raise ValueError(f"N={n} is outside kernel C's range (2 up to its "
                         "shared-memory bound; the row-chunked path waits)")
    out = torch.empty_like(values)
    adj = torch.empty((b, n, n) if return_adjacency else (0,),
                      dtype=torch.float32, device=tokens.device)
    # the bf16 body keeps the normalised tokens here between its two launches
    scratch = torch.empty_like(tokens) if tokens.dtype == torch.bfloat16 \
        else None
    _build.check(lib.gavit_graph_fwd(
        tokens.data_ptr(), values.data_ptr(), out.data_ptr(),
        adj.data_ptr() if return_adjacency else None,
        scratch.data_ptr() if scratch is not None else None, b, n, d,
        MODES[mode], int(k), float(threshold), float(temperature), code,
        _build.stream(tokens.device)), "graph kernel")
    with _build.count_lock:
        KERNEL_LAUNCHES += 1
    return out, adj


@_graph_fwd_op.register_fake
def _(tokens, values, mode, k, threshold, temperature, return_adjacency):
    b, n, _ = tokens.shape
    return (torch.empty_like(values, memory_format=torch.contiguous_format),
            tokens.new_empty((b, n, n) if return_adjacency else (0,),
                             dtype=torch.float32))


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


def _chunk_body(tq, tnorm, values, r0: int, mode: str, k: int,
                threshold: float, temperature: float):
    """Rows ``r0 ..`` of ``graph_aggregate(build_adjacency(...), values)``
    from the normalised tokens: ``tq [B, c, D]`` (those rows), ``tnorm
    [B, N, D]``, fp32 similarity of the rounded values."""
    n = tnorm.shape[1]
    sim = torch.matmul(tq.float(), tnorm.float().transpose(-1, -2))
    rows = torch.arange(r0, r0 + tq.shape[1], device=tq.device)
    cols = torch.arange(n, device=tq.device)
    eye = rows[:, None] == cols[None, :]                     # [c, N]
    if mode == "dense":
        mask = (~eye).expand(sim.shape)
    elif mode == "knn":
        # k leftmost-max extraction passes, the kernel's loop: among equal
        # similarities the lower column is taken first (jax.lax.top_k's
        # rule; torch.topk promises no order among ties on CUDA)
        colf = cols.to(torch.float32)
        work = sim.detach().masked_fill(eye, _NEG_INF)
        mask = torch.zeros(sim.shape, dtype=torch.bool, device=sim.device)
        for _ in range(min(k, n - 1)):
            top = work.amax(-1, keepdim=True)
            first = torch.where(work >= top, colf, float(n)).amin(
                -1, keepdim=True)
            hit = colf == first
            mask |= hit
            work = work.masked_fill(hit, _NEG_INF)
        mask &= ~eye
    elif mode == "threshold":
        mask = (sim > threshold) & ~eye
        mask = torch.where(mask.any(-1, keepdim=True), mask, eye)
    else:
        raise ValueError(f"unknown adjacency mode: {mode!r}")
    adj = torch.softmax(torch.where(mask, sim / temperature, _NEG_INF), -1)
    return graph_aggregate(adj, values)


def graph_aggregate_chunked(tokens, values, mode: str = "knn", k: int = 8,
                            threshold: float = 0.0, temperature: float = 1.0,
                            chunk: int = 0):
    """``graph_aggregate(build_adjacency(tokens), values)`` without a
    ``[B, N, N]`` tensor: the tokens normalised in fp32 and rounded back to
    their dtype (graph_ops.py:344-347), then one ``[B, chunk, N]`` slice of
    query rows at a time: similarity, selection, masked softmax with
    temperature, ``A·V``. Under autograd each chunk is recomputed in the
    backward (``torch.utils.checkpoint``, as ``jax.checkpoint`` there), so
    autograd memory stays O(N·chunk); gradients flow through the softmax
    weights only. ``chunk``: rows a slice takes (0: :func:`_pick_chunk`)."""
    n = tokens.shape[1]
    cn = min(chunk or _pick_chunk(n), n)
    t32 = tokens.float()
    t32 = t32 * torch.rsqrt((t32 * t32).sum(-1, keepdim=True) + _EPS)
    tnorm = t32.to(tokens.dtype)
    remat = torch.is_grad_enabled() and (tokens.requires_grad
                                         or values.requires_grad)
    outs = []
    for r0 in range(0, n, cn):
        args = (tnorm[:, r0:r0 + cn], tnorm, values, r0, mode, k, threshold,
                temperature)
        # the body draws no random numbers: no RNG state to keep
        outs.append(checkpoint(_chunk_body, *args, use_reentrant=False,
                               preserve_rng_state=False) if remat
                    else _chunk_body(*args))
    return torch.cat(outs, 1)


def fused_graph_aggregate(tokens, values, mode: str = "knn", k: int = 8,
                          threshold: float = 0.0, temperature: float = 1.0,
                          impl: str = "auto"):
    """``graph_aggregate(build_adjacency(tokens), values)`` without the
    adjacency leaving the chip (it is written once, for the backward, when
    a gradient is needed). ``impl='auto'`` takes, as the JAX package's
    dispatcher does, :func:`graph_aggregate_chunked` where
    :func:`needs_chunked` says so (on either device), else kernel C for a
    CUDA tensor and the plain version for a CPU tensor; ``'reference'``
    always takes the plain version, with the ``[B, N, N]`` adjacency
    materialised."""
    _build.check_impl(impl)
    if impl == "auto" and needs_chunked(tokens.shape[1], tokens.shape[2],
                                        tokens.element_size()):
        return graph_aggregate_chunked(tokens, values, mode, k, threshold,
                                       temperature)
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
