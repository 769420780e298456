"""The blockwise attention kernels L and L′ and the large-N graph path on the
card, at the edges chip_smoke.py does not reach: the route boundary
(N = 750), ragged and exact-multiple tails (1025 = 16·64 + 1, 1088 = 17·64),
1024 px (4097), a dO that is not contiguous, a grid with fewer blocks than
the card has SMs, bit-equal repeat runs (L at both ragged tails, with
every row's lse finite), gradients through autograd against
the plain versions, the graph op's size dispatch on a CUDA tensor, and a
small bf16 ViT at 512 px trained one step with and without remat.

Marked ``cuda``: they skip without a card. This file imports nothing of JAX,
so it runs on a machine without it, where the JAX-importing conftest is left
out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_large.py -q

Tolerances, as in chip_smoke.py: o 2e-2 (bf16 outputs, one ulp is 2^-8
relative, and the kernel's p rounds against its running max), lse 1e-3
(fp32 sums in another order over up to 4097 keys), gradients 2e-2 of the
tensor's largest value (bf16 ds and outputs from fp32 sums in another
order).
"""

import pytest
import torch

from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.ops import attention as A
from gavit_tpu_torch.ops import graph_ops as G

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
O_TOL, LSE_TOL, GRAD_REL_TOL = 2e-2, 1e-3, 2e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", 0)


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, device=dev, generator=g)


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _rel(a, b):
    return _err(a, b) / max(b.float().abs().max().item(), 1e-30)


def _nan_tailed(t):
    """``t`` copied to the start of a buffer whose next 64·(last dim)
    elements are NaN: memory right past the last row."""
    flat = torch.full((t.numel() + 64 * t.shape[-1],), float("nan"),
                      device=t.device, dtype=t.dtype)
    flat[:t.numel()] = t.flatten()
    return flat[:t.numel()].view(t.shape)


@pytest.mark.parametrize("b,n,heads", [(1, 750, 2), (2, 1025, 2),
                                       (2, 1088, 1), (1, 4097, 2),
                                       (1, 750, 1), (3, 1025, 12),
                                       (1, 1088, 3)])
def test_blockwise_kernels_match_plain(dev, b, n, heads):
    """(1, 750, 1): 12 blocks on a card of 132 SMs. qkv and dO are followed
    in memory by NaN, which a kernel that read the query or key rows past
    N (the padded rows of the last tile) would take in: the gradients must
    stay finite, at the full last tile of 1088 = 17·64 and at 4097 too."""
    qkv = _nan_tailed(_randn(dev, b, n, 3 * heads * 64, seed=n).to(BF))
    before = (A.LARGE_KERNEL_LAUNCHES, A.LARGE_BWD_KERNEL_LAUNCHES)
    o, lse = A.qkv_attention_large_kernel(qkv, 0.125, heads)
    want_o, want_lse = A.blockwise_attention_reference(qkv, 0.125, heads)
    torch.cuda.synchronize()
    assert o.shape == (b, heads, n, 64) and o.dtype == BF
    assert lse.shape == (b, heads, n) and lse.dtype == torch.float32
    assert _err(o, want_o) <= O_TOL and _err(lse, want_lse) <= LSE_TOL
    # dO as the head-merging projection's backward hands it over
    do = _nan_tailed(_randn(dev, b, n, heads, 64, seed=n + 1).to(
        BF)).transpose(1, 2)
    want = A.blockwise_attention_backward_reference(qkv, o, lse, do, 0.125,
                                                    heads)
    got = A.qkv_attention_large_bwd_kernel(qkv, o, lse, do, 0.125, heads)
    again = A.qkv_attention_large_bwd_kernel(qkv, o, lse, do, 0.125, heads)
    torch.cuda.synchronize()
    assert got.shape == qkv.shape and got.dtype == BF
    assert torch.isfinite(got).all() and _rel(got, want) <= GRAD_REL_TOL
    assert torch.equal(got, again)  # no atomics: the same bits
    assert (A.LARGE_KERNEL_LAUNCHES, A.LARGE_BWD_KERNEL_LAUNCHES) == (
        before[0] + 1, before[1] + 2)


def test_blockwise_kernels_repeat_bit_for_bit(dev):
    qkv = _randn(dev, 2, 1025, 3 * 12 * 64, seed=5).to(BF)
    o1, l1 = A.qkv_attention_large_kernel(qkv, 0.125, 12)
    o2, l2 = A.qkv_attention_large_kernel(qkv, 0.125, 12)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)


@pytest.mark.parametrize("b,n", [(3, 1025), (1, 4097)])
def test_blockwise_forward_reruns_and_finite_lse(dev, b, n):
    """L at the two ragged tails (one key in the last key tile, one row in
    the last query tile): the same bits on a rerun, o and the lse of every
    row < N finite, and the lse of each row at least its largest score (a
    log-sum-exp is never below its largest term)."""
    heads = 2
    qkv = _randn(dev, b, n, 3 * heads * 64, seed=n + 11).to(BF)
    o1, l1 = A.qkv_attention_large_kernel(qkv, 0.125, heads)
    o2, l2 = A.qkv_attention_large_kernel(qkv, 0.125, heads)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    assert l1.shape == (b, heads, n)
    assert torch.isfinite(l1).all() and torch.isfinite(o1).all()
    q, k, _ = A._split_heads(qkv, heads)
    top = (torch.matmul(q.float(), k.float().transpose(-1, -2)) * 0.125).amax(-1)
    assert (l1 >= top - 1e-3).all()


def test_blockwise_bwd_reads_dout_and_o_through_strides(dev):
    """dO with padded rows (read through its strides) and dO whose last
    dim is strided (copied first): both give the contiguous dO's bits."""
    b, n, heads = 1, 1025, 2
    qkv = _randn(dev, b, n, 3 * heads * 64, seed=2).to(BF)
    o, lse = A.qkv_attention_large_kernel(qkv, 0.125, heads)
    base = _randn(dev, b, heads, n, 64, seed=3).to(BF)
    wide = torch.zeros(b, heads, n, 128, device=dev, dtype=BF)
    wide[..., :64] = base
    spaced = torch.zeros(b, heads, n, 64, 2, device=dev, dtype=BF)
    spaced[..., 0] = base
    want = A.qkv_attention_large_bwd_kernel(qkv, o, lse, base, 0.125, heads)
    for dout in (wide[..., :64], spaced[..., 0]):
        got = A.qkv_attention_large_bwd_kernel(qkv, o, lse, dout, 0.125,
                                               heads)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    # o as a contiguous [B, H, N, d] copy instead of kernel L's view
    got = A.qkv_attention_large_bwd_kernel(qkv, o.contiguous(), lse, base,
                                           0.125, heads)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_blockwise_gradients_match_autograd_through_plain(dev):
    """fused_qkv_attention at N = 1025 under autograd: L then L′ (one launch
    each) against the plain versions of the same route."""
    b, n, heads = 2, 1025, 4
    grads = {}
    for impl in ("auto", "reference"):
        qkv = _randn(dev, b, n, 3 * heads * 64, seed=1).to(
            BF).requires_grad_(True)
        before = (A.LARGE_KERNEL_LAUNCHES, A.LARGE_BWD_KERNEL_LAUNCHES)
        out = A.fused_qkv_attention(qkv.view(b, n, 3, heads, 64), 0.125,
                                    merge_heads=False, impl=impl)
        merged = out.transpose(1, 2).reshape(b, n, heads * 64)
        merged.backward(_randn(dev, b, n, heads * 64, seed=2).to(BF))
        launched = impl == "auto"
        assert (A.LARGE_KERNEL_LAUNCHES, A.LARGE_BWD_KERNEL_LAUNCHES) == (
            before[0] + launched, before[1] + launched)
        grads[impl] = qkv.grad
    torch.cuda.synchronize()
    assert _rel(grads["auto"], grads["reference"]) <= GRAD_REL_TOL


def test_routes_and_refusals_on_the_card(dev):
    bf_rows = torch.zeros(1, 750, 3 * 64, device=dev, dtype=BF)
    with pytest.raises(ValueError, match="L/L′"):
        A.qkv_attention_long_kernel(bf_rows, 0.125, 1)
    before = A.LONG_KERNEL_LAUNCHES
    A.fused_qkv_attention(bf_rows[:, :749].contiguous().view(1, 749, 3, 1, 64),
                          0.125)
    assert A.LONG_KERNEL_LAUNCHES == before + 1
    before = A.LARGE_KERNEL_LAUNCHES
    A.fused_qkv_attention(bf_rows.view(1, 750, 3, 1, 64), 0.125)
    assert A.LARGE_KERNEL_LAUNCHES == before + 1
    # fp32 rows of 750 tokens take L's fp32 body; a dtype neither takes
    # raises
    before = A.LARGE_F32_KERNEL_LAUNCHES
    A.fused_qkv_attention(bf_rows.float().view(1, 750, 3, 1, 64), 0.125)
    assert A.LARGE_F32_KERNEL_LAUNCHES == before + 1
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        A.qkv_attention_large_kernel(bf_rows.half(), 0.125, 1)


@pytest.mark.parametrize("n", [196, 1024])
def test_graph_dispatch_by_size_on_the_card(dev, n):
    """At ViT-B width in bf16 N = 196 launches kernel C; N = 1024 takes the
    chunked tensor ops and launches nothing; both match the materialised
    plain version on the rows whose neighbour set agrees (a near-tie in
    bf16 may pick another neighbour, which changes that whole row)."""
    t = _randn(dev, 2, n, 768, seed=n).to(BF)
    v = _randn(dev, 2, n, 768, seed=n + 1).to(BF)
    before = G.KERNEL_LAUNCHES
    got = G.fused_graph_aggregate(t, v, "knn", 8)
    assert G.KERNEL_LAUNCHES == before + (n == 196)
    adj = G.build_adjacency(t, k=8)
    want = G.graph_aggregate(adj, v)
    torch.cuda.synchronize()
    row_err = (got.float() - want.float()).abs().amax(-1)
    assert (row_err <= 2e-2).float().mean().item() >= 0.99
    assert got.shape == v.shape and torch.isfinite(got).all()


@pytest.mark.parametrize("remat", [False, True])
def test_small_vit_512px_training_step_through_kernels(dev, remat):
    """A small bf16 ViT (head_dim 64) at 512 px, one step through the
    kernels (L, L′; the chunked graph) against the plain versions from the
    same weights and seed: the losses agree and every gradient points the
    same way, with and without remat."""
    cfg = from_dict({"model": {
        "name": "custom", "img_size": 512, "patch_size": 16,
        "embed_dim": 128, "depth": 2, "num_heads": 2, "num_classes": 14,
        "drop_rate": 0.1, "remat": remat,
        "graph": {"enabled": True, "num_blocks": 1, "k": 8}}})
    x = _randn(dev, 2, 512, 512, 3, seed=7)
    grads, losses = {}, {}
    for impl in ("auto", "reference"):
        model = init_params(build_model(cfg.model, precision="bf16",
                                        impl=impl),
                            torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.graphs[0].gate.fill_(0.5)
        model = model.to(dev).train()
        before = (A.LARGE_KERNEL_LAUNCHES, A.LARGE_BWD_KERNEL_LAUNCHES,
                  G.KERNEL_LAUNCHES)
        loss = model(x, seed=11).float().square().mean()
        loss.backward()
        if impl == "auto":
            assert (A.LARGE_KERNEL_LAUNCHES - before[0],
                    A.LARGE_BWD_KERNEL_LAUNCHES - before[1],
                    G.KERNEL_LAUNCHES - before[2]) == (2 * (1 + remat), 2, 0)
        losses[impl] = loss.item()
        grads[impl] = [p.grad.flatten() for p in model.parameters()]
    assert abs(losses["auto"] - losses["reference"]) <= 2e-2 * abs(
        losses["reference"])
    for a, b in zip(grads["auto"], grads["reference"]):
        if b.abs().max() > 0:
            cos = torch.nn.functional.cosine_similarity(a.float(), b.float(),
                                                        dim=0)
            assert cos.item() >= 0.99
