"""The Hopper kernels against their plain PyTorch versions on the card, at
the edges the main paths do not reach: ragged and tiny N and M, widths that
are not a multiple of a tile, k past N-1, exact ties, the threshold
fallback, each body's dispatch bound (attention's kernel A up to 224 keys
and K past it, the graph's tensor-core body up to 256), dropout (F) and
GELU + dropout (H, H′) at rates 0 and 0.1 with the masks bit-identical to
the plain version's, the MLP's two routes, and the training kernels'
gradients against torch.autograd through the plain versions (A′ in fp32
too, at 1 to 416 tokens and 1 to 16 heads, reruns bit-equal, a dO 4 bytes
off alignment; K, K′, L and L′ in fp32 from one token to 4097 with NaN
right after qkv and dO, reruns bit-equal, through every route's autograd,
I/J fp32 and a captured CUDA graph); the graph's
TMA + wgmma body and D′ with NaN planted past their inputs and bit-equal
reruns; the
[B, H, N, d] attention kernels I/I′ and J/J′ from one token to 641, the
dropout-add G bit for bit, and the mask writer E; kernel B's chain
backward at the MAE widths, an eval Block's input gradient through A′ and
B's backward, and a small MAE step (rerun bit-equal, against the plain
versions). chip_smoke.py covers the serving and training shapes
themselves.

Marked ``cuda``: they skip without a card. This file imports nothing of JAX,
so it runs on a machine without it, where the JAX-importing conftest is left
out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q

Tolerances, as in chip_smoke.py: fp32 1e-5 (fp32 products summed in another
order), bf16 2e-2 (outputs rounded to bf16, one ulp is 2^-8 relative).
"""

import numpy as np
import pytest
import torch

from gavit_tpu_torch.config import from_dict
from gavit_tpu_torch.models.vit import build_model, init_params
from gavit_tpu_torch.ops import attention as A
from gavit_tpu_torch.ops import dropout as DR
from gavit_tpu_torch.ops import graph_ops as G
from gavit_tpu_torch.ops import mlp as M
from gavit_tpu_torch.ops import philox

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # PyTorch's default: the fp32 plain versions run in IEEE fp32, not TF32
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda", 0)


def _randn(dev, *shape, seed=0, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, device=dev, generator=g) * scale


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,heads", [
    (1, 1, 1), (3, 13, 2), (2, 15, 3), (1, 16, 12), (2, 17, 12), (3, 64, 2),
    (2, 65, 1), (1, 197, 12), (2, 208, 4), (1, 224, 3), (1, 225, 3),
    (1, 256, 2), (2, 257, 3), (2, 400, 1), (256, 50, 12), (4, 197, 8)])
def test_attention_kernel_matches_plain(dev, dtype, b, n, heads):
    """Kernel A (bf16 up to 224 tokens: the single-pass body, whose key row
    is one 224-row tile; fp32 up to 416) and K past 224 (its streamed body)
    through ``fused_qkv_attention``, at one token, partial and whole 16-,
    32- and 64-row tiles and both sides of each bound."""
    qkv = _randn(dev, b, n, 3 * heads * 64, seed=n).to(dtype)
    # bf16 past 224 keys takes kernel K
    counter = {"A": "KERNEL_LAUNCHES", "K": "LONG_KERNEL_LAUNCHES"}[
        A.attention_route(n, dtype)]
    before = getattr(A, counter)
    got = A.fused_qkv_attention(qkv.view(b, n, 3, heads, 64), 0.125,
                                merge_heads=False)
    assert getattr(A, counter) == before + 1
    want = A.attention_reference(*A._split_heads(qkv, heads), 0.125)
    torch.cuda.synchronize()
    assert got.shape == (b, heads, n, 64) and got.dtype == dtype
    assert _err(got, want) <= TOL[dtype]


def test_attention_kernel_refuses_what_it_does_not_take(dev):
    with pytest.raises(ValueError, match="head_dim 64"):
        A.qkv_attention_kernel(torch.zeros(1, 5, 3 * 2 * 32, device=dev),
                               0.2, 2)
    rows = torch.zeros(1, 5, 2 * 3 * 64, device=dev)[..., :3 * 64]
    with pytest.raises(ValueError, match="contiguous"):
        A.qkv_attention_kernel(rows, 0.125, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        A.qkv_attention_kernel(torch.zeros(1, 5, 3 * 64, device=dev,
                                           dtype=torch.float16), 0.125, 1)
    # fp32 K and V of one head at 384 px (N=577) exceed a block's 227 KB:
    # kernel A refuses them, and the route takes K's fp32 body
    qkv = torch.zeros(1, 577, 3 * 64, device=dev)
    with pytest.raises(ValueError, match="does not fit"):
        A.qkv_attention_kernel(qkv, 0.125, 1)
    before = A.LONG_F32_KERNEL_LAUNCHES
    out = A.fused_qkv_attention(qkv.view(1, 577, 3, 1, 64), 0.125)
    assert A.LONG_F32_KERNEL_LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert out.shape == (1, 577, 1, 64) and torch.isfinite(out).all()


@pytest.mark.parametrize("m,d,f", [(1, 64, 256), (5, 72, 136), (129, 64, 256),
                                   (1, 768, 3072), (197, 768, 3072),
                                   (300, 136, 520), (9232, 768, 3072),
                                   (12608, 768, 3072), (197, 512, 2048),
                                   (50432, 512, 2048)])
def test_mlp_kernel_matches_plain(dev, m, d, f):
    """Kernel B at ragged widths (d = 72, 136: a K tail; f = 136, 520: a
    partial column tile), at the served rows of ViT-B (b1, 197 = one
    image, 9232 = 384 px b16, 12608 = b64) and at the MAE decoder's widths
    (512, 2048; 50432 = b256 × 197), both GELU forms, the same bits on a
    rerun."""
    bf = torch.bfloat16
    x = _randn(dev, m, d, seed=1).to(bf)
    w1 = _randn(dev, f, d, seed=2, scale=d ** -0.5).to(bf)
    b1 = _randn(dev, f, seed=3, scale=0.1).to(bf)
    # |y| stays under 2, where one bf16 ulp (2^-7) is under the tolerance
    w2 = _randn(dev, d, f, seed=4, scale=0.5 * f ** -0.5).to(bf)
    b2 = _randn(dev, d, seed=5, scale=0.1).to(bf)
    for approximate in (True, False):
        before = M.KERNEL_LAUNCHES
        got = M.mlp_inference_kernel(x, w1, b1, w2, b2, approximate)
        again = M.mlp_inference_kernel(x, w1, b1, w2, b2, approximate)
        assert M.KERNEL_LAUNCHES == before + 2
        want = M._chain_infer(x, w1, b1, w2, b2, approximate)
        torch.cuda.synchronize()
        assert got.shape == (m, d) and got.dtype == bf
        assert torch.equal(got, again)
        assert _err(got, want) <= TOL[bf]


def test_mlp_dispatch_by_dtype(dev):
    """bf16 launches the kernel at any M; fp32 takes the GEMM chain."""
    x = _randn(dev, 2, 3, 64)
    w1, b1 = _randn(dev, 256, 64, scale=0.1), torch.zeros(256, device=dev)
    w2, b2 = _randn(dev, 64, 256, scale=0.1), torch.zeros(64, device=dev)
    before = M.KERNEL_LAUNCHES
    y32 = M.fused_mlp_inference(x, w1, b1, w2, b2, approximate=False)
    assert M.KERNEL_LAUNCHES == before
    bf = [t.bfloat16() for t in (x, w1, b1, w2, b2)]
    y16 = M.fused_mlp_inference(*bf)
    assert M.KERNEL_LAUNCHES == before + 1
    assert y32.shape == y16.shape == x.shape
    with pytest.raises(ValueError, match="divisible by 8"):
        M.mlp_inference_kernel(bf[0].reshape(6, 64)[:, :60].contiguous(),
                               bf[1][:, :60].contiguous(), bf[2],
                               bf[3][:60].contiguous(), bf[4][:60], True)


GRAPH_CASES = [  # (b, n, dim, mode, k, threshold, temperature)
    (1, 2, 32, "knn", 8, 0.0, 1.0),       # k past N-1
    (2, 5, 72, "knn", 1, 0.0, 1.0),       # dim not a multiple of 64
    (1, 17, 64, "threshold", 8, 0.1, 0.5),
    (3, 16, 128, "dense", 8, 0.0, 2.0),
    (1, 196, 768, "knn", 8, 0.0, 1.0),
    (1, 256, 64, "threshold", 8, 0.0, 1.0),  # the tensor-core body's bound
    (1, 257, 64, "knn", 20, 0.0, 1.0),       # past it: the CUDA-core body
]


# a selection decided by less than this may go either way between two
# summation orders of the same fp32 products
TIE_MARGIN = 1e-5


def _near_tie(sim, mode, k, threshold):
    """Rows whose selection sits within TIE_MARGIN of its boundary: the gap
    between the k-th and (k+1)-th non-self similarity (knn), or a non-self
    similarity that close to the threshold."""
    n = sim.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=sim.device)
    if mode == "knn":
        kk = min(k, n - 1)
        if kk == n - 1:
            return torch.zeros(sim.shape[:-1], dtype=torch.bool,
                               device=sim.device)
        top = torch.topk(sim.masked_fill(eye, -1e30), kk + 1, dim=-1).values
        return top[..., kk - 1] - top[..., kk] < TIE_MARGIN
    if mode == "threshold":
        gap = (sim - threshold).abs().masked_fill(eye, float("inf"))
        return gap.amin(-1) < TIE_MARGIN
    return torch.zeros(sim.shape[:-1], dtype=torch.bool, device=sim.device)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,dim,mode,k,thr,temp", GRAPH_CASES)
def test_graph_kernel_matches_plain(dev, dtype, b, n, dim, mode, k, thr, temp):
    t = _randn(dev, b, n, dim, seed=n).to(dtype)
    v = _randn(dev, b, n, dim, seed=n + 1).to(dtype)
    before = G.KERNEL_LAUNCHES
    got, adj = G.graph_aggregate_kernel(t, v, mode, k, thr, temp,
                                        return_adjacency=True)
    assert G.KERNEL_LAUNCHES == before + 1
    ref_adj = G.build_adjacency(t, mode=mode, k=k, threshold=thr,
                                temperature=temp)
    want = G.graph_aggregate(ref_adj, v)
    torch.cuda.synchronize()
    same = ((adj > 0) == (ref_adj > 0)).all(-1)
    assert got.shape == v.shape and got.dtype == dtype
    # a row may pick another neighbour only at a near-tie; the rest agree
    assert (same | _near_tie(G.cosine_similarity(t), mode, k, thr)).all()
    assert _err(got[same], want[same]) <= TOL[dtype]
    assert _err(adj[same], ref_adj[same]) <= TOL[dtype]
    if mode == "knn":
        assert ((adj > 0).sum(-1) == min(k, n - 1)).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [40, 300])  # both bodies
def test_graph_kernel_ties_prefer_lower_indices(dev, dtype, n):
    """Identical tokens tie exactly: the k neighbours of every row are the
    lowest non-self indices, as jax.lax.top_k picks them."""
    k = 5
    t = _randn(dev, 1, 1, 64).expand(1, n, 64).contiguous().to(dtype)
    v = _randn(dev, 1, n, 64, seed=3).to(dtype)
    _, adj = G.graph_aggregate_kernel(t, v, "knn", k, 0.0, 1.0,
                                      return_adjacency=True)
    want = torch.zeros(n, n, dtype=torch.bool)
    for i in range(n):
        want[i, [j for j in range(n) if j != i][:k]] = True
    assert torch.equal(adj[0].cpu() > 0, want)


def test_graph_threshold_without_edges_keeps_self(dev):
    t = _randn(dev, 2, 9, 64)
    v = _randn(dev, 2, 9, 64, seed=1)
    out = G.graph_aggregate_kernel(t, v, "threshold", 8, 1.5, 1.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, v, rtol=0, atol=0)


def _graph_sm90_cases():
    """(n, mode, k) over the tensor-core body's edges: one and several n8
    key blocks, a partial 64-row warpgroup and 128-row tile, N = 196 (the
    224-px patch tokens) and its bound 256; k at 1, 8 and N - 1."""
    cases = []
    for n in (2, 8, 64, 65, 196, 197, 256):
        cases += [(n, "knn", k) for k in sorted({1, 8, n - 1})]
        cases += [(n, "threshold", 8), (n, "dense", 8)]
    return cases


@pytest.mark.parametrize("with_adj", [False, True], ids=["out", "adj"])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("n,mode,k", _graph_sm90_cases())
def test_graph_sm90_body_edges(dev, n, mode, k, b, with_adj):
    """Kernel C's TMA + wgmma body in bf16 with NaN in memory right past
    tokens and values (rows past N must come from TMA's zero fill): the
    output finite and within tolerance of the plain version on every row
    whose selection is not a near-tie, the adjacency (when asked for) the
    plain version's, and the same bits on a rerun."""
    dim = 768 if n >= 196 else 136  # 136: a partial 64-dim chunk
    thr, temp = 0.0, 0.5 if mode == "threshold" else 1.0
    t = _nan_tailed(_randn(dev, b, n, dim, seed=n + k).to(torch.bfloat16))
    v = _nan_tailed(_randn(dev, b, n, dim, seed=n + k + 1).to(torch.bfloat16))
    before = G.KERNEL_LAUNCHES
    runs = [G.graph_aggregate_kernel(t, v, mode, k, thr, temp,
                                     return_adjacency=with_adj)
            for _ in range(2)]
    assert G.KERNEL_LAUNCHES == before + 2
    ref_adj = G.build_adjacency(t, mode=mode, k=k, threshold=thr,
                                temperature=temp)
    want = G.graph_aggregate(ref_adj, v)
    torch.cuda.synchronize()
    (out, adj), (out2, adj2) = (r if with_adj else (r, None) for r in runs)
    assert torch.isfinite(out).all() and torch.equal(out, out2)
    ok = ~_near_tie(G.cosine_similarity(t), mode, k, thr)
    if with_adj:
        assert torch.equal(adj, adj2)
        same = ((adj > 0) == (ref_adj > 0)).all(-1)
        assert (same | ~ok).all()
        ok = ok & same
        assert _err(adj[ok], ref_adj[ok]) <= TOL[torch.bfloat16]
        if mode == "knn":
            assert ((adj > 0).sum(-1) == min(k, n - 1)).all()
    assert _err(out[ok], want[ok]) <= TOL[torch.bfloat16]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("include_cls", [False, True])
def test_small_vit_kernels_match_plain_versions(dev, precision, include_cls):
    """A small ViT with head_dim 64 (kernel A's width) through the kernels
    and through the plain versions, on the same weights and images."""
    cfg = from_dict({"model": {
        "name": "custom", "img_size": 32, "patch_size": 8, "embed_dim": 128,
        "depth": 2, "num_heads": 2, "num_classes": 14,
        "graph": {"enabled": True, "num_blocks": 1, "k": 4,
                  "include_cls": include_cls}}}).model
    logits = {}
    for impl in ("auto", "reference"):
        model = init_params(build_model(cfg, precision=precision,
                                        impl=impl),
                            torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.graphs[0].gate.fill_(0.5)
        model = model.to(dev)
        x = _randn(dev, 3, 32, 32, 3, seed=7)
        with torch.inference_mode():
            logits[impl] = model(x)
    torch.cuda.synchronize()
    # fp32: summation order only; bf16: a one-ulp difference in an early
    # activation carries through the residual stream of both blocks
    tol = 1e-4 if precision == "fp32" else 5e-2
    assert logits["auto"].dtype == torch.float32
    assert _err(logits["auto"], logits["reference"]) <= tol


def _rel(a, b):
    """max |a - b| over max |b|."""
    return _err(a, b) / max(b.float().abs().max().item(), 1e-12)


def _ulps(got, want):
    """The largest distance from the plain version in bf16 ulps, taken at
    |want| floored at 2^-10 (two summation orders of the same fp32 products
    can round to neighbours; near 0 the floor absorbs fp32 cancellation)."""
    w = want.float()
    mag = torch.clamp(w.abs(), min=2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - w).abs() / ulp).max().item()


SEED = philox.step_seed(42, 7)

# The elementwise kernels' sizes past the unit (8 bf16 or 4 fp32 elements)
# and past the grid's step (the elements one step of a persistent grid
# covers, from the card's occupancy of each kernel): one unit past a whole
# step, a ragged tail after three steps, 2^25 + 3, and the 384-px hidden
# rows [16·577, 3072]. They are resolved on the card
# (``_elementwise_shape``); a (kernel, label) pair takes that kernel's step.
WALK_LABELS = ["one unit past a step", "ragged after three steps"]
WALK_SHAPES = WALK_LABELS + [(2 ** 25 + 3,), (16 * 577, 3072)]


def _elementwise_shape(shape, kernel, dtype):
    if isinstance(shape, tuple) and isinstance(shape[0], str):
        kernel, shape = shape
    if not isinstance(shape, str):
        return shape
    step = DR.walk_step(kernel, dtype, 1 << 33)
    return {"one unit past a step": (step + 16 // dtype.itemsize,),
            "ragged after three steps": (3 * step + 5,)}[shape]


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1,), (7,), (13, 9), (2, 197, 768),
                                   (1001,)] + WALK_SHAPES)
def test_dropout_kernel_is_bit_exact(dev, dtype, shape):
    shape = _elementwise_shape(shape, "F", dtype)
    x = _randn(dev, *shape, seed=3).to(dtype)
    before = DR.KERNEL_LAUNCHES
    got = DR.dropout_kernel(x, SEED, 17, 0.1)
    assert DR.KERNEL_LAUNCHES == before + 1
    want = DR.dropout_reference(x, SEED, 17, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(DR.dropout_kernel(x, SEED, 17, 0.1), got)
    # the backward is the same mask on the gradient
    xr = x.clone().requires_grad_(True)
    g = _randn(dev, *shape, seed=4).to(dtype)
    DR.fused_dropout(xr, SEED, 17, 0.1).backward(g)
    assert torch.equal(xr.grad, DR.dropout_reference(g, SEED, 17, 0.1))
    assert DR.fused_dropout(x, SEED, 17, 0.0) is x


# (2050, 768, 3072): 2 x 1025 tokens, as at 512 px, partial 128-row tiles
MLP_SHAPES = [(1, 64, 256), (5, 72, 136), (129, 64, 256), (394, 768, 3072),
              (300, 136, 520), (2050, 768, 3072)]


def _mlp_train_inputs(dev, m, d, f):
    bf = torch.bfloat16
    x = _randn(dev, m, d, seed=1).to(bf)
    w1 = _randn(dev, f, d, seed=2, scale=d ** -0.5).to(bf)
    b1 = _randn(dev, f, seed=3, scale=0.1).to(bf)
    w2 = _randn(dev, d, f, seed=4, scale=0.5 * f ** -0.5).to(bf)
    b2 = _randn(dev, d, seed=5, scale=0.1).to(bf)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,d,f", MLP_SHAPES)
def test_mlp_train_kernels_match_plain(dev, m, d, f, rate):
    args = _mlp_train_inputs(dev, m, d, f)
    sites = (5, 6)
    before = (M.TRAIN_FWD_LAUNCHES, M.TRAIN_BWD_LAUNCHES)
    y, h1 = M.mlp_train_kernel(*args, SEED, sites, rate, rate)
    y_ref, h1_ref = M.mlp_train_reference(*args, SEED, sites, rate, rate)
    dy = _randn(dev, m, d, seed=6).to(torch.bfloat16)
    got = M.mlp_train_bwd_kernel(dy, h1_ref, args[3], SEED, sites, rate, rate)
    want = M.mlp_train_bwd_reference(dy, h1_ref, args[3], SEED, sites, rate,
                                     rate)
    assert (M.TRAIN_FWD_LAUNCHES, M.TRAIN_BWD_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    y_again, h1_again = M.mlp_train_kernel(*args, SEED, sites, rate, rate)
    torch.cuda.synchronize()
    # one fp32 sum an element, no atomics: a rerun gives the same bits
    assert torch.equal(y, y_again) and torch.equal(h1, h1_again)
    assert _ulps(h1, h1_ref) <= 1, f"h1 off by {_ulps(h1, h1_ref)} ulp"
    # y against the plain second half on the kernel's own h1 (a one-ulp h1
    # difference moves GELU and y by more than y's ulp)
    y_fc2 = M.mlp_train_fc2_reference(h1, *args[3:], SEED, sites, rate, rate)
    assert _ulps(y, y_fc2) <= 1, f"y off by {_ulps(y, y_fc2)} ulp"
    assert _rel(y, y_ref) <= 2e-2
    if rate:  # the output mask: dropped elements are exactly 0 on both sides
        keep = philox.keep_mask((m, d), SEED, sites[1], rate, device=dev)
        assert bool((y[~keep] == 0).all()) and bool((y_ref[~keep] == 0).all())
    dh1, go, db1, db2, dye = got
    assert torch.equal(dye, want[4])  # an elementwise bf16 product: exact
    # GELU runs the same IEEE operations in the kernel and the plain version
    assert torch.equal(go, want[1])
    assert _rel(dh1, want[0]) <= 2e-2 and _rel(go, want[1]) <= 2e-2
    assert _rel(db1, want[2]) <= 1e-3 and _rel(db2, want[3]) <= 1e-3
    if rate:  # the hidden mask regenerated in the backward
        keep_h = philox.keep_mask((m, f), SEED, sites[0], rate, device=dev)
        assert bool((go[~keep_h] == 0).all()) and bool((dh1[~keep_h] == 0).all())


@pytest.mark.parametrize("out_on", [False, True], ids=["out_off", "out_on"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("m,d,f", MLP_SHAPES)
def test_mlp_train_bwd_kernel_tails_and_reruns(dev, m, d, f, rate, out_on):
    """Kernel D′ (the dh GEMM on the wgmma mainloop) with the output mask on
    and off independently of the hidden one, and NaN in memory right past
    h1, dy and W2 (a row read past M or D would take it in): dh1, go, db1
    and db2 finite, within tolerance of the plain version (go and dye bit
    for bit), and the same bits on a rerun."""
    out_rate = 0.1 if out_on else 0.0
    w2 = _nan_tailed(_mlp_train_inputs(dev, m, d, f)[3])
    h1 = _nan_tailed(_randn(dev, m, f, seed=7).to(torch.bfloat16))
    dy = _nan_tailed(_randn(dev, m, d, seed=6).to(torch.bfloat16))
    sites = (5, 6)
    before = M.TRAIN_BWD_LAUNCHES
    got, again = (M.mlp_train_bwd_kernel(dy, h1, w2, SEED, sites, rate,
                                         out_rate) for _ in range(2))
    assert M.TRAIN_BWD_LAUNCHES == before + 2
    want = M.mlp_train_bwd_reference(dy, h1, w2, SEED, sites, rate, out_rate)
    torch.cuda.synchronize()
    for name, a, b in zip(("dh1", "go", "db1", "db2"), got, again):
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), name
    dh1, go, db1, db2, dye = got
    assert torch.equal(dye, want[4]) and torch.equal(go, want[1])
    assert _rel(dh1, want[0]) <= 2e-2
    assert _rel(db1, want[2]) <= 1e-3 and _rel(db2, want[3]) <= 1e-3


def test_mlp_train_kernel_hidden_mask_is_exact(dev):
    """Kernel D's hidden mask seen through y: with W2 the identity, b2 zero
    and the output site off, y = g exactly (one nonzero product a sum), so
    y holds GELU(h1)·keep·scale rounded, bit for bit the plain version's,
    and zero at every dropped element of the hidden site."""
    m, d = 300, 256
    x, w1, b1, _, _ = _mlp_train_inputs(dev, m, d, d)
    eye = torch.eye(d, device=dev, dtype=torch.bfloat16)
    zero = torch.zeros(d, device=dev, dtype=torch.bfloat16)
    sites = (5, 6)
    y, h1 = M.mlp_train_kernel(x, w1, b1, eye, zero, SEED, sites, 0.1, 0.0)
    g = M.mlp_train_fc2_reference(h1, eye, zero, SEED, sites, 0.1, 0.0)
    keep_h = philox.keep_mask((m, d), SEED, sites[0], 0.1, device=dev)
    torch.cuda.synchronize()
    assert torch.equal(y, g)
    assert bool((y[~keep_h] == 0).all()) and bool((y[keep_h] != 0).any())


@pytest.mark.parametrize("m,d,f", [(197, 64, 256), (394, 768, 3072),
                                   (256, 64, 256), (512, 768, 3072)])
def test_mlp_train_gradients_match_autograd_through_plain(dev, m, d, f):
    """Both routes in bf16: M = 197 and 394 have no row block (the chain:
    H/H′, F), 256 and 512 do (D/D′)."""
    fused = M.mlp_route(m, d, f, torch.bfloat16) == "fused"
    assert fused == (m % 32 == 0)
    grads = {}
    for impl in ("auto", "reference"):
        leaves = [t.clone().requires_grad_(True)
                  for t in _mlp_train_inputs(dev, m, d, f)]
        before = _launches()
        y = M.fused_mlp(*leaves, SEED, (1, 2), 0.1, 0.1, impl=impl)
        y.backward(_randn(dev, m, d, seed=9).to(torch.bfloat16))
        grads[impl] = [t.grad for t in leaves]
        moved = [a - b for a, b in zip(_launches(), before)]
        if impl == "auto":
            assert moved == ([1, 1, 0, 0, 0] if fused else [0, 0, 1, 1, 2])
    torch.cuda.synchronize()
    for got, want in zip(grads["auto"], grads["reference"]):
        assert got.dtype == want.dtype and _rel(got, want) <= 2e-2


def _launches():
    return (M.TRAIN_FWD_LAUNCHES, M.TRAIN_BWD_LAUNCHES, DR.GELU_LAUNCHES,
            DR.GELU_BWD_LAUNCHES, DR.KERNEL_LAUNCHES)


def test_mlp_train_fp32_takes_the_chain_on_the_card(dev):
    """fp32 MLP training on the card runs fc1, H, fc2 and F (H′ and F in
    the backward), launches no D or D′, and matches the plain versions."""
    grads = {}
    for impl in ("auto", "reference"):
        leaves = [t.float().clone().requires_grad_(True)
                  for t in _mlp_train_inputs(dev, 5, 64, 256)]
        before = _launches()
        y = M.fused_mlp(*leaves, SEED, (1, 2), 0.1, 0.1, impl=impl)
        y.backward(_randn(dev, 5, 64, seed=9))
        grads[impl] = [y.detach()] + [t.grad for t in leaves]
        moved = [a - b for a, b in zip(_launches(), before)]
        assert moved == ([0, 0, 1, 1, 2] if impl == "auto" else [0] * 5)
    torch.cuda.synchronize()
    for got, want in zip(grads["auto"], grads["reference"]):
        assert got.dtype == torch.float32 and _err(got, want) <= 1e-4


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1,), (7,), (13, 9), (3, 577, 3072),
                                   (1001,)] + WALK_SHAPES[2:]
                         + [(k, label) for k in ("H", "H′")
                            for label in WALK_LABELS])
def test_gelu_dropout_kernels_are_bit_exact(dev, dtype, shape, rate):
    """H and H′ against their plain versions: the same bits, zeros
    included (GELU runs the same IEEE operations on both sides), and
    reruns bit-equal; past the step of H's grid and of H′'s."""
    shape = _elementwise_shape(shape, "H", dtype)
    x = _randn(dev, *shape, seed=5, scale=2.0).to(dtype)
    g = _randn(dev, *shape, seed=6).to(dtype)
    before = (DR.GELU_LAUNCHES, DR.GELU_BWD_LAUNCHES)
    y = DR.gelu_dropout_kernel(x, SEED, 23, rate)
    dx = DR.gelu_dropout_bwd_kernel(x, g, SEED, 23, rate)
    assert (DR.GELU_LAUNCHES, DR.GELU_BWD_LAUNCHES) == (before[0] + 1,
                                                        before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(y, DR.gelu_dropout_reference(x, SEED, 23, rate))
    assert torch.equal(dx, DR.gelu_dropout_bwd_reference(x, g, SEED, 23,
                                                         rate))
    assert torch.equal(DR.gelu_dropout_kernel(x, SEED, 23, rate), y)
    assert torch.equal(DR.gelu_dropout_bwd_kernel(x, g, SEED, 23, rate), dx)
    # through the autograd op: x saved, the mask regenerated
    xr = x.clone().requires_grad_(True)
    DR.fused_gelu_dropout(xr, SEED, 23, rate).backward(g)
    assert torch.equal(xr.grad, dx)


def _nan_tailed(t):
    """``t`` copied to the start of a buffer whose next 64·(last dim)
    elements are NaN: memory right past the last row, which a kernel that
    read rows past N would take in."""
    flat = torch.full((t.numel() + 64 * t.shape[-1],), float("nan"),
                      device=t.device, dtype=t.dtype)
    flat[:t.numel()] = t.flatten()
    return flat[:t.numel()].view(t.shape)


@pytest.mark.parametrize("b,n,heads", [(1, 1, 1), (2, 13, 2), (2, 17, 12),
                                       (1, 197, 12), (2, 224, 3),
                                       (2, 64, 1), (1, 65, 6), (3, 128, 4),
                                       (1, 224, 12), (64, 50, 12),
                                       (4, 197, 8)])
def test_attention_bwd_kernel_matches_plain(dev, b, n, heads):
    """A′ (the backward pair under A′'s entry) on qkv rows and a dO followed
    in memory by NaN: within 2e-2 of the plain version, finite, the same
    bits on a rerun, one launch counted a call."""
    bf = torch.bfloat16
    qkv = _nan_tailed(_randn(dev, b, n, 3 * heads * 64, seed=n).to(bf))
    # dO as it arrives from the output projection: [B, N, H, d] memory
    # behind a [B, H, N, d] view, and once made contiguous
    do_bnhd = _nan_tailed(_randn(dev, b, n, heads, 64, seed=n + 1).to(bf))
    want = A.attention_backward_reference(qkv, do_bnhd.transpose(1, 2),
                                          0.125, heads)
    before = A.BWD_KERNEL_LAUNCHES
    for dout in (do_bnhd.transpose(1, 2), do_bnhd.transpose(1, 2).contiguous()):
        got = A.qkv_attention_bwd_kernel(qkv, dout, 0.125, heads)
        again = A.qkv_attention_bwd_kernel(qkv, dout, 0.125, heads)
        torch.cuda.synchronize()
        assert got.shape == qkv.shape and got.dtype == bf
        assert torch.isfinite(got).all() and _rel(got, want) <= 2e-2
        assert torch.equal(got, again)  # no atomics: the same bits
    assert A.BWD_KERNEL_LAUNCHES == before + 4


def test_attention_gradients_match_autograd_through_plain(dev):
    b, n, heads = 2, 197, 12
    grads = {}
    for impl in ("auto", "reference"):
        qkv = _randn(dev, b, n, 3 * heads * 64, seed=1).to(
            torch.bfloat16).requires_grad_(True)
        out = A.fused_qkv_attention(qkv.view(b, n, 3, heads, 64), 0.125,
                                    merge_heads=False, impl=impl)
        # through the head merge, as HeadMergeProj feeds it
        merged = out.transpose(1, 2).reshape(b, n, heads * 64)
        merged.backward(_randn(dev, b, n, heads * 64, seed=2).to(
            torch.bfloat16))
        grads[impl] = qkv.grad
    torch.cuda.synchronize()
    assert _rel(grads["auto"], grads["reference"]) <= 2e-2


@pytest.mark.parametrize("b,n,heads", [(1, 1, 1), (2, 17, 3), (1, 50, 16),
                                       (2, 197, 12), (1, 416, 2),
                                       (1, 416, 12)])
def test_attention_bwd_kernel_fp32_matches_plain(dev, b, n, heads):
    """A′ in fp32 (``csrc/attention.cu``'s two CUDA-core launches) on qkv
    rows and a dO followed in memory by NaN, dO as the output projection
    hands it over and contiguous: within 1e-5 of the plain version relative
    to its largest value (fp32 products summed in another order), finite,
    the same bits on a rerun, one launch counted a call (on
    its own counter); and through
    ``fused_qkv_attention``'s autograd."""
    qkv = _nan_tailed(_randn(dev, b, n, 3 * heads * 64, seed=n))
    do_bnhd = _nan_tailed(_randn(dev, b, n, heads, 64, seed=n + 1))
    want = A.attention_backward_reference(qkv, do_bnhd.transpose(1, 2),
                                          0.125, heads)
    before = A.BWD_F32_KERNEL_LAUNCHES
    for dout in (do_bnhd.transpose(1, 2), do_bnhd.transpose(1, 2).contiguous()):
        got = A.qkv_attention_bwd_kernel(qkv, dout, 0.125, heads)
        again = A.qkv_attention_bwd_kernel(qkv, dout, 0.125, heads)
        torch.cuda.synchronize()
        assert got.shape == qkv.shape and got.dtype == torch.float32
        assert torch.isfinite(got).all() and _rel(got, want) <= 1e-5
        assert torch.equal(got, again)  # no atomics: the same bits
    assert A.BWD_F32_KERNEL_LAUNCHES == before + 4
    leaf = qkv.clone().requires_grad_(True)
    out = A.fused_qkv_attention(leaf.view(b, n, 3, heads, 64), 0.125,
                                merge_heads=False)
    out.backward(do_bnhd.transpose(1, 2))
    assert A.BWD_F32_KERNEL_LAUNCHES == before + 5
    assert torch.equal(leaf.grad, got)


def test_attention_bwd_kernel_fp32_takes_a_misaligned_dout(dev):
    """dO as a contiguous fp32 view 4 bytes past a 16-byte boundary: copied
    to a fresh tensor, the same bits as from an aligned one."""
    qkv = _randn(dev, 2, 37, 3 * 2 * 64, seed=3)
    do = _randn(dev, 2, 2, 37, 64, seed=4)
    got = A.qkv_attention_bwd_kernel(qkv, _offset_view(do), 0.125, 2)
    want = A.qkv_attention_bwd_kernel(qkv, do.clone(), 0.125, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_attention_bwd_kernel_refuses_what_it_does_not_take(dev):
    qkv = torch.zeros(1, 417, 3 * 64, device=dev)
    with pytest.raises(NotImplementedError, match="K′ or L′"):
        A.qkv_attention_bwd_kernel(
            qkv, torch.zeros(1, 1, 417, 64, device=dev), 0.125, 1)
    qkv = torch.zeros(1, 225, 3 * 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="N <= 224"):
        A.qkv_attention_bwd_kernel(
            qkv, torch.zeros(1, 1, 225, 64, device=dev, dtype=torch.bfloat16),
            0.125, 1)


def test_small_vit_training_step_through_kernels(dev):
    """A small bf16 ViT (head_dim 64) trained one step through the kernels
    and through the plain versions from the same weights and seed: the
    losses agree and every gradient points the same way."""
    cfg = from_dict({"model": {
        "name": "custom", "img_size": 32, "patch_size": 8, "embed_dim": 128,
        "depth": 2, "num_heads": 2, "num_classes": 14, "drop_rate": 0.1,
        "graph": {"enabled": True, "num_blocks": 1, "k": 4}}})
    x = _randn(dev, 4, 32, 32, 3, seed=7)
    grads, losses = {}, {}
    for impl in ("auto", "reference"):
        model = init_params(build_model(cfg.model, precision="bf16",
                                        impl=impl),
                            torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.graphs[0].gate.fill_(0.5)
        model = model.to(dev).train()
        loss = model(x, seed=SEED).float().square().mean()
        loss.backward()
        losses[impl] = loss.item()
        grads[impl] = [p.grad.flatten() for p in model.parameters()]
    assert abs(losses["auto"] - losses["reference"]) <= 2e-2 * abs(
        losses["reference"])
    for a, b in zip(grads["auto"], grads["reference"]):
        if b.abs().max() > 0:
            cos = torch.nn.functional.cosine_similarity(a, b, dim=0)
            assert cos.item() >= 0.99


LONG_CASES = [(1, 1, 1), (2, 15, 3), (1, 16, 1), (2, 17, 2), (1, 64, 3),
              (1, 65, 3), (3, 130, 2), (1, 197, 12), (2, 208, 2), (1, 224, 2),
              (1, 225, 3), (2, 256, 2), (1, 257, 2), (1, 577, 12),
              (2, 640, 2), (1, 641, 3), (2, 749, 2)]


@pytest.mark.parametrize("b,n,heads", LONG_CASES)
def test_long_attention_kernels_match_plain(dev, b, n, heads):
    """K and K′ at ragged N (one token, partial and whole tiles, K's single
    pass up to 224 and its streamed pass from 225, 384 px, I's last length
    and K′'s bound), dO through the strides it arrives with and
    contiguous; K′ run again for the same bits."""
    bf = torch.bfloat16
    qkv = _randn(dev, b, n, 3 * heads * 64, seed=n).to(bf)
    before = (A.LONG_KERNEL_LAUNCHES, A.LONG_BWD_KERNEL_LAUNCHES)
    got = A.qkv_attention_long_kernel(qkv, 0.125, heads)
    want = A.attention_reference(*A._split_heads(qkv, heads), 0.125)
    do_bnhd = _randn(dev, b, n, heads, 64, seed=n + 1).to(bf)
    dwant = A.attention_backward_reference(qkv, do_bnhd.transpose(1, 2),
                                           0.125, heads)
    for dout in (do_bnhd.transpose(1, 2),
                 do_bnhd.transpose(1, 2).contiguous()):
        dgot = A.qkv_attention_long_bwd_kernel(qkv, dout, 0.125, heads)
        torch.cuda.synchronize()
        assert dgot.shape == qkv.shape and dgot.dtype == bf
        assert _rel(dgot, dwant) <= 2e-2
    again = A.qkv_attention_long_bwd_kernel(qkv, dout, 0.125, heads)
    torch.cuda.synchronize()
    assert torch.equal(dgot, again)
    assert (A.LONG_KERNEL_LAUNCHES, A.LONG_BWD_KERNEL_LAUNCHES) == (
        before[0] + 1, before[1] + 3)
    assert got.shape == (b, heads, n, 64) and _err(got, want) <= TOL[bf]


@pytest.mark.parametrize("kernel,b,n", [("A", 8, 197), ("K", 2, 197),
                                          ("K", 16, 577)])
def test_attention_forward_reruns_are_bit_equal(dev, kernel, b, n):
    """The forward has no atomics and sums in a fixed order: two runs of A
    and of K on the same rows give the same bits (K at 197 takes the single
    pass, at 577 the streamed one)."""
    qkv = _randn(dev, b, n, 3 * 12 * 64, seed=n).to(torch.bfloat16)
    fn = {"A": A.qkv_attention_kernel, "K": A.qkv_attention_long_kernel}[kernel]
    first, second = fn(qkv, 0.125, 12), fn(qkv, 0.125, 12)
    torch.cuda.synchronize()
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)


def test_long_attention_gradients_match_autograd_through_plain(dev):
    b, n, heads = 2, 577, 12
    grads = {}
    for impl in ("auto", "reference"):
        qkv = _randn(dev, b, n, 3 * heads * 64, seed=1).to(
            torch.bfloat16).requires_grad_(True)
        before = A.LONG_BWD_KERNEL_LAUNCHES
        out = A.fused_qkv_attention(qkv.view(b, n, 3, heads, 64), 0.125,
                                    merge_heads=False, impl=impl)
        merged = out.transpose(1, 2).reshape(b, n, heads * 64)
        merged.backward(_randn(dev, b, n, heads * 64, seed=2).to(
            torch.bfloat16))
        assert A.LONG_BWD_KERNEL_LAUNCHES == before + (impl == "auto")
        grads[impl] = qkv.grad
    torch.cuda.synchronize()
    assert _rel(grads["auto"], grads["reference"]) <= 2e-2


# fp32 rows from one token to past the exact family's bound: partial and
# whole 16-row blocks and 64-row tiles, A's fp32 bound + 1, 384 px and
# K's fp32 bound; heads 1 to 16
LONG_F32_CASES = [(1, 1, 1), (2, 17, 3), (1, 64, 2), (1, 65, 16),
                  (2, 130, 1), (1, 417, 12), (2, 577, 4), (1, 708, 2)]
# L's: the fp32 route's first length, 512 px, a tile multiple, 1024 px
LARGE_F32_CASES = [(1, 1, 1), (2, 65, 3), (1, 709, 2), (1, 1025, 12),
                   (2, 1088, 1), (1, 4097, 2)]


@pytest.mark.parametrize("b,n,heads", LONG_F32_CASES)
def test_long_attention_kernels_fp32_match_plain(dev, b, n, heads):
    """K and K′ in fp32 (``csrc/attention_f32.cu``) on qkv rows and a dO
    each followed in memory by NaN, dO as the output projection hands it
    over and contiguous: o within 1e-5, dqkv within 1e-5 of the plain
    versions relative to its largest value (fp32 products summed in
    another order), finite, the same bits on a rerun, each launch on its
    own counter."""
    qkv = _nan_tailed(_randn(dev, b, n, 3 * heads * 64, seed=n))
    do_bnhd = _nan_tailed(_randn(dev, b, n, heads, 64, seed=n + 1))
    before = (A.LONG_F32_KERNEL_LAUNCHES, A.LONG_BWD_F32_KERNEL_LAUNCHES,
              A.LONG_KERNEL_LAUNCHES, A.LONG_BWD_KERNEL_LAUNCHES)
    got = A.qkv_attention_long_kernel(qkv, 0.125, heads)
    again = A.qkv_attention_long_kernel(qkv, 0.125, heads)
    want = A.attention_reference(*A._split_heads(qkv, heads), 0.125)
    dwant = A.attention_backward_reference(qkv, do_bnhd.transpose(1, 2),
                                           0.125, heads)
    for dout in (do_bnhd.transpose(1, 2), do_bnhd.transpose(1, 2).contiguous()):
        dgot = A.qkv_attention_long_bwd_kernel(qkv, dout, 0.125, heads)
        dagain = A.qkv_attention_long_bwd_kernel(qkv, dout, 0.125, heads)
        torch.cuda.synchronize()
        assert dgot.shape == qkv.shape and dgot.dtype == torch.float32
        assert torch.isfinite(dgot).all() and _rel(dgot, dwant) <= 1e-5
        assert torch.equal(dgot, dagain)
    assert got.shape == (b, heads, n, 64) and got.dtype == torch.float32
    assert torch.isfinite(got).all() and _err(got, want) <= TOL[torch.float32]
    assert torch.equal(got, again)
    assert (A.LONG_F32_KERNEL_LAUNCHES, A.LONG_BWD_F32_KERNEL_LAUNCHES,
            A.LONG_KERNEL_LAUNCHES, A.LONG_BWD_KERNEL_LAUNCHES) == (
        before[0] + 2, before[1] + 4, before[2], before[3])


@pytest.mark.parametrize("b,n,heads", LARGE_F32_CASES)
def test_large_attention_kernels_fp32_match_plain(dev, b, n, heads):
    """L and L′ in fp32 against their plain versions on NaN-tailed rows and
    dO: o within 1e-5, the fp32 lse within 1e-5 (the online softmax over
    64-key tiles against one pass), dqkv from L's o and lse within 1e-5
    relative to its largest value; finite, reruns bit-equal, each launch
    on its own counter."""
    qkv = _nan_tailed(_randn(dev, b, n, 3 * heads * 64, seed=n))
    before = (A.LARGE_F32_KERNEL_LAUNCHES, A.LARGE_BWD_F32_KERNEL_LAUNCHES,
              A.LARGE_KERNEL_LAUNCHES, A.LARGE_BWD_KERNEL_LAUNCHES)
    o, lse = A.qkv_attention_large_kernel(qkv, 0.125, heads)
    o2, lse2 = A.qkv_attention_large_kernel(qkv, 0.125, heads)
    want_o, want_lse = A.blockwise_attention_reference(qkv, 0.125, heads)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32 and lse.shape == (b, heads, n)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert _err(o, want_o) <= TOL[torch.float32]
    assert _err(lse, want_lse) <= 1e-5
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    do = _nan_tailed(_randn(dev, b, n, heads, 64, seed=n + 1)).transpose(1, 2)
    got = A.qkv_attention_large_bwd_kernel(qkv, o, lse, do, 0.125, heads)
    again = A.qkv_attention_large_bwd_kernel(qkv, o, lse, do, 0.125, heads)
    want = A.blockwise_attention_backward_reference(qkv, o, lse, do, 0.125,
                                                    heads)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and _rel(got, want) <= 1e-5
    assert torch.equal(got, again)
    assert (A.LARGE_F32_KERNEL_LAUNCHES, A.LARGE_BWD_F32_KERNEL_LAUNCHES,
            A.LARGE_KERNEL_LAUNCHES, A.LARGE_BWD_KERNEL_LAUNCHES) == (
        before[0] + 2, before[1] + 2, before[2], before[3])


@pytest.mark.parametrize("n,route", [(300, "A"), (577, "K"), (750, "L")])
def test_fp32_attention_gradients_match_autograd_through_plain(dev, n,
                                                               route):
    """fp32 rows through ``fused_qkv_attention`` and the head merge, on
    each route of its length: A/A′ at 300 tokens, K/K′ fp32 at 577 (the
    384-px fine-tune), L/L′ fp32 at 750; the gradients within 1e-5 of
    autograd through the plain versions (relative to the largest), one
    forward and one backward launched on the route's counters."""
    b, heads = 2, 3
    counters = {"A": ("KERNEL_LAUNCHES", "BWD_F32_KERNEL_LAUNCHES"),
                "K": ("LONG_F32_KERNEL_LAUNCHES",
                      "LONG_BWD_F32_KERNEL_LAUNCHES"),
                "L": ("LARGE_F32_KERNEL_LAUNCHES",
                      "LARGE_BWD_F32_KERNEL_LAUNCHES")}[route]
    assert A.attention_route(n, torch.float32) == route
    grads = {}
    for impl in ("auto", "reference"):
        qkv = _randn(dev, b, n, 3 * heads * 64, seed=1).requires_grad_(True)
        before = [getattr(A, c) for c in counters]
        out = A.fused_qkv_attention(qkv.view(b, n, 3, heads, 64), 0.125,
                                    merge_heads=False, impl=impl)
        merged = out.transpose(1, 2).reshape(b, n, heads * 64)
        merged.backward(_randn(dev, b, n, heads * 64, seed=2))
        moved = [getattr(A, c) - v for c, v in zip(counters, before)]
        assert moved == [int(impl == "auto")] * 2
        grads[impl] = qkv.grad
    torch.cuda.synchronize()
    assert _rel(grads["auto"], grads["reference"]) <= 1e-5


@pytest.mark.parametrize("entry", ["I", "J"])
@pytest.mark.parametrize("b,heads,n", [(1, 1, 1), (2, 3, 65), (1, 12, 197),
                                       (1, 2, 640)])
def test_bhnd_attention_kernels_fp32_match_plain(dev, entry, b, heads, n):
    """I/I′ and J/J′ in fp32 (K's and K′'s fp32 bodies read through the
    strides) on q, k, v as views of [B, N, H, d] memory and a contiguous
    dO: within 1e-5 of the plain versions, reruns bit-equal, only the entry
    point's counters moving."""
    qkv = [_randn(dev, b, n, heads, 64, seed=n + i).transpose(1, 2)
           for i in range(3)]
    do = _randn(dev, b, heads, n, 64, seed=n + 3)
    e = {"I": "v1", "J": "v2"}[entry]
    counters = ("V1_KERNEL_LAUNCHES", "V1_BWD_KERNEL_LAUNCHES",
                "V2_KERNEL_LAUNCHES", "V2_BWD_KERNEL_LAUNCHES",
                "LONG_F32_KERNEL_LAUNCHES", "LONG_BWD_F32_KERNEL_LAUNCHES")
    before = {c: getattr(A, c) for c in counters}
    got = A.bhnd_kernel(e, False, *qkv, 0.125)
    again = A.bhnd_kernel(e, False, *qkv, 0.125)
    grads = A.bhnd_kernel(e, True, *qkv, do, 0.125)
    gagain = A.bhnd_kernel(e, True, *qkv, do, 0.125)
    want = A.attention_reference(*qkv, 0.125)
    dwant = A.attention_bhnd_backward_reference(*qkv, do, 0.125)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and _err(got, want) <= TOL[
        torch.float32]
    assert torch.equal(got, again)
    for a, w, a2 in zip(grads, dwant, gagain):
        assert _rel(a, w) <= 1e-5 and torch.equal(a, a2)
    fc, bc = {"I": counters[:2], "J": counters[2:4]}[entry]
    moved = {c: getattr(A, c) - before[c] for c in counters}
    assert moved == {c: {fc: 2, bc: 2}.get(c, 0) for c in counters}


def test_fp32_long_attention_is_captured_and_replayed(dev):
    """K's and L's fp32 launches allocate, copy and synchronise nothing: a
    CUDA graph captures them, and its replay gives the eager bits."""
    for n in (577, 1025):
        qkv = _randn(dev, 2, n, 3 * 2 * 64, seed=n)
        eager = A.fused_qkv_attention(qkv.view(2, n, 3, 2, 64), 0.125)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            A.fused_qkv_attention(qkv.view(2, n, 3, 2, 64), 0.125)
            with torch.cuda.graph(graph, stream=stream):
                out = A.fused_qkv_attention(qkv.view(2, n, 3, 2, 64), 0.125)
        torch.cuda.current_stream().wait_stream(stream)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_route_raises_past_the_long_kernels_bound(dev):
    """Past K_MAX_N of its dtype (749 in bf16, 708 in fp32) kernel K raises
    and the route takes L instead, fp32 rows L's fp32 body; a dtype
    neither takes raises."""
    for dtype, counter in ((torch.bfloat16, "LARGE_KERNEL_LAUNCHES"),
                           (torch.float32, "LARGE_F32_KERNEL_LAUNCHES")):
        n = A.K_MAX_N[dtype] + 1
        qkv = torch.zeros(1, n, 3 * 64, device=dev, dtype=dtype)
        before = getattr(A, counter)
        A.fused_qkv_attention(qkv.view(1, n, 3, 1, 64), 0.125)
        assert getattr(A, counter) == before + 1
        with pytest.raises(ValueError, match="L/L′"):
            A.qkv_attention_long_kernel(qkv, 0.125, 1)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        A.qkv_attention_long_kernel(qkv[:, :5].half().contiguous(), 0.125, 1)
    # kernel A's fp32 body ends where the route says it does
    lib = A._build.library()
    f32 = A._build.dtype_code(torch.float32)
    assert lib.gavit_attention_fits(A.A_MAX_N[torch.float32], f32) == 1
    assert lib.gavit_attention_fits(A.A_MAX_N[torch.float32] + 1, f32) == 0
    bf = A._build.dtype_code(torch.bfloat16)
    assert lib.gavit_attention_fits(224, bf) == 1
    assert lib.gavit_attention_fits(225, bf) == 0


BHND_CASES = [(1, 1, 1), (2, 2, 7), (1, 3, 64), (2, 2, 65), (1, 12, 197),
              (1, 2, 256), (2, 3, 257), (1, 2, 640), (1, 2, 749)]


@pytest.mark.parametrize("entry", ["I", "J"])
@pytest.mark.parametrize("b,heads,n", BHND_CASES)
def test_bhnd_attention_kernels_match_plain(dev, entry, b, heads, n):
    """I/I′ (attention_pallas) and J/J′ (fused_attention_v2) on [B, H, N,
    64] at one token, partial and whole tiles, 224 px, I's last length
    and K′'s bound (749);
    q, k, v as views of [B, N, H, d] memory (strided) and dO contiguous;
    the same bits on a rerun; only the entry point's own counters move."""
    bf = torch.bfloat16
    qkv = [_randn(dev, b, n, heads, 64, seed=n + i).to(bf).transpose(1, 2)
           for i in range(3)]
    do = _randn(dev, b, heads, n, 64, seed=n + 3).to(bf)
    e = {"I": "v1", "J": "v2"}[entry]
    names = {"I": ("V1_KERNEL_LAUNCHES", "V1_BWD_KERNEL_LAUNCHES"),
             "J": ("V2_KERNEL_LAUNCHES", "V2_BWD_KERNEL_LAUNCHES")}
    counters = [n_ for pair in names.values() for n_ in pair]
    before = {c: getattr(A, c) for c in counters}
    got = A.bhnd_kernel(e, False, *qkv, 0.125)
    grads = A.bhnd_kernel(e, True, *qkv, do, 0.125)
    again = A.bhnd_kernel(e, True, *qkv, do, 0.125)
    want = A.attention_reference(*qkv, 0.125)
    dwant = A.attention_bhnd_backward_reference(*qkv, do, 0.125)
    torch.cuda.synchronize()
    assert got.shape == (b, heads, n, 64) and got.dtype == bf
    assert _err(got, want) <= TOL[bf]
    for a, w, a2 in zip(grads, dwant, again):
        assert a.shape == w.shape and _rel(a, w) <= 2e-2
        assert torch.equal(a, a2)
    moved = {c: getattr(A, c) - before[c] for c in counters}
    fc, bc = names[entry]
    assert moved == {c: {fc: 1, bc: 2}.get(c, 0) for c in counters}


def test_bhnd_entry_points_route_and_refuse(dev):
    """attention_pallas takes I up to 640 tokens and L/L′ from 641; J
    takes 641 too; gradients through autograd match the plain versions';
    fp32 runs (I's and J's fp32 bodies, and L's past 640); head_dim other
    than 64 raises, naming the ROADMAP item."""
    bf = torch.bfloat16
    for n, counter in ((640, "V1_KERNEL_LAUNCHES"),
                       (641, "LARGE_KERNEL_LAUNCHES")):
        q, k, v = (_randn(dev, 1, 2, n, 64, seed=i).to(bf).requires_grad_(
            True) for i in range(3))
        before = getattr(A, counter)
        out = A.attention_pallas(q, k, v, 0.125)
        assert getattr(A, counter) == before + 1
        g = _randn(dev, 1, 2, n, 64, seed=5).to(bf)
        got = torch.autograd.grad(out, (q, k, v), g)
        want = A.attention_bhnd_backward_reference(q, k, v, g, 0.125)
        assert _err(out, A.attention_reference(q, k, v, 0.125)) <= TOL[bf]
        for a, w in zip(got, want):
            assert _rel(a, w) <= 2e-2
        before = A.V2_KERNEL_LAUNCHES
        A.fused_attention_v2(q, k, v, 0.125)
        assert A.V2_KERNEL_LAUNCHES == before + 1
    for n, counter in ((5, "V1_KERNEL_LAUNCHES"),
                       (641, "LARGE_F32_KERNEL_LAUNCHES")):
        x = _randn(dev, 1, 1, n, 64, seed=n)
        before = getattr(A, counter)
        out = A.attention_pallas(x, x, x, 0.125)
        assert getattr(A, counter) == before + 1
        assert _err(out, A.attention_reference(x, x, x, 0.125)) <= TOL[
            torch.float32]
    for fn in (A.attention_pallas, A.fused_attention_v2,
               A.multi_head_attention):
        x = torch.zeros(1, 1, 5, 64, device=dev)
        assert torch.equal(fn(x, x, x, 0.125), x)
        x = torch.zeros(1, 1, 5, 32, device=dev, dtype=bf)
        with pytest.raises(NotImplementedError, match="head_dim"):
            fn(x, x, x, 0.125)
        with pytest.raises(NotImplementedError, match="Queue 2 item 10.7"):
            fn(x.float(), x.float(), x.float(), 0.125)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(1,), (7,), (13, 9), (2, 197, 768)]
                         + WALK_SHAPES[2:])
def test_dropout_add_kernel_is_bit_exact(dev, dtype, shape):
    """G gives the bits of r + F(y), reruns bit-equal; through autograd its
    gradients are (F(g), g), F launched once for the backward. G takes one
    unit a thread (no step to walk past); 2^25 + 3 leaves a ragged tail."""
    seed = philox.step_seed(4, 1)
    y = _randn(dev, *shape, seed=1).to(dtype).requires_grad_(True)
    r = _randn(dev, *shape, seed=2).to(dtype).requires_grad_(True)
    before = (DR.ADD_LAUNCHES, DR.KERNEL_LAUNCHES)
    out = DR.fused_dropout_add(y, r, seed, 5, 0.1)
    g = _randn(dev, *shape, seed=3).to(dtype)
    dy, dr = torch.autograd.grad(out, (y, r), g)
    assert (DR.ADD_LAUNCHES, DR.KERNEL_LAUNCHES) == (before[0] + 1,
                                                     before[1] + 1)
    want = r + DR.dropout_reference(y, seed, 5, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(dy, DR.dropout_reference(g, seed, 5, 0.1))
    assert torch.equal(dr, g)
    before = DR.ADD_LAUNCHES
    assert torch.equal(DR.dropout_add_kernel(y.detach(), r.detach(), seed, 5,
                                             0.1), out)
    assert DR.ADD_LAUNCHES == before + 1


# (25216, 3072, 768): the b128 MLP rows; (4099, 8191, 3): both masks ragged
# after many units, the first past 2^25 elements
@pytest.mark.parametrize("m,f,d", [(1, 8, 0), (3, 13, 5), (197, 3072, 768),
                                   (25216, 3072, 768), (4099, 8191, 3)])
def test_kernel_mask_matches_keep_mask(dev, m, f, d):
    """E writes both masks in one launch, bit-equal to ``keep_mask`` and to
    a rerun."""
    seed, sites = philox.step_seed(9, 3), (4, 5)
    before = M.MASK_LAUNCHES
    hidden, out = M.kernel_mask(seed, sites, m, f, 0.1, d=d,
                                out_rate=0.1 if d else 0.0)
    assert M.MASK_LAUNCHES == before + 1
    again = M.kernel_mask(seed, sites, m, f, 0.1, d=d,
                          out_rate=0.1 if d else 0.0)
    torch.cuda.synchronize()
    assert torch.equal(again[0], hidden)
    assert (again[1] is None) if out is None else torch.equal(again[1], out)
    assert hidden.dtype == torch.float32 and hidden.device.type == "cuda"
    assert torch.equal(hidden.bool(), philox.keep_mask(
        (m, f), seed, sites[0], 0.1, device=dev))
    assert torch.equal(hidden.bool().float(), hidden)
    if d:
        assert torch.equal(out.bool(), philox.keep_mask(
            (m, d), seed, sites[1], 0.1, device=dev))
    else:
        assert out is None


def _offset_view(t):
    """A contiguous copy of ``t`` that starts one element (2 bytes in bf16,
    4 in fp32) past a 16-byte boundary: ``contiguous()`` returns such a
    view unchanged."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    with torch.no_grad():
        view = flat[1:1 + t.numel()].view(t.shape)
        view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == t.element_size()
    return view


@pytest.mark.parametrize("entry", ["multi_head_attention", "attention_pallas",
                                   "fused_attention_v2"])
def test_attention_entry_points_take_misaligned_views(dev, entry):
    """q, k, v and dO as contiguous bf16 views at a 2-byte offset: the
    entry point copies them to fresh tensors and gives the bits it gives
    the aligned tensors, forward and backward."""
    bf = torch.bfloat16
    fn = getattr(A, entry)
    qkv = [_randn(dev, 2, 2, 37, 64, seed=i).to(bf) for i in range(3)]
    do = _randn(dev, 2, 2, 37, 64, seed=9).to(bf)
    outs = {}
    for name, make in (("aligned", torch.clone), ("offset", _offset_view)):
        leaves = [make(t).requires_grad_(True) for t in qkv]
        out = fn(*leaves, 0.125)
        outs[name] = (out.detach(),
                      *torch.autograd.grad(out, leaves, make(do)))
    for got, want in zip(outs["offset"], outs["aligned"]):
        assert torch.equal(got, want)


@pytest.mark.parametrize("entry", ["fused_dropout", "fused_dropout_add",
                                   "fused_gelu_dropout"])
def test_elementwise_entry_points_take_misaligned_views(dev, entry):
    """F, G and H/H′ on bf16 views at a 2-byte offset (inputs and the
    incoming gradient): the same bits as on aligned tensors, each kernel
    launched."""
    bf = torch.bfloat16
    x = _randn(dev, 5, 37, seed=1).to(bf)
    r = _randn(dev, 5, 37, seed=2).to(bf)
    g = _randn(dev, 5, 37, seed=3).to(bf)
    fn = {"fused_dropout": lambda a, b: DR.fused_dropout(a, SEED, 3, 0.1),
          "fused_dropout_add": lambda a, b: DR.fused_dropout_add(
              a, b, SEED, 3, 0.1),
          "fused_gelu_dropout": lambda a, b: DR.fused_gelu_dropout(
              a, SEED, 3, 0.1)}[entry]
    counter = {"fused_dropout": "KERNEL_LAUNCHES",
               "fused_dropout_add": "ADD_LAUNCHES",
               "fused_gelu_dropout": "GELU_LAUNCHES"}[entry]
    outs = {}
    for name, make in (("aligned", torch.clone), ("offset", _offset_view)):
        a = make(x).requires_grad_(True)
        before = getattr(DR, counter)
        out = fn(a, make(r))
        assert getattr(DR, counter) == before + 1
        outs[name] = (out.detach(), *torch.autograd.grad(out, a, make(g)))
    for got, want in zip(outs["offset"], outs["aligned"]):
        assert torch.equal(got, want)


def _small_train_cfg(accum: int, batch: int):
    return from_dict({
        "model": {"name": "custom", "img_size": 32, "patch_size": 8,
                  "embed_dim": 128, "depth": 2, "num_heads": 2,
                  "num_classes": 14, "drop_rate": 0.1,
                  "graph": {"enabled": True, "num_blocks": 1, "k": 4}},
        "data": {"image_size": 32, "batch_size": batch},
        "training": {"precision": "bf16", "epochs": 2, "warmup_epochs": 1,
                     "grad_accum_steps": accum}})


def _small_trainer(cfg, dev, impl="auto", loaders=(None, None)):
    from gavit_tpu_torch.training.trainer import Trainer

    model = init_params(build_model(cfg.model, precision="bf16", impl=impl),
                        torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.graphs[0].gate.fill_(0.5)
    return Trainer(cfg, model, torch.ones(14), 4, device=dev,
                   train_loader=loaders[0], val_loader=loaders[1])


def test_accumulated_step_reruns_bit_equal(dev):
    """Two optimizer steps of 2 accumulated micro-batches (uint8 images,
    augmentation and dropout on) from the same start, twice: every
    parameter, the λ and both AdamW moments come out bit-equal."""
    g = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (8, 32, 32, 3), generator=g,
                           dtype=torch.uint8)
    labels = (torch.rand(8, 14, generator=g) < 0.3).float()
    runs = []
    for _ in range(2):
        tr = _small_trainer(_small_train_cfg(2, 8), dev)
        for _ in range(2):
            tr.train_step(images, labels)
        state = tr.optimizer.state
        runs.append([t.detach().clone() for p in
                     [*tr.model.parameters(), *tr.criterion.parameters()]
                     for t in (p, state[p]["exp_avg"], state[p]["exp_avg_sq"])])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_ragged_val_tail_through_kernels_matches_plain(dev):
    """validate over 11 images in batches of 4 (a tail of 3): kernels A, B
    and C take every batch, the tail too, and the loss and the tail's
    probabilities agree with the plain versions'."""
    from gavit_tpu_torch.data.dataset import SyntheticChestXrayDataset
    from gavit_tpu_torch.data.loader import DataLoader
    from gavit_tpu_torch.ops.preprocess import val_preprocess

    ds = SyntheticChestXrayDataset(size=11, image_size=32, seed=1)
    cfg = _small_train_cfg(1, 4)
    out = {}
    for impl in ("auto", "reference"):
        tr = _small_trainer(cfg, dev, impl, (None, DataLoader(ds, 4)))
        before = (A.KERNEL_LAUNCHES, M.KERNEL_LAUNCHES, G.KERNEL_LAUNCHES)
        loss = tr.validate()["loss"]
        moved = tuple(c - b for c, b in zip(
            (A.KERNEL_LAUNCHES, M.KERNEL_LAUNCHES, G.KERNEL_LAUNCHES),
            before))
        tr.model.eval()
        with torch.no_grad():
            tail = torch.sigmoid(tr.model(val_preprocess(
                torch.from_numpy(ds.batch(range(8, 11))[0]).to(dev))))
        out[impl] = (loss, moved, tail)
    assert out["auto"][1] == (2 * 3, 2 * 3, 3)
    assert out["reference"][1] == (0, 0, 0)
    assert abs(out["auto"][0] - out["reference"][0]) <= 2e-2 * abs(
        out["reference"][0])
    assert _err(out["auto"][2], out["reference"][2]) <= 2e-2


# --- int8 serving, QAT's MLP chain and ToMe's token counts -----------------

# (K, N) of every quantised GEMM of ViT-B/16 with its graph blocks: the
# patch projection, qkv, the attention and graph projections and the graph
# value, fc1, fc2 and the head
INT8_SITES = [(768, 768), (768, 2304), (768, 3072), (3072, 768), (768, 14)]


@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("k,n", INT8_SITES)
def test_int8_gemm_at_every_site_is_bit_equal(dev, b, k, n):
    """cuBLASLt's int8 GEMM (``torch._int_mm``, padded where it refuses a
    shape: the head's N = 14, M ≤ 16 at b1) against the plain float64 sum,
    bit for bit, at each site's rows: b·197 tokens (b·196 for the graph's
    patch rows) and b rows for the head; then the static int8 product's
    fp32 output, also bit for bit."""
    from gavit_tpu_torch.ops import quant as Q

    rows = [b] if n == 14 else [b * 197, b * 196]
    g = torch.Generator(device=dev).manual_seed(k + n + b)
    w_q = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                        dtype=torch.int8)
    for m in rows:
        xq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                           dtype=torch.int8)
        before = Q.INT8_MM_LAUNCHES
        got = Q.int8_mm(xq, w_q)
        assert Q.INT8_MM_LAUNCHES == before + 1
        want = Q.int8_mm_reference(xq, w_q)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got, want)
        x = _randn(dev, m, k, seed=m).to(torch.bfloat16)
        w_scale = torch.rand(1, n, device=dev, generator=g) * 1e-3
        s = torch.tensor(0.02, device=dev)
        assert torch.equal(Q.static_int8_matmul(x, w_q, w_scale, s),
                           Q.static_int8_matmul(x, w_q, w_scale, s,
                                                impl="reference"))


def test_int8_gemm_raises_rather_than_falls_back(dev):
    from gavit_tpu_torch.ops import quant as Q

    with pytest.raises(ValueError, match="CUDA"):
        Q.int8_mm_kernel(torch.zeros(17, 8, dtype=torch.int8),
                         torch.zeros(8, 8, dtype=torch.int8, device=dev))
    with pytest.raises(TypeError, match="int8"):
        Q.int8_mm(torch.zeros(17, 8, device=dev),
                  torch.zeros(8, 8, dtype=torch.int8, device=dev))


@pytest.mark.parametrize("n", range(101, 198, 8))
def test_attention_kernel_at_merged_token_counts(dev, n):
    """Kernel A at the token counts ToMe leaves at r = 8 (197, 189, ...,
    101), b8 × 12 heads, against its plain version."""
    qkv = _randn(dev, 8, n, 3 * 12 * 64, seed=n).to(torch.bfloat16)
    before = A.KERNEL_LAUNCHES
    got = A.fused_qkv_attention(qkv.view(8, n, 3, 12, 64), 0.125,
                                merge_heads=False)
    assert A.KERNEL_LAUNCHES == before + 1
    want = A.attention_reference(*A._split_heads(qkv, 12), 0.125)
    torch.cuda.synchronize()
    assert _err(got, want) <= TOL[torch.bfloat16]


def _quant_cfg():
    return from_dict({"model": {
        "name": "custom", "img_size": 32, "patch_size": 8, "embed_dim": 64,
        "depth": 2, "num_heads": 1, "num_classes": 14, "drop_rate": 0.1,
        "graph": {"enabled": True, "num_blocks": 1, "adjacency": "knn",
                  "k": 4}}, "data": {"image_size": 32}})


def test_quant_mlp_takes_the_chain(dev):
    """Under int8 and QAT the MLP never launches B, D or D′: in eval its
    GELU is the tensor op between the quantised GEMMs, in QAT training H
    and H′ run between them and F drops its output (forward and
    backward)."""
    from gavit_tpu_torch.serving import calibrate_act_scales
    from gavit_tpu_torch.utils.convert import load_quant_state

    cfg = _quant_cfg()
    x = _randn(dev, 4, 32, 32, 3)
    counters = lambda: (M.KERNEL_LAUNCHES, M.TRAIN_FWD_LAUNCHES,  # noqa
                        M.TRAIN_BWD_LAUNCHES, DR.GELU_LAUNCHES,
                        DR.GELU_BWD_LAUNCHES)
    model = init_params(build_model(cfg.model, precision="int8"),
                        torch.Generator().manual_seed(0)).to(dev)
    before = counters()
    with torch.no_grad():
        model(x)
    assert counters() == before
    model = init_params(build_model(cfg.model, precision="bf16", qat=True),
                        torch.Generator().manual_seed(0)).to(dev)
    load_quant_state(model, calibrate_act_scales(model, x))
    model.train()
    before, f_before = counters(), DR.KERNEL_LAUNCHES
    model(x, seed=7).float().sum().backward()
    moved = [a - b for a, b in zip(counters(), before)]
    assert moved == [0, 0, 0, 2, 2]
    # F: the embedding, 2 attention and 2 MLP outputs, 1 graph projection,
    # forward and backward
    assert DR.KERNEL_LAUNCHES - f_before == 2 * 6


def test_int8_predictor_reruns_bit_equal(dev):
    from gavit_tpu_torch.ops import quant as Q
    from gavit_tpu_torch.serving import Predictor

    pred = Predictor(_quant_cfg(), precision="int8", device=dev,
                     buckets=(1, 8))
    pred.warmup()
    assert pred.calibrated
    imgs = torch.randint(0, 256, (5, 32, 32, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(1)).numpy()
    before = Q.INT8_MM_LAUNCHES
    first = pred._predict_proba_eager(imgs)
    # per forward: patch, head, and qkv, proj, fc1, fc2 in 2 blocks, value
    # and proj in the graph block (counted on the eager path: a replay runs
    # no wrapper)
    assert Q.INT8_MM_LAUNCHES - before == 2 + 2 * 4 + 2
    assert np.array_equal(first, pred.predict_proba(imgs))
    assert np.array_equal(first, pred.predict_proba(imgs))
    ref = Predictor(_quant_cfg(), precision="int8", device=dev,
                    buckets=(1, 8), impl="reference")
    ref.warmup()
    assert np.abs(ref.predict_proba(imgs) - first).max() <= 2e-2


# kernel B's backward (``ops/mlp.py::_MlpInference``): the VJP of the chain
# recomputed from the inputs, as the JAX package's ``_fmi_bwd``


@pytest.mark.parametrize("m,d,f", [(12800, 768, 3072), (9850, 512, 2048),
                                   (333, 512, 2048)])
def test_mlp_inference_gradients_match_autograd_through_the_chain(dev, m, d,
                                                                  f):
    """bf16 at the MAE encoder's and decoder's widths (12800 = b256 × 50,
    9850 = b50 × 197) and a ragged M: the forward launches kernel B once,
    the backward none, and every gradient is within 2e-2 of autograd's
    through the plain chain (``_chain_infer``, fp32 GEMMs), and
    nonzero."""
    bf = torch.bfloat16
    tensors = [_randn(dev, m, d, seed=1), _randn(dev, f, d, seed=2,
                                                 scale=d ** -0.5),
               _randn(dev, f, seed=3, scale=0.1),
               _randn(dev, d, f, seed=4, scale=0.5 * f ** -0.5),
               _randn(dev, d, seed=5, scale=0.1)]
    dy = _randn(dev, m, d, seed=6).to(bf)
    grads = {}
    for kernel in (True, False):
        args = [t.to(bf).requires_grad_(True) for t in tensors]
        before = M.KERNEL_LAUNCHES
        y = (M.fused_mlp_inference(*args) if kernel
             else M._chain_infer(*args, True))
        assert M.KERNEL_LAUNCHES - before == kernel
        y.backward(dy)
        assert M.KERNEL_LAUNCHES - before == kernel
        grads[kernel] = [a.grad for a in args]
    torch.cuda.synchronize()
    for name, got, want in zip(("x", "w1", "b1", "w2", "b2"), grads[True],
                               grads[False]):
        assert got.dtype == bf and torch.isfinite(got).all(), name
        assert got.abs().max() > 0, name
        assert _rel(got, want) <= 2e-2, name


def test_eval_block_input_gradients_reach_the_mlp(dev):
    """A bf16 Block in eval mode (the serving forward: A and B) with a
    gradient asked of its input: the input's gradient through kernels A′
    and B's chain backward against the plain versions' (2e-2), and the
    MLP's weights get gradients; the no-grad forward launches the same
    kernels."""
    from gavit_tpu_torch.models.layers import Block

    x0 = _randn(dev, 4, 50, 128, seed=8).to(torch.bfloat16)
    dy = _randn(dev, 4, 50, 128, seed=9).to(torch.bfloat16)
    grads = {}
    for impl in ("auto", "reference"):
        torch.manual_seed(0)
        block = Block(128, 2, dtype=torch.bfloat16, impl=impl).to(dev).eval()
        with torch.no_grad():
            for p in block.parameters():
                p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                    .manual_seed(p.numel())) * 0.05
                        + (1.0 if p.ndim == 1 and p.shape[0] == 128 else 0))
        before = (A.KERNEL_LAUNCHES, M.KERNEL_LAUNCHES)
        with torch.no_grad():
            block(x0)
        x = x0.clone().requires_grad_(True)
        block(x).backward(dy)
        moved = (A.KERNEL_LAUNCHES - before[0],
                 M.KERNEL_LAUNCHES - before[1])
        assert moved == ((2, 2) if impl == "auto" else (0, 0))
        assert block.mlp.fc1.weight.grad.abs().max() > 0
        assert block.mlp.fc2.weight.grad.abs().max() > 0
        grads[impl] = x.grad
    torch.cuda.synchronize()
    assert _rel(grads["auto"], grads["reference"]) <= 2e-2


def _small_mae_pretrainer(dev, impl="auto"):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent /
                           "scripts"))
    from pretrain_mae_torch import MAEPretrainer

    cfg = from_dict({
        "model": {"name": "custom", "img_size": 32, "patch_size": 8,
                  "embed_dim": 128, "depth": 2, "num_heads": 2,
                  "num_classes": 14},
        "data": {"image_size": 32, "batch_size": 8,
                 "augment_affine": True},
        "training": {"precision": "bf16", "epochs": 2, "warmup_epochs": 1,
                     "learning_rate": 1e-3}})
    return MAEPretrainer(cfg, dev, 2, decoder_dim=128, decoder_depth=1,
                         decoder_heads=2, impl=impl)


def test_small_mae_step_reruns_bit_equal_and_matches_plain(dev):
    """Two bf16 MAE steps of a small model (head_dim 64, A, A′ and B in
    every block) from one seed, twice: the losses, the parameters and both
    AdamW moments bit-equal; the first step's loss within 2e-2 of the
    plain versions' and each first gradient at cosine ≥ 0.99, every MLP
    weight's gradient nonzero; one step launches A, A′ and B once a block
    and nothing else."""
    images = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    runs = []
    for _ in range(2):
        pre = _small_mae_pretrainer(dev)
        losses = [pre.train_step(images).item() for _ in range(2)]
        state = pre.optimizer.state
        runs.append((losses, [t.detach().clone() for p in pre.params
                              for t in (p, state[p]["exp_avg"],
                                        state[p]["exp_avg_sq"])]))
    torch.cuda.synchronize()
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))

    from gavit_tpu_torch.models.mae import mae_loss

    grads, losses = {}, {}
    for impl in ("auto", "reference"):
        pre = _small_mae_pretrainer(dev, impl)
        x, noise = pre.draws(images.to(dev))
        counts = (A.KERNEL_LAUNCHES, A.BWD_KERNEL_LAUNCHES,
                  M.KERNEL_LAUNCHES, M.TRAIN_FWD_LAUNCHES,
                  M.TRAIN_BWD_LAUNCHES, DR.KERNEL_LAUNCHES)
        pred, mask = pre.model(x, noise)
        loss = mae_loss(pred, x, mask, 8)
        loss.backward()
        moved = tuple(c - b for c, b in zip(
            (A.KERNEL_LAUNCHES, A.BWD_KERNEL_LAUNCHES, M.KERNEL_LAUNCHES,
             M.TRAIN_FWD_LAUNCHES, M.TRAIN_BWD_LAUNCHES,
             DR.KERNEL_LAUNCHES), counts))
        assert moved == ((3, 3, 3, 0, 0, 0) if impl == "auto"
                         else (0,) * 6)
        losses[impl] = loss.item()
        grads[impl] = [(n, p.grad.float().flatten())
                       for n, p in pre.model.named_parameters()]
    assert abs(losses["auto"] - losses["reference"]) <= 2e-2 * abs(
        losses["reference"])
    for (name, a), (_, b) in zip(grads["auto"], grads["reference"]):
        if ".mlp.fc" in name and name.endswith("weight"):
            assert a.abs().max() > 0, name
        if a.abs().max() == 0 and b.abs().max() == 0:
            continue
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        assert cos >= 0.99, (name, cos)


# --- the captured serve path: one CUDA graph per bucket ---------------------


def _serve_cfg(size=224, depth=2):
    """ViT-B/16's widths (768, 12 heads) with a kNN graph block after block
    0, cut to ``depth`` blocks: at 224 px kernel A, at 384 K, at 512 L."""
    return from_dict({"model": {
        "name": "custom", "img_size": size, "patch_size": 16,
        "embed_dim": 768, "depth": depth, "num_heads": 12, "num_classes": 14,
        "graph": {"enabled": True, "num_blocks": 1, "insert_after": [0],
                  "adjacency": "knn", "k": 8}}, "data": {"image_size": size}})


def _u8(b, size, seed):
    return torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed)).numpy()


def _port_kernels(fn):
    """The port's kernels that ``fn()`` ran on the device, ``{name:
    launches}``, from a ``torch.profiler`` trace (each sits in an anonymous
    namespace of its csrc file, named as below; a few of PyTorch's do
    too): a CUDA graph's replay shows its kernels there, though it runs no
    wrapper."""
    import re
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    port = re.compile(
        r"^(void )?\(anonymous namespace\)::(attn_|gemm90::|graph_|moe_|"
        r"colsum_reduce|bwd_prologue|keep_mask_kernel|elementwise_kernel<)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and port.match(e.key):
            kernels[e.key] += e.count
    return dict(kernels)


def _replays_eager(pred, imgs):
    """``pred``'s replay on ``imgs`` against its eager path: bit-equal, the
    eager path's wrappers launching (their counts returned), the replay
    moving no counter and running the same port kernels on the device."""
    want, eager_counts = _moved(lambda: pred._predict_proba_eager(imgs))
    got, counts = _moved(lambda: pred.predict_proba(imgs))
    assert np.array_equal(got, want)
    assert eager_counts and not counts
    kernels = _port_kernels(lambda: pred._predict_proba_eager(imgs))
    assert kernels
    assert _port_kernels(lambda: pred.predict_proba(imgs)) == kernels
    return got, eager_counts


def _moved(fn):
    from gavit_tpu_torch.ops import _build

    torch.cuda.synchronize()
    before = _build.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = _build.launch_counts()
    return out, {k: v - before[k] for k, v in after.items() if v != before[k]}


def _qat_checkpoint(cfg, path):
    """A checkpoint holding QAT act scales, as the QAT trainer writes one."""
    from gavit_tpu_torch.serving import calibrate_act_scales
    from gavit_tpu_torch.ops.preprocess import val_preprocess
    from gavit_tpu_torch.utils import checkpoint as ckpt_lib

    model = init_params(build_model(cfg.model, qat=True),
                        torch.Generator().manual_seed(3))
    x = val_preprocess(torch.from_numpy(_u8(4, cfg.data.image_size, 7)))
    ckpt_lib.save(str(path), {"model": model.state_dict(),
                              "quant": calibrate_act_scales(model, x)}, {})
    return str(path)


@pytest.mark.parametrize("variant", ["bf16", "int8", "qat", "tome"])
def test_captured_buckets_equal_eager_and_plain(dev, tmp_path, variant):
    """Every default bucket at 224 px, each one CUDA graph captured at
    warm-up: the replay bit-equal to the eager kernel path, running the
    same port kernels on the device (a profiler trace; a replay runs no
    wrapper), and within 2e-2 of the plain versions (int8 and QAT on the
    same scales)."""
    from gavit_tpu_torch.serving import DEFAULT_BUCKETS, Predictor
    from gavit_tpu_torch.utils.convert import quant_state

    cfg = _serve_cfg()
    kw = {"bf16": {"precision": "bf16"}, "int8": {"precision": "int8"},
          "qat": {"precision": "int8", "checkpoint_path": _qat_checkpoint(
              cfg, tmp_path / "qat")},
          "tome": {"precision": "bf16", "tome_r": 8}}[variant]
    pred = Predictor(cfg, device=dev, **kw)
    pred.warmup()
    assert sorted(pred._graphs) == list(DEFAULT_BUCKETS)
    plain = Predictor(cfg, device=dev, impl="reference", **kw)
    if kw["precision"] == "int8":
        plain.use_quant_state(quant_state(pred.model))
    for i, b in enumerate(DEFAULT_BUCKETS):
        imgs = _u8(b, 224, i)
        got, _ = _replays_eager(pred, imgs)
        assert np.abs(got - plain.predict_proba(imgs)).max() <= 2e-2, b


@pytest.mark.parametrize("size,kernel", [(384, "LONG_KERNEL_LAUNCHES"),
                                         (512, "LARGE_KERNEL_LAUNCHES")])
def test_captured_bucket_through_the_long_kernels(dev, size, kernel):
    """One bucket at 384 px (577 tokens: kernel K) and 512 px (1025:
    kernel L, the graph block on its chunked path)."""
    from gavit_tpu_torch.serving import Predictor

    cfg = _serve_cfg(size)
    pred = Predictor(cfg, precision="bf16", device=dev, buckets=(2,))
    pred.warmup()
    imgs = _u8(2, size, 1)
    got, eager_counts = _replays_eager(pred, imgs)
    assert eager_counts[("attention", kernel)] == 2
    plain = Predictor(cfg, precision="bf16", device=dev, buckets=(2,),
                      impl="reference")
    assert np.abs(got - plain.predict_proba(imgs)).max() <= 2e-2


def test_two_threads_get_their_own_rows(dev):
    """Replays serialise on the predictor's lock: two threads predicting
    at once, 20 times each, get exactly their own images' rows."""
    import threading

    from gavit_tpu_torch.serving import Predictor

    pred = Predictor(_serve_cfg(), precision="bf16", device=dev,
                     buckets=(1, 8))
    pred.warmup()
    inputs = [_u8(8, 224, 11), _u8(8, 224, 12)]
    wants = [pred.predict_proba(x) for x in inputs]
    assert not np.array_equal(wants[0], wants[1])
    bad = []

    def run(i):
        for _ in range(20):
            if not np.array_equal(pred.predict_proba(inputs[i]), wants[i]):
                bad.append(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not bad


def test_calibrate_after_capture_captures_again(dev):
    """New static scales drop the graphs (they read the old state's
    tensors); the next call captures under the new scales."""
    from gavit_tpu_torch.serving import Predictor

    pred = Predictor(_serve_cfg(), precision="int8", device=dev,
                     buckets=(1, 8))
    pred.warmup()
    first = pred._graphs[8]
    imgs = _u8(8, 224, 13)
    before = pred.predict_proba(imgs)
    pred.calibrate(_u8(8, 224, 14))
    assert not pred._graphs
    after = pred.predict_proba(imgs)
    assert pred._graphs[8] is not first
    assert np.array_equal(after, pred._predict_proba_eager(imgs))
    assert not np.array_equal(after, before)


def test_exported_artifact_replays_its_eager_path(dev, tmp_path):
    """A CUDA artifact served by ``ExportedPredictor`` from one captured
    graph a bucket: the replay bit-equal to the artifact's eager path,
    running the same port kernels (the custom ops) on the device, equal to
    the Predictor it was exported from and within 2e-2 of the plain
    versions."""
    from gavit_tpu_torch.serving import (ExportedPredictor, Predictor,
                                         export_serving)

    cfg = _serve_cfg()
    export_serving(cfg, str(tmp_path / "art"), precision="bf16",
                   buckets=(2,), device=dev)
    loaded = ExportedPredictor(str(tmp_path / "art"))
    loaded.warmup()
    assert sorted(loaded._graphs) == [2]
    imgs = _u8(2, 224, 16)
    got, eager_counts = _replays_eager(loaded, imgs)
    assert eager_counts[("attention", "KERNEL_LAUNCHES")] == 2
    pred = Predictor(cfg, precision="bf16", device=dev, buckets=(2,))
    assert np.array_equal(got, pred.predict_proba(imgs))
    plain = Predictor(cfg, precision="bf16", device=dev, buckets=(2,),
                      impl="reference")
    assert np.abs(got - plain.predict_proba(imgs)).max() <= 2e-2


def _op_cases(dev):
    """Each serving op's arguments at a small launch."""
    g = torch.Generator(device=dev).manual_seed(0)

    def bf(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()

    from gavit_tpu_torch.ops import moe_fused as MF

    e, d, f, cap, tm = 4, 64, 256, 64, 8
    tiles = torch.arange(cap // tm, device=dev, dtype=torch.int32) % e
    sizes = MF.tile_group_sizes(tiles, e, tm)
    return {
        "attention_fwd": (bf(2, 17, 3 * 2 * 64), 0.125, 2),
        "attention_long_fwd": (bf(2, 300, 3 * 2 * 64), 0.125, 2),
        "attention_large_fwd": (bf(1, 800, 3 * 2 * 64), 0.125, 2),
        "mlp_infer": (bf(34, d), bf(f, d), bf(f), bf(d, f), bf(d), True),
        "graph_fwd": (bf(2, 17, d), bf(2, 17, d), "knn", 4, 0.0, 1.0, True),
        "moe_fwd": (bf(cap, d), bf(e, d, f), bf(e, f), bf(e, f, d), bf(e, d),
                    sizes, tm, 5, [1, 2], 0.0, 0.0, True),
        "gmm": (bf(cap, d), bf(e, d, f), sizes, False),
    }


@pytest.mark.parametrize("name", ["attention_fwd", "attention_long_fwd",
                                  "attention_large_fwd", "mlp_infer",
                                  "graph_fwd", "moe_fwd", "gmm"])
def test_custom_op_fakes_agree_with_the_kernels(dev, name):
    """``torch.library.opcheck``: the schema, the autograd registration
    and the fake implementation's shapes, dtypes and strides against the
    launch's (torch.compile's dispatch test is left out: nothing compiles
    these ops)."""
    import gavit_tpu_torch.ops  # noqa: F401

    op = getattr(torch.ops.gavit_tpu_torch, name).default
    cases = [_op_cases(dev)[name]]
    if name in ("attention_long_fwd", "attention_large_fwd"):
        # K's and L's fp32 rows, which the op dispatches inside the launch
        cases.append((cases[0][0].float(), *cases[0][1:]))
    for args in cases:
        torch.library.opcheck(op, args, test_utils=(
            "test_schema", "test_autograd_registration", "test_faketensor"))


def test_moe_plain_grouped_buckets_run_eagerly(dev, caplog):
    """The grouped MoE engine's plain versions read the group sizes on the
    host, so a Predictor on them (``impl='reference'``) serves those
    buckets eagerly, decided from shapes at warm-up and logged once; the
    kernels' Predictor captures every bucket."""
    import logging

    from gavit_tpu_torch.serving import Predictor

    cfg = from_dict({"model": {
        "name": "custom", "img_size": 32, "patch_size": 8, "embed_dim": 128,
        "depth": 2, "num_heads": 2, "num_classes": 14,
        "moe": {"enabled": True, "num_experts": 4, "k": 2, "every": 2,
                "impl": "grouped"}}, "data": {"image_size": 32}})
    with caplog.at_level(logging.INFO, logger="gavit_tpu_torch.serving"):
        plain = Predictor(cfg, precision="bf16", device=dev, buckets=(1, 2),
                          impl="reference")
        plain.warmup()
        plain.predict_proba(_u8(2, 32, 15))
    assert not plain._graphs
    eager = [r.getMessage() for r in caplog.records
             if "runs eagerly" in r.getMessage()]
    assert len(eager) == 2 and all("item 15" in m for m in eager)
    pred = Predictor(cfg, precision="bf16", device=dev, buckets=(1, 2))
    pred.warmup()
    assert sorted(pred._graphs) == [1, 2]
    imgs = _u8(2, 32, 15)
    assert np.abs(pred.predict_proba(imgs)
                  - plain.predict_proba(imgs)).max() <= 2e-2
