"""Kernels M, M′, tgmm and N-gmm (``csrc/moe.cu``) against their plain
PyTorch versions on the card, at the edges chip_smoke.py's b128 shapes do
not reach: row tiles 8, 16, 32 (a 128-row block spans several experts)
and 256, an empty expert, a hot expert (every pair on one), a pair count
that is not a multiple of the tile, dropout rates 0 and 0.1 with the masks
(zero patterns) identical to the plain version's; M with biases far apart
per expert (a segment given another expert's bias shows), its hidden
mask seen bit for bit through an identity W2, and with NaN planted next
to the pad rows that a straddling tile reads; N-gmm in both forms on ragged
groups (boundaries inside a row tile and at its rows 127, 128 and 129,
groups of one row, an empty and a hot expert, an empty first and last
group, rows past the groups, T not a multiple of the tile, T = 50038), the
same bits on a rerun, and its wide MN-major operand exactly against
torch.matmul; tgmm at the same groupings in both dW forms (an empty
expert's dW zero, the same bits on a rerun, NaN in the rows past a group
leaving its dW unchanged); M′ run twice for the same bits, zero bias
gradients for an expert of pad rows only, and NaN planted in one expert's
pad rows of h1 kept to those rows and that expert's db1 where a 128-row
tile straddles the next expert; both differentiable engines against
``impl='reference'``, with their launches;
a zero router's tie picking experts 0 and 1; and an fp16 or mixed-dtype
CUDA input refused instead of run through a plain version. The checks
against the plain versions, the NaN and mask checks and both engines run
in bf16 (``csrc/moe.cu``) and in fp32 (``csrc/moe_f32.cu``, the CUDA
cores), each counted on its own launch counter; a captured CUDA graph of
M in fp32 replays bit-equal to its eager launch.

Marked ``cuda``: they skip without a card. JAX-free, so they run on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_moe.py -q

Tolerances, as chip_smoke.py's: in bf16 (D's and D′'s) outputs rounded to
bf16 from fp32 sums taken in another order, 2e-2 of the tensor's largest
value, the fp32 bias gradients 1e-3 (summation order only); in fp32 every
output 2e-5 of the tensor's largest value (summation order only).
"""

import pytest
import torch

from gavit_tpu_torch.models.moe import router_topk
from gavit_tpu_torch.ops import gmm as GM
from gavit_tpu_torch.ops import moe_fused as MF
from gavit_tpu_torch.ops import moe_grouped as MG
from gavit_tpu_torch.ops import philox

pytestmark = pytest.mark.cuda

E, D, F, K = 4, 128, 256, 2
BF16, F32 = torch.bfloat16, torch.float32
DTYPES = {"bf16": BF16, "fp32": F32}
REL = {BF16: 2e-2, F32: 2e-5}
BIAS_REL = {BF16: 1e-3, F32: 2e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1e-30)).item()


def _routing(dev, routing, g=5, s=37, seed=0):
    """gate_idx [g, s, K] (T = 370 pairs: no tile divides it)."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.stack([torch.randperm(E, generator=gen)[:K]
                       for _ in range(g * s)]).reshape(g, s, K)
    if routing == "hot":  # every first choice on expert 2
        idx[..., 0] = 2
        idx[..., 1] = torch.where(idx[..., 1] == 2, 1, idx[..., 1])
    elif routing == "empty":  # experts 0 and 3 get nothing
        idx[..., 0], idx[..., 1] = 1, 2
    return idx.to(dev)


def _launches(dtype):
    """The names of the launch counters of M, M′, N-gmm and tgmm in
    ``dtype``."""
    f = "F32_" if dtype == F32 else ""
    return (f"{f}KERNEL_LAUNCHES", f"BWD_{f}KERNEL_LAUNCHES",
            f"{f}KERNEL_LAUNCHES", f"{f}TGMM_LAUNCHES")


def _h1_close(got, want, dtype):
    """h1 within 1 bf16 ulp, or within the fp32 tolerance."""
    if dtype == BF16:
        return _ulps(got, want) <= 1
    return _rel(got, want) <= REL[F32]


def _case(dev, tm, routing, seed=0, dtype=BF16):
    idx = _routing(dev, routing, seed=seed)
    dest, src, used, tg, gs = MF.group_by_expert_tiled(idx, E, tm)
    cap = tg.shape[0] * tm
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    bf = dtype

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(bf)

    x = rnd(cap, D)
    w = (rnd(E, D, F, scale=0.05), rnd(E, F, scale=0.05),
         rnd(E, F, D, scale=0.05), rnd(E, D, scale=0.05))
    # the combine's backward: zero upstream gradient on pad rows
    dy = rnd(cap, D) * used[:, None]
    return x, w, dy, tg, gs, used


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("routing", ["random", "hot", "empty"])
@pytest.mark.parametrize("tm", [8, 16, 32, 256])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_kernels_match_plain(dev, dtype, tm, routing, rate):
    dtype = DTYPES[dtype]
    x, (w1, b1, w2, b2), dy, tg, gs, used = _case(dev, tm, routing,
                                                  dtype=dtype)
    seed, sites = philox.step_seed(0, 7), (5, 6)
    # tanh (the bf16 serving form) at rate 0, then erf, whose h1 and
    # gradients the tgmm checks below take
    for approx in ((True, False) if rate == 0.0 else (False,)):
        y, h1 = MF.moe_fwd_kernel(x, w1, b1, w2, b2, tg, tm, seed, sites,
                                  rate, rate, approx)
        y_ref, h1_ref = MF.moe_fwd_reference(x, w1, b1, w2, b2, tg, tm, seed,
                                             sites, rate, rate, approx)
        torch.cuda.synchronize()
        assert torch.isfinite(y).all() and torch.isfinite(h1).all()
        assert y.dtype == h1.dtype == dtype
        assert _rel(h1, h1_ref) <= REL[dtype]
        assert _rel(y, y_ref) <= REL[dtype]
        assert torch.equal(y == 0, y_ref == 0)
        got, again = (MF.moe_bwd_kernel(dy, h1_ref, w1, w2, tg, tm, seed,
                                        sites, rate, rate, approx, gs)
                      for _ in range(2))
        want = MF.moe_bwd_reference(dy, h1_ref, w1, w2, tg, tm, seed, sites,
                                    rate, rate, approx)
        torch.cuda.synchronize()
        assert all(torch.equal(a, a2) for a, a2 in zip(got, again))
        for name, a, b in zip(("dx", "go", "dh1", "db1", "db2", "dye"), got,
                              want):
            assert torch.isfinite(a).all(), name
            assert _rel(a, b) <= (BIAS_REL if name.startswith("db")
                                  else REL)[dtype], name
        dx, go, dh1, _, _, dye = got
        assert torch.equal(go == 0, want[1] == 0)
        assert torch.equal(dye, want[5])
        # pad rows carry exactly zero gradient, and an expert of pad rows
        # only has exactly zero bias gradients (its partials are zero)
        assert (dh1[~used] == 0).all() and (dx[~used] == 0).all()
        if routing == "empty":
            for db in got[3:5]:
                assert (db[0] == 0).all() and (db[3] == 0).all()
    for a, b in ((x, dh1), (go, dye)):
        k = GM.tgmm_kernel(a, b, gs)
        r = GM.tgmm_reference(a, b, gs, dtype)
        torch.cuda.synchronize()
        assert k.shape == (E, a.shape[1], b.shape[1]) and k.dtype == dtype
        assert _rel(k, r) <= REL[dtype]
    if routing == "empty":
        assert (k[0] == 0).all() and (k[3] == 0).all()


def _ulps(got, want):
    """The largest distance of two bf16 tensors in units of the larger's
    last place (values under 2^-10 compared on that floor's ulp)."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp(min=2.0 ** -10)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((g - w).abs() / ulp).max().item()


@pytest.mark.parametrize("tm", [8, 32, 256])
def test_moe_fwd_adds_each_segments_expert_bias(dev, tm):
    """Biases far apart per expert (b1[e] = e + 1, b2[e] = 4 (e + 1)), so
    that a row given another expert's bias is off by a whole unit: h1
    within 1 ulp and y within REL of the plain version, at row tiles that
    straddle experts (8, 32) and at one that never does (256); the same
    bits on a rerun."""
    x, (w1, _, w2, _), _, tg, gs, _ = _case(dev, tm, "random", seed=3)
    steps = torch.arange(1, E + 1, device=dev, dtype=torch.float32)
    b1 = (steps[:, None] * torch.ones(E, F, device=dev)).to(torch.bfloat16)
    b2 = (4 * steps[:, None] * torch.ones(E, D, device=dev)).to(
        torch.bfloat16)
    seed, sites = philox.step_seed(0, 9), (5, 6)
    for rate, approx in ((0.1, False), (0.0, True)):
        args = (x, w1, b1, w2, b2, tg, tm, seed, sites, rate, rate, approx)
        y, h1 = MF.moe_fwd_kernel(*args)
        y2, h12 = MF.moe_fwd_kernel(*args, group_sizes=gs)
        y_ref, h1_ref = MF.moe_fwd_reference(*args)
        torch.cuda.synchronize()
        assert _ulps(h1, h1_ref) <= 1
        assert _rel(y, y_ref) <= REL[BF16]
        assert torch.equal(y, y2) and torch.equal(h1, h12)


@pytest.mark.parametrize("tm", [8, 256])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_fwd_hidden_mask_is_exact(dev, dtype, tm):
    """Kernel M's hidden mask seen through y: with each W2[e] the identity
    on its first D hidden units, b2 zero and the output site off, y =
    g[:, :D] exactly (one nonzero product a sum), so y holds
    GELU(h1)·keep·scale rounded, bit for bit the plain version's from the
    kernel's h1, and zero at every dropped element of the hidden site."""
    bf = DTYPES[dtype]
    x, (w1, b1, _, _), _, tg, _, _ = _case(dev, tm, "random", seed=5,
                                           dtype=bf)
    w2 = torch.zeros(E, F, D, device=dev, dtype=bf)
    w2[:, :D] = torch.eye(D, device=dev, dtype=bf)
    b2 = torch.zeros(E, D, device=dev, dtype=bf)
    seed, sites = philox.step_seed(0, 13), (5, 6)
    y, h1 = MF.moe_fwd_kernel(x, w1, b1, w2, b2, tg, tm, seed, sites, 0.1,
                              0.0, False)
    g = MF._masked(MF._act_and_grad(h1.float(), False)[0], seed, sites[0],
                   0.1).to(bf)
    keep = philox.keep_mask(h1.shape, seed, sites[0], 0.1, device=dev)[:, :D]
    torch.cuda.synchronize()
    assert torch.equal(y, g[:, :D])
    assert bool((y[~keep] == 0).all()) and bool((y[keep] != 0).any())


@pytest.mark.parametrize("tm", [8, 32])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_fwd_keeps_nan_rows_to_themselves(dev, dtype, tm):
    """NaN planted in the first row of every expert's region after the
    first (the neighbour of the previous expert's pad rows) and in its last
    pad row: a 128-row tile that straddles experts multiplies those rows
    by the other experts' weights and must keep none of it. The planted
    rows' outputs are NaN where the plain version's are (dropped elements
    zero in both), every other row finite and within REL."""
    dtype = DTYPES[dtype]
    x, (w1, b1, w2, b2), _, tg, gs, _ = _case(dev, tm, "random", seed=4,
                                              dtype=dtype)
    bounds = torch.cumsum(gs.long(), 0)
    planted = torch.cat([bounds[:-1], bounds[1:] - 1])
    planted = planted[planted < x.shape[0]]
    x = x.clone()
    x[planted] = float("nan")
    seed, sites = philox.step_seed(0, 11), (5, 6)
    args = (x, w1, b1, w2, b2, tg, tm, seed, sites, 0.1, 0.1, False)
    y, h1 = MF.moe_fwd_kernel(*args)
    y_ref, h1_ref = MF.moe_fwd_reference(*args)
    torch.cuda.synchronize()
    rows = torch.zeros(x.shape[0], dtype=torch.bool, device=dev)
    rows[planted] = True
    assert torch.equal(torch.isnan(y), torch.isnan(y_ref))
    assert torch.equal(torch.isnan(h1), torch.isnan(h1_ref))
    assert torch.isnan(h1[rows]).all()
    assert torch.isfinite(y[~rows]).all() and torch.isfinite(h1[~rows]).all()
    assert _rel(y[~rows], y_ref[~rows]) <= REL[dtype]
    assert _h1_close(h1[~rows], h1_ref[~rows], dtype)


@pytest.mark.parametrize("tm", [8, 32])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moe_bwd_keeps_nan_rows_to_themselves(dev, dtype, tm):
    """NaN planted in h1 at the pad rows of the first expert that has some
    (dy is zero there): kernel M′ gives them NaN exactly where the plain
    version does (0·GELU′(NaN), dropped elements zero in both), in dh1, go
    and dx, and in db1 only for that expert. The 128-row tile those rows
    share with the next expert's rows keeps the NaN out of the next
    expert's rows and bias partials; every other value is finite and
    within REL (BIAS_REL for db1), and the pad rows left finite are
    exactly zero in dh1 and dx."""
    dtype = DTYPES[dtype]
    x, w, dy, tg, gs, used = _case(dev, tm, "random", seed=6, dtype=dtype)
    w1, _, w2, _ = w
    h1 = MF.moe_fwd_reference(x, *w, tg, tm, 0, (5, 6), 0.0, 0.0, False)[1]
    bounds = torch.cumsum(gs.long(), 0).tolist()
    starts = [0] + bounds[:-1]
    planted = next(e for e in range(E - 1)
                   if not used[starts[e]:bounds[e]].all())
    rows = torch.zeros_like(used)
    rows[starts[planted]:bounds[planted]] = ~used[starts[planted]:
                                                  bounds[planted]]
    h1 = h1.clone()
    h1[rows] = float("nan")
    seed, sites = philox.step_seed(0, 17), (5, 6)
    args = (dy, h1, w1, w2, tg, tm, seed, sites, 0.1, 0.1, False)
    got = MF.moe_bwd_kernel(*args, gs)
    want = MF.moe_bwd_reference(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "go", "dh1", "db1"), got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
    db1, db1_ref = got[3], want[3]
    assert torch.isnan(db1[planted]).any()
    others = [e for e in range(E) if e != planted]
    assert torch.isfinite(db1[others]).all()
    assert _rel(db1[others], db1_ref[others]) <= BIAS_REL[dtype]
    for a, b in zip(got[:3], want[:3]):
        assert torch.isfinite(a[~rows]).all()
        assert _rel(a[~rows], b[~rows]) <= REL[dtype]
    pads = ~used & ~rows
    assert (got[2][pads] == 0).all() and (got[0][pads] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_grouped_engine_matches_plain_end_to_end(dev, dtype):
    """grouped_moe_mlp_fused through M, M′ and tgmm against impl='reference'
    at rate 0.1: the forward, and the gradients of x, the gates and every
    weight; one launch of M and M′ and two of tgmm, on the dtype's
    counters (the other dtype's stay)."""
    dtype = DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(3)
    idx = _routing(dev, "random", seed=3)
    gv = torch.rand(idx.shape, device=dev, generator=g)
    x = torch.randn(5, 37, D, device=dev, generator=g).to(dtype)
    w = [(torch.randn(*s, device=dev, generator=g) * 0.05).to(dtype)
         for s in ((E, D, F), (E, F), (E, F, D), (E, D))]
    seed = philox.step_seed(1, 2)
    fwd, bwd, _, tgmm = _launches(dtype)
    counters = [(m, n) for m in (MF, GM) for n in (
        "KERNEL_LAUNCHES", "BWD_KERNEL_LAUNCHES", "F32_KERNEL_LAUNCHES",
        "BWD_F32_KERNEL_LAUNCHES", "TGMM_LAUNCHES", "F32_TGMM_LAUNCHES")
        if hasattr(m, n)]
    outs, grads = {}, {}
    for impl in ("auto", "reference"):
        leaves = [t.detach().clone().requires_grad_(True) for t in [x, gv, *w]]
        before = {c: getattr(*c) for c in counters}
        out = MF.grouped_moe_mlp_fused(leaves[0], leaves[1], idx, *leaves[2:],
                                       seed, (2, 3), drop=0.1, impl=impl)
        out.float().square().sum().backward()
        moved = {c: getattr(*c) - v for c, v in before.items()}
        want = {c: 0 for c in counters}
        if impl == "auto":
            want.update({(MF, fwd): 1, (MF, bwd): 1, (GM, tgmm): 2})
        assert moved == want
        outs[impl], grads[impl] = out, [t.grad for t in leaves]
    torch.cuda.synchronize()
    assert _rel(outs["auto"], outs["reference"]) <= REL[dtype]
    for name, a, b in zip(("x", "gates", "w1", "b1", "w2", "b2"),
                          grads["auto"], grads["reference"]):
        assert _rel(a, b) <= REL[dtype], name


def test_moe_fwd_f32_captured_graph_replays_its_launch(dev):
    """Kernel M in fp32 captured in a CUDA graph (the group sizes stay on
    the device: nothing is read on the host) replays bit-equal to its eager
    launch on the same inputs, and the replay moves no counter."""
    x, (w1, b1, w2, b2), _, tg, gs, _ = _case(dev, 32, "random", seed=8,
                                              dtype=F32)
    seed, sites = philox.step_seed(0, 21), (5, 6)
    args = (x, w1, b1, w2, b2, tg, 32, seed, sites, 0.1, 0.1, False, gs)
    y, h1 = MF.moe_fwd_kernel(*args)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        MF.moe_fwd_kernel(*args)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yg, h1g = MF.moe_fwd_kernel(*args)
    before = MF.F32_KERNEL_LAUNCHES
    yg.zero_(), h1g.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert MF.F32_KERNEL_LAUNCHES == before
    assert torch.equal(yg, y) and torch.equal(h1g, h1)


def test_moe_kernels_refuse_what_they_do_not_take(dev):
    """fp32 launches the fp32 bodies (one count each); fp16, and bf16
    beside fp32, raise TypeError, on the engine too: no plain fallback."""
    x, (w1, b1, w2, b2), dy, tg, gs, _ = _case(dev, 16, "random")
    f32 = [t.float() for t in (x, w1, b1, w2, b2)]
    f16 = [t.half() for t in (x, w1, b1, w2, b2)]
    h1 = x.new_zeros(x.shape[0], F)
    before = (MF.F32_KERNEL_LAUNCHES, MF.BWD_F32_KERNEL_LAUNCHES,
              GM.F32_TGMM_LAUNCHES)
    y, _ = MF.moe_fwd_kernel(*f32, tg, 16, 0, (2, 3), 0.0, 0.0, False)
    MF.moe_bwd_kernel(dy.float(), h1.float(), w1.float(), w2.float(), tg,
                      16, 0, (2, 3), 0.0, 0.0, False)
    GM.tgmm_kernel(x.float(), dy.float(), gs)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    assert (MF.F32_KERNEL_LAUNCHES, MF.BWD_F32_KERNEL_LAUNCHES,
            GM.F32_TGMM_LAUNCHES) == tuple(n + 1 for n in before)
    for ws in (f16, [f32[0], *(t for t in (w1, b1, w2, b2))]):
        with pytest.raises(TypeError, match="float32 tensors of one"):
            MF.moe_fwd_kernel(*ws, tg, 16, 0, (2, 3), 0.0, 0.0, False)
    with pytest.raises(TypeError, match="float32 tensors of one"):
        MF.moe_bwd_kernel(dy.half(), h1.half(), w1.half(), w2.half(), tg, 16,
                          0, (2, 3), 0.0, 0.0, False)
    with pytest.raises(TypeError, match="float32 tensors of one"):
        GM.tgmm_kernel(x.float(), dy, gs)
    with pytest.raises(TypeError, match="writes its operands'"):
        GM.tgmm_kernel(x.float(), dy.float(), gs, torch.bfloat16)
    with pytest.raises(ValueError, match="tile_group"):
        MF.moe_fwd_kernel(x, w1, b1, w2, b2, tg.long(), 16, 0, (2, 3), 0.0,
                          0.0, False)
    # the engine on fp16 CUDA tensors raises in the kernel: no plain fallback
    gv = torch.ones(5, 37, K, device=dev) / K
    with pytest.raises(TypeError, match="float32 tensors of one"):
        MF.grouped_moe_mlp_fused(x[:185].half().reshape(5, 37, D), gv,
                                 _routing(dev, "random"), *f16[1:], None,
                                 (2, 3))


# N-gmm: (rows, group sizes) — boundaries inside 128-row tiles with an
# empty expert, one hot expert, rows past the groups (the zero tail), and a
# row count no tile divides; boundaries at rows 127, 128 and 129 (the last
# row of a tile, the edge, the first past it) with groups of one row; an
# empty first and last group; T = 50038 (the b127 routing's pair count)
GMM_CASES = {"ragged": (370, [37, 0, 190, 143]),
             "hot": (512, [0, 512, 0, 0]),
             "tail": (300, [5, 41, 17, 33]),
             "one_row_groups": (131, [1, 1, 128, 1]),
             "tile_edges": (300, [127, 1, 1, 171]),
             "empty_ends": (300, [0, 150, 150, 0]),
             "b127": (50038, [12001, 0, 25000, 13037])}


@pytest.mark.parametrize("transpose_rhs", [False, True], ids=["fwd", "t"])
@pytest.mark.parametrize("case", sorted(GMM_CASES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gmm_kernel_matches_plain(dev, dtype, case, transpose_rhs):
    t, sizes = GMM_CASES[case]
    g = torch.Generator(device=dev).manual_seed(7)
    bf = DTYPES[dtype]
    x = torch.randn(t, D, device=dev, generator=g).to(bf)
    shape = (E, F, D) if transpose_rhs else (E, D, F)
    w = (torch.randn(*shape, device=dev, generator=g) * 0.05).to(bf)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    counter = _launches(bf)[2]
    before = getattr(GM, counter)
    got = GM.gmm_kernel(x, w, gs, transpose_rhs)
    again = GM.gmm_kernel(x, w, gs, transpose_rhs)
    want = GM.gmm_reference(x, w, gs, transpose_rhs)
    torch.cuda.synchronize()
    assert getattr(GM, counter) - before == 2
    assert got.shape == (t, F) and got.dtype == bf
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _rel(got, want) <= REL[bf]
    end = sum(sizes)
    if end < t:
        assert not got[end:].any()


# tgmm's two dW forms at ViT-B's widths: dW1 = x [T, 768]ᵀ · dh1 [T, 3072]
# and dW2 = go [T, 3072]ᵀ · dye [T, 768]; past 4096 rows (b127) at narrow
# widths, 136 and 200, that leave partial 128-row and 192-column tiles and
# atoms wholly past the output
TGMM_FORMS = {"dW1": (768, 3072), "dW2": (3072, 768)}


def _tgmm_inputs(dev, t, kd, n, seed=9, dtype=BF16):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(t, kd, device=dev, generator=g).to(dtype)
    b = (torch.randn(t, n, device=dev, generator=g) * 0.1).to(dtype)
    return a, b


@pytest.mark.parametrize("form", sorted(TGMM_FORMS))
@pytest.mark.parametrize("case", sorted(GMM_CASES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tgmm_kernel_matches_plain(dev, dtype, case, form):
    """Kernel tgmm at every N-gmm grouping in both dW forms against
    tgmm_reference: an empty expert's dW exactly zero, rows past the groups
    read by none, the same bits on a rerun."""
    t, sizes = GMM_CASES[case]
    kd, n = TGMM_FORMS[form] if t <= 4096 else \
        (136, 200) if form == "dW1" else (200, 136)
    dtype = DTYPES[dtype]
    a, b = _tgmm_inputs(dev, t, kd, n, dtype=dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    counter = _launches(dtype)[3]
    before = getattr(GM, counter)
    got = GM.tgmm_kernel(a, b, gs)
    again = GM.tgmm_kernel(a, b, gs)
    want = GM.tgmm_reference(a, b, gs, dtype)
    torch.cuda.synchronize()
    assert getattr(GM, counter) - before == 2
    assert got.shape == (E, kd, n) and got.dtype == dtype
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert _rel(got, want) <= REL[dtype]
    for e, size in enumerate(sizes):
        if not size:
            assert not got[e].any(), f"expert {e} is empty"


@pytest.mark.parametrize("planted", [(1, 3), (2, 4)], ids=["e1e3", "e2tail"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tgmm_ignores_the_rows_past_a_group(dev, dtype, planted):
    """NaN in the first rows after a group's end (the next expert's, or
    rows past every group) leaves that group's dW finite and bit-equal to
    the clean run's: the last row step of a group reads them, and they add
    exactly nothing. ``planted`` names the groups whose first rows (4: the
    rows past the last group) get the NaN; the group before each is
    checked."""
    t, sizes = GMM_CASES["tail"]  # groups end at rows 5, 46, 63 and 96
    a, b = _tgmm_inputs(dev, t, *TGMM_FORMS["dW1"], dtype=DTYPES[dtype])
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    clean = GM.tgmm_kernel(a, b, gs)
    starts = [0, 5, 46, 63, 96]
    an, bn = a.clone(), b.clone()
    for e in planted:
        an[starts[e]:starts[e] + 3] = float("nan")
        bn[starts[e]:starts[e] + 3] = float("nan")
    got = GM.tgmm_kernel(an, bn, gs)
    torch.cuda.synchronize()
    for e in planted:
        assert torch.isfinite(got[e - 1]).all(), f"expert {e - 1}"
        assert torch.equal(got[e - 1], clean[e - 1]), f"expert {e - 1}"
        if e < E:  # the planted group itself takes its NaN rows
            assert torch.isnan(got[e]).any()


@pytest.mark.parametrize("transpose_rhs", [False, True], ids=["fwd", "t"])
def test_gmm_wide_operand_descriptor_is_exact(dev, transpose_rhs):
    """One group at n = 256 (a B tile of several 64-column swizzle atoms:
    the forward's MN-major descriptor steps between them by its LBO)
    against torch.matmul. Entries in {-1, 0, 1} over K = 128 give integer
    sums of at most 128, exact in fp32 and in bf16, so any element read
    from the wrong place shows as a mismatch."""
    g = torch.Generator(device=dev).manual_seed(11)
    t, kd, n = 200, 128, 256
    x = torch.randint(-1, 2, (t, kd), device=dev, generator=g).to(torch.bfloat16)
    w = torch.randint(-1, 2, (1, kd, n), device=dev, generator=g).to(torch.bfloat16)
    gs = torch.tensor([t], dtype=torch.int32, device=dev)
    wk = w.transpose(1, 2).contiguous() if transpose_rhs else w
    got = GM.gmm_kernel(x, wk, gs, transpose_rhs)
    want = torch.matmul(x.float(), w[0].float()).to(torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("s", [37, 64], ids=["T370", "T640"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_unfused_engine_matches_plain_end_to_end(dev, dtype, s):
    """grouped_moe_mlp through N-gmm and tgmm against impl='reference' at
    rate 0.1: the forward, and the gradients of x, the gates and every
    weight; two N-gmm launches in the forward, two (transposed) and two of
    tgmm in the backward, kernel F at both sites. T = 370 pairs is no
    multiple of the 128-row tile, T = 640 is (the group sizes go to the
    kernels as the grouping made them). The launches are the dtype's
    counters."""
    dtype = DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(4)
    idx = _routing(dev, "hot", s=s, seed=4)
    gv = torch.rand(idx.shape, device=dev, generator=g)
    x = torch.randn(5, s, D, device=dev, generator=g).to(dtype)
    w = [(torch.randn(*shape, device=dev, generator=g) * 0.05).to(
        dtype) for shape in ((E, D, F), (E, F), (E, F, D), (E, D))]
    seed = philox.step_seed(1, 3)
    fwd, _, ngmm, tgmm = _launches(dtype)
    other = _launches(F32 if dtype == BF16 else BF16)[2]
    counters = ((GM, ngmm), (GM, tgmm), (MF, fwd), (GM, other))
    outs, grads = {}, {}
    for impl in ("auto", "reference"):
        leaves = [t.detach().clone().requires_grad_(True) for t in [x, gv, *w]]
        before = [getattr(*c) for c in counters]
        out = MG.grouped_moe_mlp(leaves[0], leaves[1], idx, *leaves[2:],
                                 seed, (2, 3), drop=0.1, impl=impl)
        out.float().square().sum().backward()
        launched = [getattr(*c) - b for c, b in zip(counters, before)]
        assert launched == ([4, 2, 0, 0] if impl == "auto"
                            else [0, 0, 0, 0])
        outs[impl], grads[impl] = out, [t.grad for t in leaves]
    torch.cuda.synchronize()
    assert _rel(outs["auto"], outs["reference"]) <= REL[dtype]
    for name, a, b in zip(("x", "gates", "w1", "b1", "w2", "b2"),
                          grads["auto"], grads["reference"]):
        assert _rel(a, b) <= REL[dtype], name


def test_zero_router_ties_pick_experts_0_and_1(dev):
    _, idx, _ = router_topk(torch.zeros(4, 197, E, device=dev), K)
    assert (idx[..., 0] == 0).all() and (idx[..., 1] == 1).all()


def test_gmm_refuses_what_it_does_not_take(dev):
    """fp32 launches N-gmm's fp32 body (through the op as well); fp16, and
    fp32 beside bf16, raise TypeError: no plain fallback."""
    x = torch.randn(64, D, device=dev)
    w = torch.randn(E, D, F, device=dev)
    gs = torch.tensor([16, 16, 16, 16], dtype=torch.int32, device=dev)
    before = GM.F32_KERNEL_LAUNCHES
    got = GM.gmm_kernel(x, w, gs)
    op = GM.ragged_matmul(x, w, gs)
    torch.cuda.synchronize()
    assert GM.F32_KERNEL_LAUNCHES - before == 2
    assert got.dtype == torch.float32 and torch.equal(got, op)
    assert _rel(got, GM.gmm_reference(x, w, gs)) <= REL[F32]
    for xs, ws in ((x.half(), w.half()), (x, w.bfloat16())):
        with pytest.raises(TypeError, match="float32 tensors of one"):
            GM.gmm_kernel(xs, ws, gs)
    with pytest.raises(ValueError, match="int32"):
        GM.gmm_kernel(x.bfloat16(), w.bfloat16(), gs.long())
    with pytest.raises(ValueError, match="inner dims"):
        GM.gmm_kernel(x.bfloat16(), w.bfloat16(), gs, transpose_rhs=True)
    # the op on fp16 CUDA tensors raises in the kernel: no plain fallback
    with pytest.raises(TypeError, match="float32 tensors of one"):
        GM.ragged_matmul(x.half(), w.half(), gs)
