"""Kernels M, M′ and tgmm (``csrc/moe.cu``) against their plain PyTorch
versions on the card, at the edges chip_smoke.py's b128 shapes do not reach:
row tiles 8, 16 (a 128-row block spans several experts) and 256, an empty
expert, a hot expert (every pair on one), a pair count that is not a
multiple of the tile, dropout rates 0 and 0.1 with the masks (zero
patterns) identical to the plain version's; the differentiable engine
against ``impl='reference'``; and a non-bf16 CUDA input refused instead of
run through a plain version.

Marked ``cuda``: they skip without a card. JAX-free, so they run on a
machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_moe.py -q

Tolerances, as chip_smoke.py's for D and D′: outputs rounded to bf16 from
fp32 sums taken in another order, 2e-2 of the tensor's largest value; the
fp32 bias gradients 1e-3 (summation order only).
"""

import pytest
import torch

from gavit_tpu_torch.ops import moe_fused as MF
from gavit_tpu_torch.ops import philox

pytestmark = pytest.mark.cuda

E, D, F, K = 4, 128, 256, 2
REL = 2e-2
BIAS_REL = 1e-3


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


def _case(dev, tm, routing, seed=0):
    idx = _routing(dev, routing, seed=seed)
    dest, src, used, tg, gs = MF.group_by_expert_tiled(idx, E, tm)
    cap = tg.shape[0] * tm
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    bf = torch.bfloat16

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
@pytest.mark.parametrize("tm", [8, 16, 256])
def test_moe_kernels_match_plain(dev, tm, routing, rate):
    x, (w1, b1, w2, b2), dy, tg, gs, used = _case(dev, tm, routing)
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
        assert _rel(h1, h1_ref) <= REL and _rel(y, y_ref) <= REL
        assert torch.equal(y == 0, y_ref == 0)
        got = MF.moe_bwd_kernel(dy, h1_ref, w1, w2, tg, tm, seed, sites,
                                rate, rate, approx)
        want = MF.moe_bwd_reference(dy, h1_ref, w1, w2, tg, tm, seed, sites,
                                    rate, rate, approx)
        torch.cuda.synchronize()
        for name, a, b in zip(("dx", "go", "dh1", "db1", "db2", "dye"), got,
                              want):
            assert torch.isfinite(a).all(), name
            assert _rel(a, b) <= (BIAS_REL if name.startswith("db")
                                  else REL), name
        dx, go, dh1, _, _, dye = got
        assert torch.equal(go == 0, want[1] == 0)
        assert torch.equal(dye, want[5])
        # pad rows carry exactly zero gradient
        assert (dh1[~used] == 0).all() and (dx[~used] == 0).all()
    for a, b in ((x, dh1), (go, dye)):
        k = MF.tgmm_kernel(a, b, gs)
        r = MF.tgmm_reference(a, b, gs, torch.bfloat16)
        torch.cuda.synchronize()
        assert k.shape == (E, a.shape[1], b.shape[1])
        assert _rel(k, r) <= REL
    if routing == "empty":
        assert (k[0] == 0).all() and (k[3] == 0).all()


def test_grouped_engine_matches_plain_end_to_end(dev):
    """grouped_moe_mlp_fused through M, M′ and tgmm against impl='reference'
    at rate 0.1: the forward, and the gradients of x, the gates and every
    weight; one launch of M and M′ and two of tgmm."""
    g = torch.Generator(device=dev).manual_seed(3)
    idx = _routing(dev, "random", seed=3)
    gv = torch.rand(idx.shape, device=dev, generator=g)
    x = torch.randn(5, 37, D, device=dev, generator=g).to(torch.bfloat16)
    w = [(torch.randn(*s, device=dev, generator=g) * 0.05).to(torch.bfloat16)
         for s in ((E, D, F), (E, F), (E, F, D), (E, D))]
    seed = philox.step_seed(1, 2)
    outs, grads = {}, {}
    for impl in ("auto", "reference"):
        leaves = [t.detach().clone().requires_grad_(True) for t in [x, gv, *w]]
        before = (MF.KERNEL_LAUNCHES, MF.BWD_KERNEL_LAUNCHES,
                  MF.TGMM_LAUNCHES)
        out = MF.grouped_moe_mlp_fused(leaves[0], leaves[1], idx, *leaves[2:],
                                       seed, (2, 3), drop=0.1, impl=impl)
        out.float().square().sum().backward()
        after = (MF.KERNEL_LAUNCHES, MF.BWD_KERNEL_LAUNCHES,
                 MF.TGMM_LAUNCHES)
        assert [b - a for a, b in zip(before, after)] == (
            [1, 1, 2] if impl == "auto" else [0, 0, 0])
        outs[impl], grads[impl] = out, [t.grad for t in leaves]
    torch.cuda.synchronize()
    assert _rel(outs["auto"], outs["reference"]) <= REL
    for name, a, b in zip(("x", "gates", "w1", "b1", "w2", "b2"),
                          grads["auto"], grads["reference"]):
        assert _rel(a, b) <= REL, name


def test_moe_kernels_refuse_what_they_do_not_take(dev):
    x, (w1, b1, w2, b2), dy, tg, gs, _ = _case(dev, 16, "random")
    f32 = [t.float() for t in (x, w1, b1, w2, b2)]
    with pytest.raises(TypeError, match="bfloat16"):
        MF.moe_fwd_kernel(*f32, tg, 16, 0, (2, 3), 0.0, 0.0, False)
    with pytest.raises(TypeError, match="bfloat16"):
        MF.moe_bwd_kernel(dy.float(), x.new_zeros(x.shape[0], F).float(),
                          w1.float(), w2.float(), tg, 16, 0, (2, 3), 0.0,
                          0.0, False)
    with pytest.raises(TypeError, match="bfloat16"):
        MF.tgmm_kernel(x.float(), dy.float(), gs)
    with pytest.raises(ValueError, match="tile_group"):
        MF.moe_fwd_kernel(x, w1, b1, w2, b2, tg.long(), 16, 0, (2, 3), 0.0,
                          0.0, False)
    # the engine on fp32 CUDA tensors raises in the kernel: no plain fallback
    gv = torch.ones(5, 37, K, device=dev) / K
    with pytest.raises(TypeError, match="bfloat16"):
        MF.grouped_moe_mlp_fused(x[:185].float().reshape(5, 37, D), gv,
                                 _routing(dev, "random"), *f32[1:], None,
                                 (2, 3))
